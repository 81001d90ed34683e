"""The port's discovery engine against the JAX engine on analytic worlds.

The worlds of ``tests/test_reasoning_engine.py`` paint exact objectness
fields into the image (ch0 object mask, ch1/ch2 the (dy, dx) center field
encoded into [0, 1]); a fake objectness net decodes them from each crop.
Both fakes blur the SDF with the same shifted-slice box sums of integers,
divided once at the end, so both engines see bit-identical fields. Stats
must be equal; boxes agree to 1e-3 (sums in the boundary stats run in
another order in the two frameworks).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unmore_tpu.reasoning.engine import ObjectDiscoveryEngine as JaxEngine
from unmore_tpu.reasoning.engine import ReasoningConfig as JaxConfig
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from tests.test_reasoning_engine import make_world

BLUR_K, BLUR_ROUNDS = 9, 2


def _box_sums(y, axis, pad):
    """Sum of BLUR_K zero-padded shifts along ``axis`` (-1 or -2), in order."""
    h = BLUR_K // 2
    n = y.shape[axis]
    p = pad(y, axis, h)
    acc = None
    for d in range(BLUR_K):
        s = p[..., d : d + n] if axis == -1 else p[..., d : d + n, :]
        acc = s if acc is None else acc + s
    return acc


def _blur(x, pad):
    y = x
    for _ in range(BLUR_ROUNDS):
        y = _box_sums(_box_sums(y, -1, pad), -2, pad)
    return y / float(BLUR_K ** (2 * BLUR_ROUNDS))


def _jpad(y, axis, h):
    widths = [(0, 0)] * y.ndim
    widths[axis] = (h, h)
    return jnp.pad(y, widths)


def _tpad(y, axis, h):
    return torch.nn.functional.pad(y, (h, h) if axis == -1 else (0, 0, h, h))


def jax_objectness(variables, crops, compute_center=True):
    m = crops[..., 0]
    a = m > 0.8
    b = (m > 0.3) & ~a
    mask = jnp.where(jnp.sum(a, (1, 2), keepdims=True) >= jnp.sum(b, (1, 2), keepdims=True), a, b)
    out = {"sdf_maps": _blur(mask.astype(jnp.float32) * 2.0 - 1.0, _jpad)}
    if compute_center:
        out["center_fields"] = crops[..., 1:3] * 2.0 - 1.0
    return out


def jax_classifier(variables, crops):
    return jnp.max(crops[..., 0], axis=(1, 2))


def torch_objectness(crops, compute_center=True):
    m = crops[..., 0]
    a = m > 0.8
    b = (m > 0.3) & ~a
    mask = torch.where(a.sum((1, 2), keepdim=True) >= b.sum((1, 2), keepdim=True), a, b)
    out = {"sdf_maps": _blur(mask.float() * 2.0 - 1.0, _tpad)}
    if compute_center:
        out["center_fields"] = crops[..., 1:3] * 2.0 - 1.0
    return out


def torch_classifier(crops):
    return crops[..., 0].amax(dim=(1, 2))


BASE = dict(canvas_size=200, max_proposals=256, max_splits=256, max_active=256,
            crop_chunk=16, n_round=30, analyze_cc=False)


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["stats"] == w["stats"]
        for key in ("boxes", "converged_boxes"):
            assert g[key].shape == np.asarray(w[key]).shape, (key, g[key].shape, np.asarray(w[key]).shape)
            np.testing.assert_allclose(g[key], np.asarray(w[key]), atol=1e-3)


@functools.lru_cache(maxsize=None)
def jax_engine(**kwargs):
    """One JAX engine a config: cases with equal configs share its compiled programs."""
    return JaxEngine(jax_objectness, jax_classifier, JaxConfig(**kwargs))


def run_both(worlds, **overrides):
    kwargs = dict(BASE, **overrides)
    port = ObjectDiscoveryEngine(torch_objectness, torch_classifier, ReasoningConfig(**kwargs), device="cpu")
    return port.discover_batch(worlds), jax_engine(**kwargs).discover_batch(worlds)


A, B = (30, 60, 100, 140), (100, 60, 170, 140)
CASES = {
    "single": ([[(60, 70, 140, 150)]], {}),
    "adjacent_split": ([[A, B]], {}),
    "empty": ([[]], {}),
    "cc_analysis": ([[(20, 20, 80, 80), (120, 120, 180, 180)]], dict(analyze_cc=True, cc_max_components=4)),
    "reference_rounds": ([[(60, 70, 140, 150), (20, 30, 50, 110)]], dict(sticky_convergence=False)),
    "image_batch_2": ([[(60, 70, 140, 150)], [(20, 30, 90, 110), A]], dict(image_batch=2)),
    # demand for splits beyond max_splits: _rank_keep sheds by parent score
    "split_overflow": ([[(10, 10, 60, 60), (10, 110, 60, 160), (60, 10, 110, 60), (60, 110, 110, 160)]],
                       dict(max_splits=16, analyze_cc=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(case):
    objects, overrides = CASES[case]
    worlds = [make_world(200, objs) for objs in objects]
    got, want = run_both(worlds, **overrides)
    assert_same_results(got, want)
    if case == "split_overflow":
        assert got[0]["stats"]["split_overflow"] > 0
    if case == "adjacent_split":
        assert got[0]["stats"]["n_split"] > 0


def test_engine_uint8_wire_matches_jax():
    world = make_world(200, [(60, 70, 140, 150)])
    world_q = np.clip(world * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got, want = run_both([world_q])
    assert_same_results(got, want)
