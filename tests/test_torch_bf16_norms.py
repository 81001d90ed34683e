"""The port's norms in bf16 models against flax's, on the CPU.

A flax ``LayerNorm``, ``BatchNorm`` or ``GroupNorm`` built with
``dtype=bfloat16`` keeps float32 parameters and statistics, normalises in
float32 and rounds once. The port's norms (``unmore_tpu_torch/models/norms.py``)
keep their leaves in float32 through a cast of the model to bf16 and do the
same. Inputs are numpy draws; the JAX references come out of one jitted
function, built once per file. Tolerances:

* each norm module (LayerNorm over 256 features, BatchNorm in eval mode and
  GroupNorm of 8 groups over 64 channels, random scales, biases and
  statistics) at bf16 against flax's at ``dtype=bfloat16`` with the same
  float32 leaves: within one bf16 ulp of the larger of the two outputs,
  the ulp of an output below 2^-12 taken at 2^-12 (there the output is the
  difference of O(1) terms, the bias against the scaled input, and their
  float32 rounding decides its low bits in both packages). Rounding the
  leaves to bf16, as the port did before, breaks that bound. The leaves are
  float32 after the cast, equal to the float32 model's;
* the tiny DPT ObjectnessNet (``tests/test_torch_models.py``'s, the scales
  and biases of its LayerNorms moved by N(0, 0.5^2)) in bf16 against flax's
  bf16 model on four 64^2 crops: rel L2 0.05 between the two bf16 outputs,
  and the port's bf16 no further from the port's float32 result than twice
  flax's bf16 is (over six draws of the leaves and crops: rel L2 0.015-0.036,
  ratio 0.64-1.50; at these widths the activations' bf16 rounding hides the
  norms': the leaves rounded to bf16 gave 0.017-0.039 and 0.64-1.41);
* the ResNet-50 existence classifier with ``stage_blocks=(1, 1, 1, 1)``
  (random BatchNorm leaves) in bf16 against flax's bf16 on sixteen 64^2
  crops: mean abs difference of the probabilities 5e-3, and the port's
  mean distance to its float32 probabilities at most 1.5 times flax's
  (over six draws: 5.7e-4 to 3.3e-3 and 0.52-1.14; the leaves rounded to
  bf16 gave ratios 0.67-3.60).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax
from unmore_tpu_torch.models.norms import KeepsFloat32, LayerNorm, GroupNorm
from unmore_tpu_torch.models.resnet import BatchNorm2d, BinaryClassifier
from tests.test_torch_models import TINY, TINY_DPT, flax_objectness_params, port_objectness

C, D, GROUPS = 64, 256, 8
BLOCKS = (1, 1, 1, 1)
FLAX_NORMS = {
    "layer": fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16),
    "batch": fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16),
    "group": fnn.GroupNorm(num_groups=GROUPS, epsilon=1e-5, dtype=jnp.bfloat16),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """float32 ``a`` rounded to bf16 and back (the inputs both packages take)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _norm_inputs(rng):
    leaves = lambda n: {"scale": rng.randn(n).astype(np.float32), "bias": rng.randn(n).astype(np.float32)}
    return {
        "layer": {"x": _bf16(rng.randn(8, 65, D) * 2 + 0.5), "params": leaves(D)},
        "batch": {"x": _bf16(rng.randn(4, 16, 16, C) * 3 + 1), "params": leaves(C),
                  "batch_stats": {"mean": rng.randn(C).astype(np.float32),
                                  "var": (rng.rand(C) * 2 + 0.2).astype(np.float32)}},
        "group": {"x": _bf16(rng.randn(4, 16, 16, C) * 2 + 0.5), "params": leaves(C)},
    }


def _classifier_variables(rng):
    fmodel = FlaxBinaryClassifier(stage_blocks=BLOCKS)
    variables = jax.device_get(
        jax.jit(lambda k: fmodel.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a, np.float32) + (0.3 if p[-1].key in ("scale", "bias") else 0.02)
        * rng.randn(*a.shape).astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.randn(*a.shape) * 0.5 if p[-1].key == "mean" else rng.rand(*a.shape) * 2 + 0.2)
        .astype(np.float32), variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    norms = _norm_inputs(rng)
    _, params = flax_objectness_params("tanh")
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 * rng.randn(*a.shape).astype(np.float32) if p[-2].key in ("norm1", "norm2") else a,
        params)
    classifier = _classifier_variables(rng)
    crops = rng.rand(4, 64, 64, 3).astype(np.float32)
    cls_crops = rng.rand(16, 64, 64, 3).astype(np.float32)
    dpt = FlaxObjectnessNet(backbone_type="dpt_base", sdf_activation="tanh", use_bg_sdf=True,
                            vit_config=FlaxViTConfig(**TINY), dtype=jnp.bfloat16, **TINY_DPT)
    cls = FlaxBinaryClassifier(stage_blocks=BLOCKS, dtype=jnp.bfloat16)

    def reference(norms, params, classifier, crops, cls_crops):
        out = {name: FLAX_NORMS[name].apply({k: v for k, v in inp.items() if k != "x"},
                                            inp["x"].astype(jnp.bfloat16)).astype(jnp.float32)
               for name, inp in norms.items()}
        out["dpt"] = dpt.apply({"params": params}, crops)
        out["classifier"] = cls.apply(classifier, cls_crops)
        return out

    want = jax.device_get(jax.jit(reference)(norms, params, classifier, crops, cls_crops))
    return dict(norms=norms, params=params, classifier=classifier, crops=crops, cls_crops=cls_crops, want=want)


def _port_norm(name, inp):
    t = lambda a: torch.from_numpy(np.asarray(a))
    if name == "layer":
        m = LayerNorm(D, eps=1e-6)
    elif name == "batch":
        m = BatchNorm2d(C)
        m.running_mean.copy_(t(inp["batch_stats"]["mean"]))
        m.running_var.copy_(t(inp["batch_stats"]["var"]))
    else:
        m = GroupNorm(GROUPS, C, eps=1e-5)
    with torch.no_grad():
        m.weight.copy_(t(inp["params"]["scale"]))
        m.bias.copy_(t(inp["params"]["bias"]))
    return m.eval()


def _apply(m, name, x):
    """The port's norm on the NHWC (or [N, L, D]) float32 array ``x`` as bf16."""
    xt = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        if name == "layer":
            return m(xt).float().numpy()
        return m(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()


def bf16_ulps(got, want, floor=2.0**-12):
    """|got - want| in bf16 ulps of the larger magnitude (at least ``floor``)."""
    m = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("name", ("layer", "batch", "group"))
def test_norm_in_bf16_equals_flax_within_one_ulp(world, name):
    inp = world["norms"][name]
    f32 = _port_norm(name, inp)
    m = _port_norm(name, inp).to(torch.bfloat16)
    leaves = {**dict(m.named_parameters()), **{n: b for n, b in m.named_buffers() if b.is_floating_point()}}
    assert len(leaves) == (4 if name == "batch" else 2)
    for n, leaf in leaves.items():
        assert leaf.dtype == torch.float32 and torch.equal(leaf, f32.get_parameter(n) if "running" not in n
                                                           else f32.get_buffer(n)), n
    got = _apply(m, name, inp["x"])
    want = world["want"][name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bf16_ulps(got, want).max() <= 1.0
    # the leaves rounded to bf16 (the port before) miss that bound
    for leaf in leaves.values():
        leaf.data = leaf.data.bfloat16()
    assert bf16_ulps(_apply(m, name, inp["x"]), want).max() > 1.0


def test_casts_keep_float32_leaves_only_for_half_dtypes():
    m = torch.nn.Sequential(LayerNorm(D), torch.nn.Linear(D, 4), GroupNorm(2, 4), BatchNorm2d(4))
    w = m[0].weight.detach().clone()
    m.to(torch.bfloat16)
    assert m[1].weight.dtype == torch.bfloat16
    kept = [*m[0].parameters(), *m[2].parameters(), *m[3].parameters(), m[3].running_mean, m[3].running_var]
    assert {t.dtype for t in kept} == {torch.float32}
    m.double()
    assert {t.dtype for t in [*m.parameters(), m[3].running_mean]} == {torch.float64}
    m.float().half()
    assert torch.equal(m[0].weight, w) and m[1].weight.dtype == torch.float16
    assert all(isinstance(x, KeepsFloat32) for x in (m[0], m[2], m[3]))


def test_autocast_forward_is_torchs():
    rng = np.random.RandomState(1)
    m = LayerNorm(D, eps=1e-6)
    ref = torch.nn.LayerNorm(D, eps=1e-6)
    with torch.no_grad():
        for p, q in zip(m.parameters(), ref.parameters()):
            p.copy_(torch.from_numpy(rng.randn(D).astype(np.float32)))
            q.copy_(p)
    x = torch.from_numpy(rng.randn(4, D).astype(np.float32)).bfloat16()
    with torch.autocast("cpu", torch.bfloat16), torch.no_grad():
        got, want = m(x), ref(x)
    assert got.dtype == want.dtype and torch.equal(got, want)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tiny_dpt_in_bf16_lies_as_close_to_f32_as_flaxs(world):
    x = torch.from_numpy(world["crops"])
    with torch.no_grad():
        f32 = port_objectness(world["params"])(x)
        ours = port_objectness(world["params"]).to(torch.bfloat16)(x)
    for k in ("sdf_maps", "center_fields"):
        theirs = world["want"]["dpt"][k]
        assert rel_l2(ours[k], theirs) <= 0.05, k
        assert rel_l2(ours[k], f32[k]) <= 2 * rel_l2(theirs, f32[k]), k


def test_resnet50_classifier_in_bf16_lies_as_close_to_f32_as_flaxs(world):
    sd = classifier_state_dict_from_flax(world["classifier"])
    x = torch.from_numpy(world["cls_crops"])

    def port(dtype):
        m = BinaryClassifier(stage_blocks=BLOCKS).eval()
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            return m.to(dtype)(x).numpy()

    f32, ours, theirs = port(torch.float32), port(torch.bfloat16), np.asarray(world["want"]["classifier"])
    assert ours.shape == theirs.shape == (16, 1)
    assert np.abs(ours - theirs).mean() <= 5e-3
    assert np.abs(ours - f32).mean() <= 1.5 * np.abs(theirs - f32).mean()
