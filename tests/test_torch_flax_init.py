"""The port's flax initialisation (``unmore_tpu_torch/models/flax_init.py``
and the ``jax.random`` draws under it in ``utils/prng.py``) against the
installed JAX and flax, on the CPU:

* keys: ``fold_in`` against ``jax.random.fold_in``, and the path hash
  against flax's own ``_fold_in_static`` for nested names and for counts
  that take one and two bytes;
* draws: ``uniform(minval, maxval)`` on 2-D and 4-D shapes, ``normal``,
  ``truncated_normal`` and the two ``erf`` bounds held as literals, against
  ``jax.random`` and ``jax.lax.erf``;
* the host library that draws on the CPU against the torch ops that draw
  on a card, bit for bit;
* every leaf of every family against the JAX package's own init functions:
  a tiny ``dpt_large``-style objectness net with the classifier through
  ``cli/common.py:init_random_variables``, a tiny ``dpt_hybrid`` through
  ``train/objectness.py:init_state``, the ``stage_blocks=(1, 1, 1, 1)``
  classifier through ``train/classifier.py:init_classifier_state`` and the
  tiny CAD through ``train/detector.py:init_detector_state``;
* the first loss of a seeded stage-1 step (seeded discovery with no
  weights carried across is in ``tests/test_torch_slice.py``).

Keys and uniform bits must be bit-exact. Floats must be within ``ULP``
units in the last place, with at least ``BIT_EQUAL`` of the elements
bit-equal. On an x86 host with FMA every element of every draw and leaf was
bit-equal to JAX's (XLA's CPU code contracts a multiply into the add after
it; the port rounds those pairs once through float64). Torch is held to one
thread; the JAX references are built once per file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core.scope import _fold_in_static

from unmore_tpu.cli import common as jax_common
from unmore_tpu.detector.cascade_rcnn import CascadeMaskRCNN as JaxDetector
from unmore_tpu.detector.cascade_rcnn import DetectorConfig as JaxDetectorConfig
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.train import classifier as jax_classifier
from unmore_tpu.train import detector as jax_detector
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu_torch.cli import common
from unmore_tpu_torch.detector import convert as detector_convert
from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN, DetectorConfig
from unmore_tpu_torch.models import flax_init
from unmore_tpu_torch.models.convert import classifier_flax_from_state_dict, objectness_flax_from_state_dict
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.train.objectness import ObjectnessTrainer
from unmore_tpu_torch.train.optim import init_like_flax
from unmore_tpu_torch.utils import prng
from tests.test_torch_hybrid import flax_net as flax_hybrid
from tests.test_torch_hybrid import port_net as port_hybrid
from tests.test_torch_models import HIGH, TINY, TINY_DPT
from tests.test_torch_train import FLAX_MODEL, as_jax, as_torch, jax_step, make_batch
from tests.test_torch_train import port_model as stage1_port_model

ULP = 2  # the bound on every float leaf and draw
BIT_EQUAL = 0.99  # the least share of bit-equal elements (1.0 here)
SEED = 0
CAD = dict(image_size=64, rpn_pre_nms_topk_test=32, rpn_post_nms_topk_test=32, detections_per_image=8,
           stage_blocks=(1, 1, 1, 1))
PATHS = ((("body",), 1), (("backbone", "vit", "block0", "attn", "qkv"), 2), (("head",), 256),
         (("backbone", "refinenet3", "rcu1", "conv2"), 1000))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(got, want) -> np.ndarray:
    """|got - want| in float32 units in the last place (over signed zero too)."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (got, want))
    a, b = (np.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (a, b))
    return np.abs(a - b)


def assert_close_ulp(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    u = _ulps(got, want)
    assert u.max(initial=0) <= ULP and np.mean(u == 0) >= BIT_EQUAL, (what, u.max(), np.mean(u == 0))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_same_tree(got: dict, want: dict):
    """Every leaf of the port's tree against the JAX tree: the same paths;
    zeros and ones exact, random leaves within the bound."""
    got, want = dict(_flat(got)), dict(_flat(jax.device_get(want)))
    assert set(got) == set(want), set(got) ^ set(want)
    for path, w in want.items():
        if path[-1] in ("kernel", "pos_embed"):
            assert_close_ulp(got[path], w, path)
        else:
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))


def tiny_large(port=True):
    """The tiny ``dpt_large``-style objectness net (``tests/test_torch_models.py``'s widths)."""
    if port:
        return ObjectnessNet("dpt_large", "tanh", True, vit_config=ViTConfig(**TINY), **TINY_DPT)
    return FlaxObjectnessNet(backbone_type="dpt_large", sdf_activation="tanh", use_bg_sdf=True,
                             vit_config=FlaxViTConfig(**TINY), precision=HIGH, **TINY_DPT)


@pytest.fixture(scope="module")
def ref():
    key = jax.random.PRNGKey(3)
    u_shapes = ((37, 53), (3, 3, 16, 32))
    big = (300, 1000)
    large, classifier = tiny_large(False), FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    obj_params, cls_vars = jax_common.init_random_variables(large, classifier, crop_size=32, seed=SEED)
    tx = optax.sgd(0.1)
    hybrid = jax_objectness.init_state(flax_hybrid(), tx, jax.random.PRNGKey(SEED), 32).params
    cls_state = jax_classifier.init_classifier_state(classifier, tx, jax.random.PRNGKey(SEED), 32)
    jcfg = JaxDetectorConfig(**CAD)
    cad = jax_detector.init_detector_state(JaxDetector(jcfg), tx, jax.random.PRNGKey(1), jcfg)
    return {
        "key": np.asarray(key),
        "fold_in": [np.asarray(jax.random.fold_in(key, d)) for d in (0, 1, 255, 256, 2**32 - 1)],
        "static": [np.asarray(_fold_in_static(key, (*path, count))) for path, count in PATHS],
        "uniform": [np.asarray(jax.random.uniform(key, s, jnp.float32, -0.3, 2.5)) for s in u_shapes],
        "uniform01": [np.asarray(jax.random.uniform(key, s)) for s in u_shapes],
        "normal": np.asarray(jax.jit(lambda k: jax.random.normal(k, big))(key)),
        "truncated": np.asarray(jax.jit(lambda k: jax.random.truncated_normal(k, -2, 2, big))(key)),
        "erf": [np.asarray(jax.lax.erf(np.float32(b) / np.float32(np.sqrt(2)))) for b in (-2, 2)],
        "large": obj_params, "classifier": cls_vars, "hybrid": hybrid,
        "cls_state": {"params": cls_state.params, "batch_stats": cls_state.batch_stats},
        "cad": {"params": cad.params, "batch_stats": cad.batch_stats},
    }


# ---------------------------------------------------------------- keys
def test_fold_in_is_jaxs(ref):
    for d, want in zip((0, 1, 255, 256, 2**32 - 1), ref["fold_in"]):
        np.testing.assert_array_equal(prng.fold_in(ref["key"], d).numpy(), want)
    batched = prng.fold_in(ref["key"], torch.tensor([1, 256], dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(batched, np.stack([ref["fold_in"][1], ref["fold_in"][3]]))


def test_path_hash_is_flaxs(ref):
    """Nested scope names, and counts of one byte and of two (256, 1000)."""
    for (path, count), want in zip(PATHS, ref["static"]):
        got = prng.fold_in(ref["key"], flax_init.leaf_hash(path, count)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((path, count)))


def test_draw_counts_follow_creation_order():
    counts = flax_init.draw_counts([("a", "kernel"), ("a", "bias"), ("n", "scale"), ("n", "bias"), ("c", "kernel"),
                                    ("g", "bias"), ("v", "cls_token"), ("v", "pos_embed"), ("v", "d", "kernel")])
    assert counts == {("a", "kernel"): 1, ("a", "bias"): 2, ("n", "scale"): 1, ("n", "bias"): 2, ("c", "kernel"): 1,
                      ("g", "bias"): 1, ("v", "cls_token"): 1, ("v", "pos_embed"): 2, ("v", "d", "kernel"): 1}


# ---------------------------------------------------------------- draws
def test_uniform_bits_on_2d_and_4d_shapes_are_jaxs(ref):
    for shape, want, want01 in zip(((37, 53), (3, 3, 16, 32)), ref["uniform"], ref["uniform01"]):
        np.testing.assert_array_equal(prng.uniform(ref["key"], shape, -0.3, 2.5).numpy(), want)
        np.testing.assert_array_equal(prng.uniform(ref["key"], shape).numpy(), want01)


def test_erf_bounds_are_xlas(ref):
    assert np.float32(prng.ERF_MINUS_SQRT2) == ref["erf"][0]
    assert np.float32(prng.ERF_SQRT2) == ref["erf"][1]


def test_normal_and_truncated_normal_are_jaxs(ref):
    key = ref["key"]
    assert_close_ulp(prng.normal(key, (300, 1000)).numpy(), ref["normal"], "normal")
    got = prng.truncated_normal(key, -2, 2, (300, 1000)).numpy()
    assert_close_ulp(got, ref["truncated"], "truncated_normal")
    assert np.abs(got).max() < 2
    pieces = torch.cat([prng.truncated_normal(key, -2, 2, 1000, start) for start in range(0, 300_000, 1000)])
    np.testing.assert_array_equal(pieces.numpy(), got.reshape(-1))  # pieces join into the whole draw


def test_host_library_is_the_torch_ops(ref):
    """The CPU's draws (``csrc/flax_init.cpp``) equal the torch ops that a
    card runs, bit for bit, over a draw larger than a thread's share."""
    key = torch.from_numpy(ref["key"].astype(np.int64))
    for shape in ((3, 3, 64, 96), (1, 17, 32)):
        want = prng.truncated_normal(key, -2, 2, shape) * flax_init.lecun_stddev(shape)
        torch.testing.assert_close(flax_init._draw(key, shape, "kernel", torch.device("cpu")), want, rtol=0, atol=0)
        want = prng.normal(key, shape, scale=flax_init.POS_EMBED_STD)
        torch.testing.assert_close(flax_init._draw(key, shape, "pos_embed", torch.device("cpu")), want, rtol=0, atol=0)


# ------------------------------------------------------------- families
def test_init_random_variables_is_the_jax_clis(ref):
    """``dpt_large``-style objectness and the classifier from one seed."""
    obj, cls = tiny_large(), BinaryClassifier(stage_blocks=(1, 1, 1, 1))
    common.init_random_variables(obj, cls, seed=SEED)
    assert_same_tree(objectness_flax_from_state_dict(obj.state_dict()), ref["large"])
    assert_same_tree(classifier_flax_from_state_dict(cls.state_dict()), ref["classifier"])
    for k, v in obj.state_dict().items():  # the leaves the JAX tree lacks are zero
        if "refinenet4.resConfUnit1" in k:
            assert not v.any(), k


def test_hybrid_is_the_stage1_trainers(ref):
    model = port_hybrid()
    init_like_flax(model, SEED)
    assert_same_tree(objectness_flax_from_state_dict(model.state_dict()), ref["hybrid"])


def test_classifier_is_the_classifier_trainers(ref):
    model = BinaryClassifier(stage_blocks=(1, 1, 1, 1))
    init_like_flax(model, SEED)
    assert_same_tree(classifier_flax_from_state_dict(model.state_dict()), ref["cls_state"])
    assert all(int(v) == 0 for k, v in model.state_dict().items() if k.endswith("num_batches_tracked"))


def test_cad_is_the_detector_trainers(ref):
    """``init_detector_state`` draws from ``PRNGKey(0)`` whatever its ``rng``."""
    model = CascadeMaskRCNN(DetectorConfig(**CAD))
    init_like_flax(model, 0)
    assert_same_tree(detector_convert.flax_from_state_dict(model.state_dict()), ref["cad"])


# ---------------------------------------------------------------- stage 1
def test_first_seeded_stage1_loss_is_jaxs():
    tx, step, port_cfg = jax_step()
    state = jax_objectness.init_state(FLAX_MODEL, tx, jax.random.PRNGKey(SEED), 32)
    model = stage1_port_model()
    init_like_flax(model, SEED)
    batch = make_batch(4)
    _, m = step(state, as_jax(batch))
    got = ObjectnessTrainer(model, port_cfg).train_step(as_torch(batch))
    np.testing.assert_allclose(float(got["total"]), float(m["total"]), rtol=1e-4)
