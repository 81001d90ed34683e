"""The port's models against the JAX package's, with weights carried across.

Flax random init (perturbed so every bias and BN statistic is non-trivial)
-> ``*_state_dict_from_flax`` -> port forward on the CPU in f32, against the
flax forward at ``Precision.HIGHEST``. Tolerances are those of
``tests/test_model_parity.py``: 2e-4 for the objectness net (a deep f32
chain whose sums run in another order), 2e-5 for the classifier.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unmore_tpu.models.convert import convert_objectness_state_dict
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu_torch.models.convert import (
    classifier_state_dict_from_flax,
    load_objectness_state_dict,
    objectness_state_dict_from_flax,
)
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from tests.torch_ref import TorchDPTObjectness

HIGH = jax.lax.Precision.HIGHEST
TINY = dict(depth=4, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TINY_DPT = dict(features=16, hooks=(0, 1, 2, 3), widths=(8, 16, 24, 24))


def _perturb(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*np.shape(a)).astype(np.float32), tree
    )


def flax_objectness_params(sdf_activation="tanh", seed=0):
    model = FlaxObjectnessNet(
        backbone_type="dpt_base", sdf_activation=sdf_activation, use_bg_sdf=True,
        vit_config=FlaxViTConfig(**TINY), precision=HIGH, **TINY_DPT,
    )
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)))["params"])(jax.random.PRNGKey(seed))
    return model, _perturb(jax.device_get(params), seed + 1)


def port_objectness(params, sdf_activation="tanh"):
    model = ObjectnessNet("dpt_base", sdf_activation, True, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()
    load_objectness_state_dict(model, objectness_state_dict_from_flax(params, sdf_activation, True))
    return model


@pytest.mark.parametrize("sdf_activation,hw", [("tanh", 64), ("tanh", 32), ("sine", 32)])
def test_objectness_matches_flax(sdf_activation, hw):
    fmodel, params = flax_objectness_params(sdf_activation)
    x = np.random.RandomState(hw).rand(2, hw, hw, 3).astype(np.float32)
    want = fmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port_objectness(params, sdf_activation)(torch.from_numpy(x))
    np.testing.assert_allclose(got["sdf_maps"].numpy(), np.asarray(want["sdf_maps"]), atol=2e-4)
    np.testing.assert_allclose(got["center_fields"].numpy(), np.asarray(want["center_fields"]), atol=2e-4)
    assert got["center_fields"].shape == (2, hw, hw, 2) and got["center_fields"].is_contiguous()


def test_compute_center_false_skips_center_head():
    _, params = flax_objectness_params()
    model = port_objectness(params)
    calls = []
    model.center_field_prediction_head.register_forward_hook(lambda *a: calls.append(1))
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        full = model(x)
        assert len(calls) == 1
        sdf_only = model(x, compute_center=False)
    assert len(calls) == 1, "center head ran with compute_center=False"
    assert set(sdf_only) == {"sdf_maps"}
    torch.testing.assert_close(sdf_only["sdf_maps"], full["sdf_maps"], rtol=0, atol=0)


def test_objectness_round_trip_through_the_jax_converter():
    _, params = flax_objectness_params()
    back = convert_objectness_state_dict(objectness_state_dict_from_flax(params))
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_p) == set(flat_b)
    for k, v in flat_p.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=jax.tree_util.keystr(k))


def test_reference_checkpoint_loads_with_load_state_dict():
    # the reference-shaped torch fixture uses the reference checkpoint's
    # names; its state_dict loads strictly and computes the same function
    torch.manual_seed(0)
    ref = TorchDPTObjectness().eval()
    model = ObjectnessNet("dpt_base", "tanh", True, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()
    model.load_state_dict(ref.state_dict(), strict=True)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["sdf_maps"].numpy(), want["sdf_maps"][:, 0].numpy(), atol=2e-5)
    np.testing.assert_allclose(
        got["center_fields"].numpy(), want["center_fields"].permute(0, 2, 3, 1).numpy(), atol=2e-5
    )


def test_classifier_matches_flax():
    blocks = (2, 2, 2, 2)
    fmodel = FlaxBinaryClassifier(stage_blocks=blocks, precision=HIGH)
    variables = jax.device_get(
        jax.jit(lambda k: fmodel.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    )
    rng = np.random.RandomState(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.1 if path[-1].key == "mean" else rng.rand(*a.shape) + 0.5)
        .astype(np.float32),
        variables["batch_stats"],
    )
    variables = {"params": _perturb(variables["params"], 3), "batch_stats": stats}
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))

    model = BinaryClassifier(stage_blocks=blocks).eval()
    model.load_state_dict(classifier_state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-5)
