"""The port's ``dpt_hybrid`` (ResNetV2-50 trunk + ViT-B/16) against the JAX package's, on the CPU.

Miniature widths: trunk stem 8, stages (8, 16) / (16, 32) / (32, 64) with
(2, 1, 2) blocks and GroupNorm of 4 groups; ViT dim 32, depth 2, taps (0, 1);
DPT features 16, reassemble widths (16, 32, 24, 24). Weights are numpy draws
shaped by ``jax.eval_shape`` of the flax model, carried into the port by
``objectness_state_dict_from_flax``. The JAX forwards come out of one jitted
function, built once per file. Tolerances:

* ``StdConv2dSame`` and the SAME max-pool against flax's ``WSConv`` and
  ``nn.max_pool(..., "SAME")``: 1e-5;
* the trunk's three taps: 1e-4; the whole ObjectnessNet: 2e-4
  (``tests/test_model_parity.py``), at 64^2 and 96^2;
* the reference-named fixture of ``tests/test_hybrid_parity.py``: loads
  strict; 2e-5 against the fixture, 2e-4 against the JAX package;
* bf16: the standardised kernels equal ``bf16(standardise(f32 w))``
  exactly, and equal the JAX package's standardisation cast to bf16; each bf16 trunk tap and output within rel L2 0.1 of the JAX
  package's bf16 one and no further from the f32 result than twice JAX's own
  bf16 distance (at these widths both lie 0.6-5% from f32; measured ratios
  0.89-1.37 with the GroupNorms' leaves kept in f32 as the JAX package keeps
  them, 1.03-1.41 when the port rounded them to bf16: what remains is not
  the norms', which ``tests/test_torch_bf16_norms.py`` holds to one ulp);
* one SGD step of the stage-1 trainers in f32: each loss term rtol 1e-5,
  parameters after the step (rate 0.01) 2e-6, each leaf's move within 1e-3
  of the JAX move's L2 norm (``tests/test_torch_train.py``'s gradient
  tolerance; measured 1.2e-4 at most);
* one discovery image group and one scoring call (tiny hybrid and
  classifier): equal counts, boxes 1e-3, scores rtol 1e-4, as
  ``tests/test_torch_scoring.py`` does for ``dpt_base``;
* in the ``slow`` lane, the full-width hybrid: the port's bf16 forward no
  further from its f32 forward than 1.5 times the JAX package's.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import linen as nn

from unmore_tpu.cli import common as jax_common
from unmore_tpu.config import ModelConfig as JaxModelConfig
from unmore_tpu.config import OptimConfig as JaxOptimConfig
from unmore_tpu.config import TrainObjectnessConfig as JaxTrainConfig
from unmore_tpu.config import load_config as jax_load_config
from unmore_tpu.models.convert import convert_objectness_state_dict
from unmore_tpu.models.hybrid import ResNetV2Stages as FlaxTrunk
from unmore_tpu.models.hybrid import WSConv, _standardize
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.reasoning.engine import ObjectDiscoveryEngine as JaxDiscovery
from unmore_tpu.reasoning.engine import ReasoningConfig as JaxReasoningConfig
from unmore_tpu.reasoning.scoring import ObjectScoringEngine as JaxScoring
from unmore_tpu.reasoning.scoring import ScoringConfig as JaxScoringConfig
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu_torch.cli import common, object_reasoning, object_scoring
from unmore_tpu_torch.cli import train_objectness_net as train_cli
from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig, load_config, save_config
from unmore_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, flax_layout, load_objectness_state_dict, objectness_flax_from_state_dict,
    objectness_state_dict_from_flax,
)
from unmore_tpu_torch.models.hybrid import HybridViTBackbone, StdConv2dSame, _pads, max_pool_same, standardize
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig
from unmore_tpu_torch.train.objectness import ObjectnessTrainer
from tests.test_hybrid_parity import TorchHybridObjectness
from tests.test_reasoning_engine import make_world
from tests.test_torch_scoring import assert_same_annotations
from tests.test_torch_train import as_jax, as_torch, make_batch
from tests.test_torch_train_cli import OBJECTNESS, write_world

HIGH = jax.lax.Precision.HIGHEST
VIT = dict(depth=2, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TRUNK = dict(stem_width=8, stage_widths=((8, 16), (16, 32), (32, 64)), stage_blocks=(2, 1, 2), groups=4)
DPT = dict(features=16, hooks=(0, 1), widths=(16, 32, 24, 24))
# tests/test_hybrid_parity.py's TorchHybridObjectness at its defaults
FIXTURE = dict(features=16, hooks=(0, 1), widths=(16, 32, 24, 24),
               hybrid_resnet_kwargs=dict(TRUNK, stage_blocks=(1, 1, 1)))
TRUNK_NAME = "backbone.pretrained.model.patch_embed.backbone"


def flax_net(sdf_activation="tanh", dtype=jnp.float32, trunk=TRUNK, **kw):
    kw = dict(DPT, hybrid_resnet_kwargs=trunk, **kw)
    return FlaxObjectnessNet(backbone_type="dpt_hybrid", sdf_activation=sdf_activation, use_bg_sdf=True,
                             vit_config=FlaxViTConfig(**VIT), dtype=dtype,
                             precision=HIGH if dtype != jnp.bfloat16 else None, **kw)


def port_net(params=None, sdf_activation="tanh", **kw):
    model = ObjectnessNet("dpt_hybrid", sdf_activation, True, vit_config=ViTConfig(**VIT),
                          **dict(dict(DPT, hybrid_resnet_kwargs=TRUNK), **kw))
    if params is not None:
        load_objectness_state_dict(model, objectness_state_dict_from_flax(params, sdf_activation, True))
    return model.eval()


def random_leaves(shapes, seed):
    """Numpy draws for a flax tree of shapes: kernels ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), every other leaf N(0, 0.05^2)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flax_params(model, seed, size=64):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    return random_leaves(shapes["params"], seed)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@jax.jit
def jax_reference(params, fixture_params, x64, x96):
    """Every JAX forward the file compares with, in one program."""
    trunk = FlaxTrunk(precision=HIGH, **TRUNK)
    trunk_bf16 = FlaxTrunk(dtype=jnp.bfloat16, **TRUNK)
    resnet = {"params": params["backbone"]["vit"]["resnet"]}
    tanh, sine = flax_net(), flax_net("sine")
    fixture = flax_net(trunk=FIXTURE["hybrid_resnet_kwargs"])
    return {
        "trunk64": trunk.apply(resnet, x64), "trunk96": trunk.apply(resnet, x96),
        "trunk64_bf16": trunk_bf16.apply(resnet, x64),
        "tanh64": tanh.apply({"params": params}, x64), "tanh96": tanh.apply({"params": params}, x96),
        "sine64": sine.apply({"params": params}, x64),
        "bf16_64": flax_net(dtype=jnp.bfloat16).apply({"params": params}, x64),
        "fixture64": fixture.apply({"params": fixture_params}, x64),
    }


@pytest.fixture(scope="module")
def world():
    torch.manual_seed(0)
    fixture = TorchHybridObjectness().eval()
    fixture_params = convert_objectness_state_dict(fixture.state_dict())
    params = flax_params(flax_net(), seed=1)
    rng = np.random.RandomState(2)
    x64, x96 = rng.rand(2, 64, 64, 3).astype(np.float32), rng.rand(2, 96, 96, 3).astype(np.float32)
    want = jax.device_get(jax_reference(params, fixture_params, x64, x96))
    return dict(params=params, fixture=fixture, fixture_params=fixture_params, x64=x64, x96=x96, want=want)


# ------------------------------------------------------------- the layers
@pytest.mark.parametrize("k,stride,size", [(k, s, n) for k in (1, 3, 7) for s in (1, 2) for n in (15, 16)])
def test_std_conv_same_matches_flax_ws_conv(k, stride, size):
    rng = np.random.RandomState(k * 100 + stride * 10 + size)
    x = (rng.randn(2, size, size + 3, 5) / np.sqrt(k * k * 5)).astype(np.float32)  # outputs of unit scale
    w = (rng.randn(k, k, 5, 6) * 0.3 + 0.1).astype(np.float32)
    want = WSConv(6, (k, k), strides=(stride, stride), padding="SAME", use_bias=False, precision=HIGH).apply(
        {"params": {"kernel": w}}, x)
    conv = StdConv2dSame(5, 6, k, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape[2:] == (-(-size // stride), -(-(size + 3) // stride))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(conv.kernel(torch.float32).permute(2, 3, 1, 0).detach().numpy(),
                               np.asarray(_standardize(w)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,stride,size", [(3, 2, 16), (3, 2, 15), (2, 2, 15), (3, 1, 16)])
def test_max_pool_same_pads_with_minus_inf_like_flax(k, stride, size):
    x = -(np.abs(np.random.RandomState(size).randn(2, size, size + 1, 3)) + 0.5).astype(np.float32)  # all negative
    want = np.asarray(nn.max_pool(jnp.asarray(x), (k, k), strides=(stride, stride), padding="SAME"))
    got = _nhwc(max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k, stride))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (want < 0).all()  # a zero pad would have shown on the padded edges


@pytest.mark.parametrize("size", [64, 96])
def test_trunk_taps_match_flax(world, size):
    trunk = port_net(world["params"]).backbone.pretrained.model.patch_embed.backbone
    with torch.no_grad():
        got = trunk(torch.from_numpy(world[f"x{size}"]).permute(0, 3, 1, 2))
    assert [t.shape[1:] for t in got] == [(16, size // 4, size // 4), (32, size // 8, size // 8),
                                          (64, size // 16, size // 16)]
    for g, w in zip(got, world["want"][f"trunk{size}"]):
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-4, rtol=0)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("sdf_activation,size", [("tanh", 64), ("tanh", 96), ("sine", 64)])
def test_objectness_matches_flax(world, sdf_activation, size):
    want = world["want"][f"{sdf_activation}{size}"]
    model = port_net(world["params"], sdf_activation)
    with torch.no_grad():
        got = model(torch.from_numpy(world[f"x{size}"]))
        sdf_only = model(torch.from_numpy(world[f"x{size}"]), compute_center=False)
    for key in ("sdf_maps", "center_fields"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=0, err_msg=key)
    assert set(sdf_only) == {"sdf_maps"}
    torch.testing.assert_close(sdf_only["sdf_maps"], got["sdf_maps"], rtol=0, atol=0)
    assert isinstance(model.backbone.pretrained.model, HybridViTBackbone)
    assert not any("act_postprocess1" in k or "act_postprocess2" in k for k in model.state_dict())


def test_grid_must_be_the_patch_grid(world):
    with pytest.raises(ValueError, match="patch grid"):
        port_net(world["params"])(torch.zeros(1, 72, 64, 3))


def test_flax_port_flax_round_trip_is_leaf_for_leaf(world):
    params = world["params"]
    sd = objectness_state_dict_from_flax(params)
    model = port_net()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("refinenet4.resConfUnit1" in k for k in missing)
    assert sum(k.startswith(TRUNK_NAME) for k in sd) == 3 + 3 * 12 + 2 * 9  # stem, 3 first blocks, 2 others
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for back in (objectness_flax_from_state_dict(model.state_dict()), convert_objectness_state_dict(sd)):
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert set(flat_b) == set(flat_p)
        for k, v in flat_p.items():
            np.testing.assert_array_equal(flat_b[k], v, err_msg=jax.tree_util.keystr(k))


def test_reference_named_fixture_loads_strict(world):
    fixture = world["fixture"]
    model = port_net(**FIXTURE)
    model.load_state_dict(fixture.state_dict(), strict=True)
    x = world["x64"]
    with torch.no_grad():
        want = fixture(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["sdf_maps"].numpy(), want["sdf_maps"][:, 0].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["center_fields"].numpy(), _nhwc(want["center_fields"]), atol=2e-5, rtol=0)
    for key in ("sdf_maps", "center_fields"):
        np.testing.assert_allclose(got[key].numpy(), world["want"]["fixture64"][key], atol=2e-4, rtol=0)


# -------------------------------------------------------------- bfloat16
def test_bf16_standardises_the_trunk_kernels_from_f32(world):
    params = world["params"]
    f32, bf16 = port_net(params), port_net(params).to(torch.bfloat16)
    convs = [(n, m) for n, m in bf16.named_modules() if isinstance(m, StdConv2dSame)]
    assert len(convs) == 1 + 3 + 3 * 5  # stem, downsample of 3 first blocks, 3 convs of 5 blocks
    assert bf16.center_field_prediction_head[0].weight.dtype == torch.bfloat16
    layout = flax_layout(bf16.state_dict(), "objectness")
    rounded_first = 0
    with torch.no_grad():
        for name, conv in convs:
            master = f32.get_submodule(name).weight
            assert conv.weight.dtype == torch.float32 and torch.equal(conv.weight, master), name
            want = standardize(master).to(torch.bfloat16)
            assert torch.equal(conv.kernel(torch.bfloat16), want), name
            leaf = params
            for key in layout[f"{name}.weight"][0]:
                leaf = leaf[key]
            jax_bf16 = np.asarray(_standardize(jnp.asarray(leaf)).astype(jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(want.float().permute(2, 3, 1, 0).numpy(), jax_bf16, err_msg=name)
            rounded_first += not torch.equal(standardize(master.to(torch.bfloat16)).to(torch.bfloat16), want)
            x = torch.randn(1, conv.in_channels, 9, 9).to(torch.bfloat16)
            padding, explicit = _pads(x, conv.kernel_size[0], conv.stride[0])
            padded = x if explicit is None else F.pad(x, explicit)
            torch.testing.assert_close(conv(x), F.conv2d(padded, want, None, conv.stride, padding), rtol=0, atol=0)
    assert rounded_first > 0  # standardising the bf16-rounded kernel would give other bits

    x = torch.from_numpy(world["x64"])
    with torch.no_grad():
        taps = bf16.backbone.pretrained.model.patch_embed.backbone(x.permute(0, 3, 1, 2).to(torch.bfloat16))
        got, ref = bf16(x), f32(x)
    want = world["want"]
    pairs = [(_nhwc(g), np.asarray(w, np.float32), r)
             for g, w, r in zip(taps, want["trunk64_bf16"], want["trunk64"])]
    pairs += [(got[k], want["bf16_64"][k], ref[k]) for k in ("sdf_maps", "center_fields")]
    for ours_bf16, theirs_bf16, f32_out in pairs:
        ours, theirs = rel_l2(ours_bf16, f32_out), rel_l2(theirs_bf16, f32_out)
        assert rel_l2(ours_bf16, theirs_bf16) <= 0.1 and ours <= 2 * theirs, (ours, theirs)


# ----------------------------------------------------------------- stage 1
def test_one_trainer_step_matches_jax(world):
    # SGD: the step's move is the gradient itself (Adam's first move is
    # lr * sign(g), which flips where g lies within f32 noise of 0)
    optim = dict(optimizer="sgd", learning_rate=0.01, lr_scheduler_milestones=(10,))
    port_cfg = TrainObjectnessConfig(model=ModelConfig(image_size=32), optim=OptimConfig(**optim))
    jax_cfg = JaxTrainConfig(model=JaxModelConfig(image_size=32), optim=JaxOptimConfig(**optim))
    batch = make_batch(7)
    tx = jax_objectness.make_optimizer(jax_cfg.optim)
    params = world["params"]
    state = jax_objectness.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    state, metrics = jax_objectness.make_train_step(flax_net(), tx, jax_cfg)(state, as_jax(batch))
    trainer = ObjectnessTrainer(port_net(params), port_cfg)
    got = trainer.train_step(as_torch(batch))
    for key in ("center_field", "sdf", "sdf_gradient", "sdf_binary_mask", "total"):
        np.testing.assert_allclose(float(got[key]), float(metrics[key]), rtol=1e-5, atol=0, err_msg=key)
    tree = trainer.params_tree(trainer.flat.data)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))[0])
    flat_before = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(flat_got) == set(flat_want) and any("resnet" in jax.tree_util.keystr(k) for k in flat_got)
    for k, want in flat_want.items():
        name, before = jax.tree_util.keystr(k), flat_before[k]
        np.testing.assert_allclose(flat_got[k], want, rtol=0, atol=2e-6, err_msg=name)
        move_got, move_want = flat_got[k] - before, np.asarray(want) - before
        assert np.linalg.norm(move_got - move_want) <= 1e-3 * np.linalg.norm(move_want), name


# --------------------------------------------------------- stage 2 slice
def test_discovery_then_scoring_match_jax(world):
    obj_params = world["params"]
    fcls = FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    shapes = jax.eval_shape(lambda: fcls.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    cls_vars = {"params": random_leaves(shapes["params"], 3),
                "batch_stats": jax.tree_util.tree_map_with_path(
                    lambda p, a: np.full(a.shape, 0.0 if p[-1].key == "mean" else 1.0, np.float32),
                    shapes["batch_stats"])}
    variables = {"objectness": obj_params, "classifier": cls_vars}
    fobj = flax_net()

    def jax_obj(variables, crops, compute_center=True):
        return fobj.apply({"params": variables["objectness"]}, crops)

    def jax_cls(variables, crops):
        return fcls.apply(variables["classifier"], crops)[:, 0]

    classifier = BinaryClassifier(stage_blocks=(1, 1, 1, 1)).eval()
    classifier.load_state_dict(classifier_state_dict_from_flax(cls_vars), strict=True)
    fns = common.make_apply_fns(port_net(obj_params), classifier)

    disc = dict(crop_size=32, canvas_size=96, image_batch=2, max_proposals=64, max_splits=64, max_active=64,
                crop_chunk=16, crop_chunk_tail=8, exist_chunk=64, n_round=3, analyze_cc=True)
    worlds = [make_world(96, [(10, 12, 50, 60), (50, 30, 90, 80)]), make_world(96, [(20, 20, 70, 70)])]
    worlds = [np.clip(w * 255.0 + 0.5, 0, 255).astype(np.uint8) for w in worlds]
    want_disc = JaxDiscovery(jax_obj, jax_cls, JaxReasoningConfig(**disc), variables=variables).discover_batch(worlds)
    got_disc = ObjectDiscoveryEngine(*fns, ReasoningConfig(**disc), device="cpu").discover_batch(worlds)
    for g, w in zip(got_disc, want_disc):
        assert g["stats"] == w["stats"]
        assert g["converged_boxes"].shape == np.asarray(w["converged_boxes"]).shape
        np.testing.assert_allclose(g["converged_boxes"], np.asarray(w["converged_boxes"]), atol=1e-3)
    boxes = [d["converged_boxes"] for d in got_disc]
    assert sum(len(b) for b in boxes) > 0

    score = dict(crop_size=32, canvas_size=96, image_batch=2, slot_multiple=16, crop_chunk=8)
    want = JaxScoring(jax_obj, jax_cls, JaxScoringConfig(**score), variables=variables).score_batch(worlds, boxes,
                                                                                                   [1, 2])
    got = ObjectScoringEngine(*fns, ScoringConfig(**score), device="cpu").score_batch(worlds, boxes, [1, 2])
    for g, w in zip(got, want):
        assert_same_annotations(g, w, rtol=1e-4)


# -------------------------------------------------------------- the CLIs
def test_config_round_trip_in_both_packages(tmp_path):
    cfg = TrainObjectnessConfig(model=ModelConfig(backbone_type="dpt_hybrid"), batch_size=7)
    save_config(cfg, str(tmp_path / "cfg.json"))
    for loaded in (load_config(TrainObjectnessConfig, str(tmp_path / "cfg.json")),
                   jax_load_config(JaxTrainConfig, str(tmp_path / "cfg.json"))):
        assert loaded.model.backbone_type == "dpt_hybrid" and loaded.batch_size == 7
        assert loaded.optim.learning_rate == cfg.optim.learning_rate
        assert list(loaded.optim.lr_scheduler_milestones) == list(cfg.optim.lr_scheduler_milestones)


@pytest.mark.parametrize("cli", [object_reasoning, object_scoring])
def test_stage2_clis_build_the_full_width_hybrid(cli):
    argv = ["--backbone_type", "dpt_hybrid", "--sdf_activation", "tanh", "--use_bg_sdf", "--coco_image_dir", "i",
            "--coco_annotations", "a.json"]
    if cli is object_scoring:
        argv += ["--raw_annotations_path", "r/discovery_results.json"]
    args = cli.parse_args(argv)
    assert args.backbone_type == "dpt_hybrid"
    model = common.build_objectness(args, "bfloat16", device="meta")
    assert isinstance(model.backbone.pretrained.model, HybridViTBackbone) and not model.training
    assert sum(p.numel() for p in model.parameters()) == 128_080_963
    trunk = model.get_submodule(TRUNK_NAME)
    assert [len(s.blocks) for s in trunk.stages] == [3, 4, 9] and trunk.stem.norm.num_groups == 32
    kernels = {m.weight.dtype for m in model.modules() if isinstance(m, StdConv2dSame)}
    assert kernels == {torch.float32} and model.sdf_prediction_head[0].weight.dtype == torch.bfloat16
    with pytest.raises(SystemExit):
        cli.parse_args(["--backbone_type", "dpt_huge"] + argv[2:])
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with torch.device("meta"), pytest.raises(RuntimeError, match="device='cpu'"):
            common.build_objectness(args)


def test_training_cli_trains_and_checkpoints_the_hybrid(world, tmp_path, monkeypatch):
    built = []

    def tiny(a):
        built.append(a.backbone_type)
        return ObjectnessNet(a.backbone_type, a.sdf_activation, a.use_bg_sdf, remat_vit=a.remat_vit,
                             vit_config=ViTConfig(**VIT), hybrid_resnet_kwargs=TRUNK, **DPT)

    with torch.device("meta"):  # build_objectness_model itself, at full width
        full = train_cli.build_objectness_model(train_cli.parse_args(["--backbone_type", "dpt_hybrid", "--remat_vit"]))
    assert isinstance(full.backbone.pretrained.model, HybridViTBackbone)
    monkeypatch.setattr(train_cli, "build_objectness_model", tiny)
    args = write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    train_cli.main(args + OBJECTNESS + ["--backbone_type", "dpt_hybrid", "--remat_vit", "--train_iter", "2",
                                        "--save_ckpt_every", "2", "--log_every", "1", "--visualize_every", "100"])
    assert built == ["dpt_hybrid"]
    (run,) = (tmp_path / "results_objectness" / "center_and_boundary").iterdir()
    assert run.name.endswith("_dpt_hybrid")
    assert json.loads((run / "configs.json").read_text())["backbone_type"] == "dpt_hybrid"
    ckpt = str(run / "ckpt" / "iter_2_model.ckpt")

    # the JAX package's stage-2 loader reads the flax tree of its dpt_hybrid
    # ObjectnessNet, and both packages' models compute the same function
    params = jax_common.load_objectness_params(ckpt)
    shapes = jax.eval_shape(lambda: flax_net().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(shapes)
    want = jax.device_get(jax_reference(params, world["fixture_params"], world["x64"], world["x96"]))["tanh64"]
    model = port_net()
    common.load_objectness_weights(model, ckpt)
    with torch.no_grad():
        got = model(torch.from_numpy(world["x64"]))
    for key in ("sdf_maps", "center_fields"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=0, err_msg=key)


@pytest.mark.slow
def test_full_width_bf16_lies_as_far_from_f32_as_the_jax_packages():
    """The full-width hybrid (unit norm scales, zero biases, kernels ~
    N(0, 1/fan_in)) on two 128^2 crops: each package's bf16 forward against
    its own f32 forward. Both lie tens of percent away (measured rel L2 on
    the SDF: port 0.321, JAX 0.312); the port's must be within 1.5 times the
    JAX package's. ~40 s on the CPU."""
    fmodel = FlaxObjectnessNet(backbone_type="dpt_hybrid", precision=HIGH)
    shapes = jax.eval_shape(lambda: fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))["params"]
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("pos_embed", "cls_token"):
            return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        return np.full(leaf.shape, 1.0 if name == "scale" else 0.0, np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    x = np.random.RandomState(1).rand(2, 128, 128, 3).astype(np.float32)
    f32 = jax.device_get(jax.jit(lambda p, x: fmodel.apply({"params": p}, x))(params, x))
    bf16 = jax.device_get(jax.jit(lambda p, x: FlaxObjectnessNet(backbone_type="dpt_hybrid", dtype=jnp.bfloat16)
                                  .apply({"params": p}, x))(params, x))
    model = ObjectnessNet("dpt_hybrid")
    load_objectness_state_dict(model, objectness_state_dict_from_flax(params))
    with torch.no_grad():
        got = model.eval().to(torch.bfloat16)(torch.from_numpy(x))
    for key in ("sdf_maps", "center_fields"):
        ours, theirs = rel_l2(got[key], f32[key]), rel_l2(bf16[key], f32[key])
        assert ours <= 1.5 * theirs, (key, ours, theirs)
