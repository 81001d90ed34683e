"""The port's CAD detector against the JAX package, module by module, in f32.

The JAX reference is one tiny Cascade Mask R-CNN (canvas 64, trunk blocks
(1, 1, 1, 1), RPN top-k 32, 8 detections; ``tests/test_cad_cli.py``'s tiny
config) whose intermediates come out of one jitted function, built once per
file; its parameters and BatchNorm statistics reach the port through
``detector/convert.py``. Tolerances: anchors exact; box ops 1e-6; FPN
features 2e-4 (as ``tests/test_model_parity.py``); proposals the same valid
set with boxes within 1e-3; RoIAlign (fixed 2x2 and adaptive) 1e-5; both
heads 2e-4; the whole inference the same valid detections, boxes within
1e-3, scores and masks within 1e-4.
"""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from unmore_tpu.detector import anchors as jax_anchors
from unmore_tpu.detector import box_ops as jax_box_ops
from unmore_tpu.detector.cascade_rcnn import CascadeMaskRCNN as JaxDetector
from unmore_tpu.detector.cascade_rcnn import DetectorConfig as JaxConfig
from unmore_tpu.detector.cascade_rcnn import _normalize as jax_normalize
from unmore_tpu.detector.cascade_rcnn import detector_forward_inference as jax_inference
from unmore_tpu.detector.cascade_rcnn import detector_forward_with_boxes as jax_with_boxes
from unmore_tpu.detector.convert_d2 import convert_d2_detector_state_dict
from unmore_tpu.detector.evaluation import DetectorEvaluator as JaxEvaluator
from unmore_tpu.detector.roi_align import roi_align_fpn as jax_roi_align_fpn
from unmore_tpu.detector.rpn import generate_proposals as jax_generate_proposals
from unmore_tpu.ops.nms import nms_mask as jax_nms
from unmore_tpu_torch.detector import anchors, box_ops, config_yaml, convert
from unmore_tpu_torch.detector.cascade_rcnn import (
    CascadeMaskRCNN, DetectorConfig, detector_forward_inference, detector_forward_with_boxes, level_anchors, normalize,
)
from unmore_tpu_torch.detector.evaluation import DetectorEvaluator
from unmore_tpu_torch.detector.fpn import LEVELS
from unmore_tpu_torch.detector.roi_align import RoIFeatures
from unmore_tpu_torch.detector.rpn import generate_proposals
from unmore_tpu_torch.ops.nms import nms_mask

TINY = dict(image_size=64, rpn_pre_nms_topk_test=32, rpn_post_nms_topk_test=32,
            detections_per_image=8, stage_blocks=(1, 1, 1, 1))
ROI = ("P2", "P3", "P4", "P5")
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "cad", "configs")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _boxes(rng, n, lo, hi, size):
    xy = rng.rand(n, 2).astype(np.float32) * size
    wh = rng.rand(n, 2).astype(np.float32) * (hi - lo) + lo
    return np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """The JAX detector, its converted port twin, inputs, and every JAX
    intermediate from one jit."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    jmodel = JaxDetector(jcfg)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3)), method=JaxDetector.init_all))(
        jax.random.PRNGKey(0))
    # non-trivial BatchNorm statistics, so that the conversion of both shows
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(lambda x: rng.uniform(-0.1, 0.1, x.shape).astype(np.float32),
                                   _np(variables["batch_stats"]))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: np.abs(x) * 5 + 0.5 if p[-1].key == "var" else x, stats)
    variables = {"params": _np(variables["params"]), "batch_stats": stats}

    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
    hw = np.array([[64, 64], [48, 60]], np.float32)
    roi_boxes = np.stack([_boxes(rng, 24, 4, 90, 64) for _ in range(2)])  # spans P2-P5, some off the canvas
    given = np.stack([_boxes(rng, 5, 8, 40, 64) for _ in range(2)])
    pooled7 = rng.randn(6, 7, 7, 256).astype(np.float32)
    pooled14 = rng.randn(3, 14, 14, 256).astype(np.float32)
    # unit-scale maps for RoIAlign (the model's own run to ~10, where 1e-5 is an ulp)
    roi_maps = {n: rng.rand(2, 64 // s, 64 // s, 16).astype(np.float32) for n, s in zip(ROI, (4, 8, 16, 32))}

    def everything(v, images, hw, roi_boxes, given, pooled7, pooled14, roi_maps):
        x = jax_normalize(images)
        feats, rpn_out = jmodel.apply(v, x)
        anchors_l = [jnp.asarray(a) for a in jax_anchors.fpn_anchors(64)]
        props = jax.vmap(lambda o, d, s: jax_generate_proposals(anchors_l, o, d, s, 32, 32, 0.65))(
            [rpn_out[n]["objectness"] for n in LEVELS], [rpn_out[n]["deltas"] for n in LEVELS], hw)
        pooled = {str(s): jax.vmap(lambda f, b, s=s: jax_roi_align_fpn(f, b, 7, sampling=s))(roi_maps, roi_boxes)
                  for s in (2, "adaptive")}
        heads = [jmodel.apply(v, pooled7, k, method=JaxDetector.run_box_head) for k in range(3)]
        mask = jmodel.apply(v, pooled14, method=JaxDetector.run_mask_head)
        valid = jnp.asarray([[True] * 4 + [False], [True] * 5])
        return {
            "normalized": x, "feats": feats, "rpn": rpn_out, "proposals": props, "pooled": pooled,
            "heads": heads, "mask": mask, "inference": jax_inference(jmodel, v, jcfg, images, hw),
            "with_boxes": jax_with_boxes(jmodel, v, jcfg, images, hw, given, valid),
        }

    want = _np(jax.jit(everything)(variables, images, hw, roi_boxes, given, pooled7, pooled14, roi_maps))
    model = CascadeMaskRCNN(DetectorConfig(**TINY)).eval()
    model.load_state_dict(convert.state_dict_from_flax(variables), strict=True)
    return dict(jmodel=jmodel, jcfg=jcfg, variables=variables, model=model, images=images, hw=hw,
                roi_boxes=roi_boxes, given=given, pooled7=pooled7, pooled14=pooled14, roi_maps=roi_maps, want=want)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_anchors_are_the_jax_packages():
    for size in (64, 1024, 100):
        for a, b in zip(anchors.fpn_anchors(size), jax_anchors.fpn_anchors(size)):
            np.testing.assert_array_equal(a, b)


def test_box_ops_match():
    rng = np.random.RandomState(0)
    src, tgt = _boxes(rng, 50, 2, 60, 80), _boxes(rng, 50, 2, 60, 80)
    deltas = rng.randn(50, 4).astype(np.float32) * 3  # some beyond the scale clamp
    hw = np.array([64.0, 70.0], np.float32)
    np.testing.assert_allclose(box_ops.pairwise_iou_xyxy(_t(src), _t(tgt)).numpy(),
                               jax_box_ops.pairwise_iou_xyxy(src, tgt), atol=1e-6)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0), (30.0, 30.0, 15.0, 15.0)):
        np.testing.assert_allclose(box_ops.encode_deltas(_t(src), _t(tgt), w).numpy(),
                                   jax_box_ops.encode_deltas(src, tgt, w), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(box_ops.decode_deltas(_t(deltas), _t(src), w).numpy(),
                                   jax_box_ops.decode_deltas(deltas, src, w), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(box_ops.clip_boxes(_t(src), _t(hw)).numpy(), jax_box_ops.clip_boxes(src, hw))


def test_fpn_features_match(world):
    x = normalize(_t(world["images"]))
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), world["want"]["normalized"], atol=1e-6)
    with torch.inference_mode():
        feats, rpn = world["model"](x)
    for n in LEVELS:
        np.testing.assert_allclose(feats[n].permute(0, 2, 3, 1).numpy(), world["want"]["feats"][n], atol=2e-4)
        for k in ("objectness", "deltas"):
            np.testing.assert_allclose(rpn[n][k].numpy(), world["want"]["rpn"][n][k], atol=2e-4)


def test_fpn_crops_the_top_down_path_at_odd_sizes(world):
    """At 60x44 the pyramid's sizes are odd (15x11, 8x6, 4x3, 2x2, 1x1): the
    2x repeat is cropped to each lateral."""
    x = np.random.RandomState(5).randn(1, 60, 44, 3).astype(np.float32)
    want = _np(jax.jit(lambda v, x: world["jmodel"].apply(v, x)[0])(world["variables"], x))
    with torch.inference_mode():
        got = world["model"].backbone(_t(x).permute(0, 3, 1, 2))
    for n in LEVELS:
        np.testing.assert_allclose(got[n].permute(0, 2, 3, 1).numpy(), want[n], atol=2e-4)


def test_generate_proposals_match(world):
    want_boxes, want_scores, want_valid = world["want"]["proposals"]
    rpn = world["want"]["rpn"]
    got_boxes, got_scores, got_valid = generate_proposals(
        level_anchors(64, torch.device("cpu")), [_t(rpn[n]["objectness"]) for n in LEVELS],
        [_t(rpn[n]["deltas"]) for n in LEVELS], _t(world["hw"]), 32, 32, 0.65)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert want_valid.sum() > 8
    np.testing.assert_allclose(got_boxes.numpy()[want_valid], want_boxes[want_valid], atol=1e-3)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, atol=1e-6)


@pytest.mark.parametrize("sampling", [2, "adaptive"])
def test_roi_align_matches(world, sampling):
    maps = {n: _t(m) for n, m in world["roi_maps"].items()}
    got = RoIFeatures(maps).pool(_t(world["roi_boxes"]), 7, sampling)
    np.testing.assert_allclose(got.numpy(), world["want"]["pooled"][str(sampling)], atol=1e-5)


def test_heads_match(world):
    with torch.inference_mode():
        for k, head in enumerate(world["model"].box_heads):
            scores, deltas = head(_t(world["pooled7"]))
            np.testing.assert_allclose(scores.numpy(), world["want"]["heads"][k][0], atol=2e-4)
            np.testing.assert_allclose(deltas.numpy(), world["want"]["heads"][k][1], atol=2e-4)
        got = world["model"].mask_head(_t(world["pooled14"]))
    np.testing.assert_allclose(got.numpy(), world["want"]["mask"], atol=2e-4)


def _same_detections(got, want):
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() >= 4
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid], atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-4)
    np.testing.assert_allclose(got["masks"].numpy()[valid], want["masks"][valid], atol=1e-4)


def test_detector_forward_inference_matches(world):
    got = detector_forward_inference(world["model"], world["model"].cfg, _t(world["images"]), _t(world["hw"]))
    _same_detections(got, world["want"]["inference"])


def test_detector_forward_with_boxes_matches(world):
    valid = torch.tensor([[True] * 4 + [False], [True] * 5])
    got = detector_forward_with_boxes(world["model"], world["model"].cfg, _t(world["images"]), _t(world["hw"]),
                                      _t(world["given"]), valid)
    _same_detections(got, world["want"]["with_boxes"])


def test_predict_batch_mixed_sizes_matches_single(world):
    """A batch of two images of other sizes (so that both are resized) gives
    what two single calls give, and what the JAX evaluator gives."""
    ev = DetectorEvaluator(world["model"], world["model"].cfg, min_size_test=48, device="cpu")
    rng = np.random.RandomState(3)
    img_a = (rng.rand(40, 60, 3) * 255).astype(np.uint8)
    img_b = (rng.rand(64, 32, 3) * 255).astype(np.uint8)
    batched = ev.predict_batch([img_a, img_b], [101, 202])
    singles = ev.predict_image(img_a, 101) + ev.predict_image(img_b, 202)
    jax_ev = JaxEvaluator(world["jmodel"], world["variables"], world["jcfg"], min_size_test=48)
    jax_batched = jax_ev.predict_batch([img_a, img_b], [101, 202])
    assert len(batched) == len(singles) == len(jax_batched) > 4
    for got, single, want in zip(batched, singles, jax_batched):
        assert got["image_id"] == single["image_id"] == want["image_id"]
        np.testing.assert_allclose(got["bbox"], single["bbox"], atol=1e-3)
        np.testing.assert_allclose(got["score"], single["score"], atol=1e-5)
        np.testing.assert_allclose(got["bbox"], want["bbox"], atol=1e-2)
        np.testing.assert_allclose(got["score"], want["score"], atol=1e-4)


def test_batched_nms_equals_row_by_row_calls():
    rng = np.random.RandomState(0)
    L, N = 5, 60
    boxes = np.stack([_boxes(rng, N, 4, 30, 50) for _ in range(L)])
    scores = np.round(rng.rand(L, N), 1).astype(np.float32)  # ties
    valid = rng.rand(L, N) > 0.2
    got = nms_mask(_t(boxes), _t(scores), _t(valid), 0.5)
    for i in range(L):
        np.testing.assert_array_equal(got[i].numpy(), nms_mask(_t(boxes[i]), _t(scores[i]), _t(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jax_nms(boxes[i], scores[i], valid[i], 0.5)))


def test_flax_conversion_round_trips(world):
    back = convert.flax_from_state_dict(world["model"].state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(world["variables"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(world["variables"])):
        np.testing.assert_array_equal(a, b)


def test_d2_conversion_matches_the_jax_converter(world):
    """A detectron2-named state dict (shapes from the model, random values)
    gives through the port's converter the state dict that the JAX converter
    followed by the flax conversion gives."""
    from tests.test_convert_d2 import _synth_d2_sd

    sd = _synth_d2_sd(world["variables"]["params"], world["variables"]["batch_stats"])
    got = convert.d2_to_state_dict(sd)
    want = convert.state_dict_from_flax(convert_d2_detector_state_dict(sd))
    assert got.keys() == want.keys() == world["model"].state_dict().keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    trunk_only = {k: v for k, v in sd.items() if k.startswith("backbone.bottom_up")}
    assert set(convert.d2_to_state_dict(trunk_only)) == {k for k in want if k.startswith("backbone.trunk")}


@pytest.mark.parametrize("name", ["Base-RCNN-FPN.yaml", "cascade_mask_rcnn_R_50_FPN.yaml", "tiny"])
def test_yaml_reader_equals_pyyaml(name, tmp_path):
    from tests.test_cad_cli import TINY_YAML

    text = TINY_YAML.format(max_iter=4, eval_period=2, out_dir=str(tmp_path / "o")) if name == "tiny" \
        else open(os.path.join(CONFIGS, name)).read()
    assert config_yaml.parse_yaml(text) == yaml.safe_load(text)
    cfg = config_yaml.load_yacs_config(os.path.join(CONFIGS, "cascade_mask_rcnn_R_50_FPN.yaml"))
    config_yaml.apply_opts(cfg, ["MODEL.WEIGHTS", "x.ckpt", "SOLVER.BASE_LR", "0.01", "TEST.EXPECTED_RESULTS",
                                 "[['bbox', 'AP', 50.0, 50.0]]", "X.Y", "1e-5"])
    assert config_yaml.get(cfg, "TEST.EXPECTED_RESULTS") == [["bbox", "AP", 50.0, 50.0]]
    assert config_yaml.get(cfg, "X.Y") == "1e-5" and config_yaml.get(cfg, "SOLVER.WEIGHT_DECAY") == 5e-5
    assert yaml.safe_load(config_yaml.dump_yaml(cfg)) == cfg
