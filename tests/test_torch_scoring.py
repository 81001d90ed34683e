"""The port's stage-2 scoring against the JAX package's.

* Analytic worlds (``tests/test_reasoning_engine.py``) through both scoring
  engines with the bit-identical fakes of ``tests/test_torch_engine.py``:
  annotation lists equal, ``image_id``, ``bbox`` and ``segmentation``
  exactly, every score to rtol 1e-6 (the fakes' SDF blur ends in a division
  that XLA turns into a multiply by the reciprocal, one ulp off).
* The slice as a whole: discovery, then scoring of its converged boxes,
  through both packages with tiny real models whose weights are carried
  across by ``*_state_dict_from_flax``; f32, ``Precision.HIGHEST`` on the
  JAX side. Equal counts and boxes, scores to rtol 1e-4.
* The host library ``csrc/paste.cpp`` against the JAX package's C++ library
  and the port's plain versions, on boxes that cross every image edge.
* Both CLIs on the ``coco`` fixture of ``tests/test_torch_cli.py`` with the
  JAX CLIs beside them, weights from msgpack checkpoints written by the JAX
  package; the scoring rerun resumes; ``post_process.py`` takes the output.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unmore_tpu import native
from unmore_tpu.cli import common as jax_common
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.reasoning.engine import ObjectDiscoveryEngine as JaxDiscovery
from unmore_tpu.reasoning.engine import ReasoningConfig as JaxReasoningConfig
from unmore_tpu.reasoning.scoring import ObjectScoringEngine as JaxScoring
from unmore_tpu.reasoning.scoring import ScoringConfig as JaxScoringConfig
from unmore_tpu.train.checkpoints import save_checkpoint
from unmore_tpu_torch.cli import common, object_reasoning, object_scoring
from unmore_tpu_torch.cli.common import make_apply_fns
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.ops import paste
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig
from unmore_tpu_torch.utils import rle
from tests.test_reasoning_engine import make_world
from tests.test_torch_cli import coco  # noqa: F401  (the fixture)
from tests.test_torch_engine import jax_classifier, jax_objectness, torch_classifier, torch_objectness
from tests.test_torch_models import HIGH, TINY, TINY_DPT, _perturb, flax_objectness_params, port_objectness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSCORES = ("existence_score", "center_score", "boundary_score", "area_score")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_annotations(got, want, rtol):
    """Equal lists: ids, categories, boxes and RLEs exactly, scores to rtol."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("image_id", "category_id", "bbox", "segmentation"):
            assert g[key] == w[key], (key, g[key], w[key])
        for key in ("score", *SUBSCORES):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=0, err_msg=key)


# ------------------------------------------------------------ analytic worlds
GT_A, GT_B = (60, 70, 140, 150), (30, 40, 100, 120)
BOXES_A = np.array([[55, 65, 145, 155], [60, 70, 140, 150], [0, 0, 40, 40]], np.float32)
BOXES_B = np.array([[25, 35, 105, 125], [-10, -5, 60, 50], [150, 160, 230, 215]], np.float32)
EMPTY = np.zeros((0, 4), np.float32)
WORLD_CASES = {
    "single": ([[GT_A]], [BOXES_A], 1),
    "two_images_batched": ([[GT_A], [GT_B, (120, 20, 190, 90)]], [BOXES_A, BOXES_B], 2),
    "empty_boxes": ([[GT_A]], [EMPTY], 1),
    "mixed_empty_and_boxes": ([[GT_A], [GT_B]], [EMPTY, BOXES_B], 2),
    "uint8_wire": ([[GT_A], [GT_B]], [BOXES_A, BOXES_B], 2),
}


@pytest.mark.parametrize("case", sorted(WORLD_CASES))
def test_scoring_matches_jax_on_analytic_worlds(case):
    objects, boxes, image_batch = WORLD_CASES[case]
    worlds = [make_world(200, objs) for objs in objects]
    if case == "uint8_wire":
        worlds = [np.clip(w * 255.0 + 0.5, 0, 255).astype(np.uint8) for w in worlds]
    kw = dict(canvas_size=200, slot_multiple=8, crop_chunk=8, image_batch=image_batch)
    ids = [7 + g for g in range(len(worlds))]
    want = JaxScoring(jax_objectness, jax_classifier, JaxScoringConfig(**kw)).score_batch(worlds, boxes, ids)
    port = ObjectScoringEngine(torch_objectness, torch_classifier, ScoringConfig(**kw), device="cpu")
    got = port.score_batch(worlds, boxes, ids)
    assert len(got) == len(want) == len(worlds)
    for g, w in zip(got, want):
        assert_same_annotations(g, w, rtol=1e-6)
    if case != "empty_boxes":
        assert sum(len(a) for a in got) > 0
        assert set(port.last_timings) == {"device_s", "host_s"}
    if case == "mixed_empty_and_boxes":
        assert got[0] == []


def test_batched_scoring_equals_per_image_scoring():
    worlds = [make_world(200, [GT_A]), make_world(200, [GT_B])]
    port = ObjectScoringEngine(torch_objectness, torch_classifier,
                               ScoringConfig(canvas_size=200, slot_multiple=8, crop_chunk=8, image_batch=2),
                               device="cpu")
    batched = port.score_batch(worlds, [BOXES_A, BOXES_B], [1, 2])
    for g, (world, boxes) in enumerate(zip(worlds, [BOXES_A, BOXES_B])):
        assert_same_annotations(batched[g], port.score_image(world, boxes, g + 1), rtol=0)
    best = max(batched[0], key=lambda a: a["score"])
    x, y, w, h = best["bbox"]
    assert abs(x - GT_A[0]) <= 3 and abs(x + w - GT_A[2]) <= 3
    mask = rle.decode(best["segmentation"])
    assert mask.shape == (200, 200) and mask[GT_A[1] + 5 : GT_A[3] - 5, GT_A[0] + 5 : GT_A[2] - 5].mean() > 0.9
    assert rle.area(best["segmentation"]) == int(mask.sum())
    assert rle.to_bbox(best["segmentation"]) == best["bbox"]


def test_scoring_refuses_more_images_than_slots_and_oversized_images():
    port = ObjectScoringEngine(torch_objectness, torch_classifier, ScoringConfig(canvas_size=64, image_batch=1),
                               device="cpu")
    with pytest.raises(ValueError, match="image_slots"):
        port.score_batch([np.zeros((8, 8, 3), np.float32)] * 2, [EMPTY, EMPTY], [1, 2])
    with pytest.raises(ValueError, match="exceeds canvas"):
        port.score_batch([np.zeros((80, 8, 3), np.float32)], [BOXES_A], [1])


# ------------------------------------------------------ the slice as a whole
def test_slice_discovery_then_scoring_matches_jax():
    fobj, obj_params = flax_objectness_params(seed=7)
    fcls = FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    cls_vars = jax.device_get(
        jax.jit(lambda k: fcls.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(8))
    )
    cls_vars = {"params": _perturb(cls_vars["params"], 9), "batch_stats": cls_vars["batch_stats"]}
    variables = {"objectness": obj_params, "classifier": cls_vars}

    def jax_obj(variables, crops, compute_center=True):
        return fobj.apply({"params": variables["objectness"]}, crops)

    def jax_cls(variables, crops):
        return fcls.apply(variables["classifier"], crops)[:, 0]

    classifier = BinaryClassifier(stage_blocks=(1, 1, 1, 1)).eval()
    classifier.load_state_dict(classifier_state_dict_from_flax(cls_vars), strict=True)
    fns = make_apply_fns(port_objectness(obj_params), classifier)

    disc = dict(crop_size=32, canvas_size=96, image_batch=2, max_proposals=64, max_splits=64, max_active=64,
                crop_chunk=16, crop_chunk_tail=8, exist_chunk=64, n_round=5, analyze_cc=True)
    worlds = [make_world(96, [(10, 12, 50, 60), (50, 30, 90, 80)]), make_world(96, [(20, 20, 70, 70)])]
    worlds = [np.clip(w * 255.0 + 0.5, 0, 255).astype(np.uint8) for w in worlds]
    want_disc = JaxDiscovery(jax_obj, jax_cls, JaxReasoningConfig(**disc), variables=variables).discover_batch(worlds)
    got_disc = ObjectDiscoveryEngine(*fns, ReasoningConfig(**disc), device="cpu").discover_batch(worlds)

    score = dict(crop_size=32, canvas_size=96, image_batch=2, slot_multiple=16, crop_chunk=8)
    want_boxes = [np.asarray(d["converged_boxes"]) for d in want_disc]
    got_boxes = [d["converged_boxes"] for d in got_disc]
    for g, w in zip(got_boxes, want_boxes):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, atol=1e-3)
    want = JaxScoring(jax_obj, jax_cls, JaxScoringConfig(**score), variables=variables).score_batch(
        worlds, want_boxes, [1, 2])
    got = ObjectScoringEngine(*fns, ScoringConfig(**score), device="cpu").score_batch(worlds, got_boxes, [1, 2])
    for g, w in zip(got, want):
        assert len(g) > 0
        assert_same_annotations(g, w, rtol=1e-4)


# --------------------------------------------------------- the host library
@pytest.mark.parametrize("seed,s", [(0, 8), (1, 16), (2, 32)])
def test_paste_library_matches_jax_native_and_plain(seed, s):
    rng = np.random.RandomState(seed)
    h, w = 50 + 7 * seed, 70 - 5 * seed
    masks = (rng.rand(16, s, s) > 0.6).astype(np.uint8)
    masks[0] = 0  # an empty mask
    masks[4] = 1  # a full one, on the box that covers the image
    # boxes across every edge, inside, fractional, sub-pixel and off the image
    boxes = np.array([
        [-12.3, 5.5, 20.2, 30.0], [10, -8.7, 40.1, 22.9], [w - 15.5, 10, w + 9.2, 35], [5, h - 12.2, 33, h + 20],
        [-5, -5, w + 5, h + 5], [3.2, 4.7, 3.9, 5.1], [w + 2, 3, w + 30, 20], [2, 2, 2, 30],
    ] + [list(xy) + list(xy + wh) for xy, wh in zip(rng.uniform(-20, 60, (8, 2)), rng.uniform(0.5, 60, (8, 2)))],
        np.float32)
    tight, areas = paste.paste_stats(masks, boxes, h, w)
    for other in (native.paste_stats(masks, boxes, h, w), paste.paste_stats_plain(masks, boxes, h, w)):
        np.testing.assert_array_equal(tight, other[0])
        np.testing.assert_array_equal(areas, other[1])
    assert (areas[[0, 6, 7]] == 0).all() and areas[4] == h * w
    for b in range(len(masks)):
        enc = paste.paste_rle(masks[b], boxes[b], h, w)
        assert enc == native.paste_rle(masks[b], boxes[b], h, w) == paste.paste_rle_plain(masks[b], boxes[b], h, w)
        assert rle.area(enc) == areas[b]
        x, y, bw, bh = rle.to_bbox(enc)
        assert [x, y, x + bw, y + bh] == tight[b].tolist()


def test_rle_codec_matches_the_jax_package():
    from unmore_tpu.utils import rle as jax_rle

    rng = np.random.RandomState(3)
    for shape in ((1, 1), (7, 5), (40, 33)):
        mask = (rng.rand(*shape) > 0.5).astype(np.uint8)
        enc = rle.encode(mask)
        assert enc == jax_rle.encode(mask) == native.encode(mask)
        np.testing.assert_array_equal(rle.decode(enc), mask)
        assert rle.area(enc) == jax_rle.area(enc) and rle.to_bbox(enc) == jax_rle.to_bbox(enc)
        np.testing.assert_array_equal(rle.decode_counts(enc["counts"]), rle.mask_to_runs(mask))
    assert rle.to_bbox(rle.encode(np.zeros((4, 4), np.uint8))) == [0.0, 0.0, 0.0, 0.0]


def test_paste_rejects_unpaired_inputs():
    with pytest.raises(ValueError, match="pair up"):
        paste.paste_stats(np.zeros((2, 4, 4), np.uint8), np.zeros((3, 4), np.float32), 8, 8)
    with pytest.raises(ValueError, match=r"\[s, s\]"):
        paste.paste_rle(np.zeros((2, 4, 4), np.uint8), np.zeros(4, np.float32), 8, 8)


# ------------------------------------------------------------------ the CLIs
def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tiny_objectness(args_like, dtype="bfloat16"):
    return FlaxObjectnessNet(backbone_type="dpt_base", sdf_activation=args_like.sdf_activation,
                             use_bg_sdf=args_like.use_bg_sdf, vit_config=FlaxViTConfig(**TINY), precision=HIGH,
                             dtype=jax_common.DTYPES[dtype], **TINY_DPT)


def jax_tiny_classifier(dtype="bfloat16"):
    return FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH, dtype=jax_common.DTYPES[dtype])


def port_tiny_objectness(args_like, dtype="bfloat16", device=None):
    model = ObjectnessNet("dpt_base", args_like.sdf_activation, args_like.use_bg_sdf,
                          vit_config=ViTConfig(**TINY), **TINY_DPT)
    return model.to(common.resolve_device(device), common.DTYPES[dtype]).eval()


def port_tiny_classifier(dtype="bfloat16", device=None):
    return BinaryClassifier(stage_blocks=(1, 1, 1, 1)).to(common.resolve_device(device), common.DTYPES[dtype]).eval()


def write_msgpack_checkpoints(folder):
    """Trainer-state-like msgpack files of the tiny models, written by the
    JAX package: objectness {params, opt_state, step}; classifier {params,
    batch_stats, step}."""
    _, obj_params = flax_objectness_params(seed=11)
    fcls = jax_tiny_classifier("float32")
    cls_vars = jax.device_get(
        jax.jit(lambda k: fcls.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(12))
    )
    obj_path, cls_path = str(folder / "objectness.ckpt"), str(folder / "classifier.ckpt")
    save_checkpoint(obj_path, {"params": obj_params, "opt_state": {"count": np.int32(4)}, "step": 40})
    save_checkpoint(cls_path, {"params": _perturb(cls_vars["params"], 13), "batch_stats": cls_vars["batch_stats"],
                               "step": 40})
    return obj_path, cls_path


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(jax_common, "build_objectness", jax_tiny_objectness)
    monkeypatch.setattr(jax_common, "build_classifier", jax_tiny_classifier)
    monkeypatch.setattr(common, "build_objectness", port_tiny_objectness)
    monkeypatch.setattr(common, "build_classifier", port_tiny_classifier)


MODEL_ARGS = ["--dtype", "float32", "--sdf_activation", "tanh", "--use_bg_sdf", "--image_size", "32",
              "--canvas_size", "96"]
DISCOVERY_ARGS = MODEL_ARGS + ["--analyze_cc", "--max_proposals", "64", "--max_splits", "64", "--max_active", "64",
                               "--crop_chunk", "32", "--crop_chunk_tail", "16", "--exist_chunk", "64",
                               "--n_round", "2", "--class_score_thres", "0"]
SCORING_ARGS = MODEL_ARGS + ["--crop_chunk", "8", "--image_batch", "2"]


def seeded_discovery_json(folder, seed=0):
    """Boxes for two of the fixture's three images (the third is not
    scored), some across the image edges."""
    rng = np.random.RandomState(seed)
    boxes = {}
    for image_id, (h, w) in ((10, (64, 96)), (12, (48, 64))):
        xy = rng.uniform(-8, [w - 10, h - 10], (5, 2))
        boxes[str(image_id)] = np.concatenate([xy, xy + rng.uniform(8, 50, (5, 2))], 1).round(2).tolist()
    folder.mkdir(parents=True)
    with open(folder / "discovery_results.json", "w") as f:
        json.dump(boxes, f)
    return str(folder / "discovery_results.json")


def test_discovery_cli_matches_the_jax_cli(coco, tiny_models, monkeypatch):  # noqa: F811
    monkeypatch.chdir(coco)
    obj, cls = write_msgpack_checkpoints(coco)
    argv = ["--coco_image_dir", "images", "--coco_annotations", "instances.json", *DISCOVERY_ARGS,
            "--objectness_resume", obj, "--binary_classifier_resume", cls]
    _load_script("object_reasoning").main(argv + ["--run_name", "jax"])
    object_reasoning.main(argv + ["--device", "cpu", "--run_name", "port"])
    out = coco / "results_reasoning"
    got = json.loads((out / "port" / "discovery_results.json").read_text())
    want = json.loads((out / "jax" / "discovery_results.json").read_text())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    port_lines = (out / "port" / "partial_results_p0.jsonl").read_text().splitlines()
    jax_lines = (out / "jax" / "partial_results_p0.jsonl").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == 4


def test_scoring_cli_matches_the_jax_cli_resumes_and_feeds_post_process(coco, tiny_models, monkeypatch, capsys):  # noqa: F811
    monkeypatch.chdir(coco)
    obj, cls = write_msgpack_checkpoints(coco)
    runs = {name: seeded_discovery_json(coco / "results_reasoning" / name) for name in ("jax", "port")}
    base = ["--coco_image_dir", "images", "--coco_annotations", "instances.json", *SCORING_ARGS,
            "--objectness_resume", obj, "--binary_classifier_resume", cls,
            # flags of the TPU build: accepted and ignored
            "--vit_pack", "2", "--gpu_index", "1", "--busy_hang_timeout_min", "1"]
    # the JAX CLI over two of its CPU devices, the port on one rank: results do not depend on the count
    _load_script("object_scoring").main(base + ["--devices", "2", "--raw_annotations_path", runs["jax"]])
    argv = base + ["--devices", "1", "--device", "cpu", "--raw_annotations_path", runs["port"]]
    object_scoring.main(argv)
    assert "timing split: device" in capsys.readouterr().out
    port_dir = coco / "results_reasoning" / "port"
    got = json.loads((port_dir / "object_discovery_with_scores.json").read_text())
    want = json.loads((coco / "results_reasoning" / "jax" / "object_discovery_with_scores.json").read_text())
    assert {a["image_id"] for a in got} <= {10, 12} and len(got) > 0
    assert_same_annotations(got, want, rtol=1e-4)
    assert sorted(os.listdir(port_dir)) == [
        "configs_object_scoring.json", "discovery_results.json", "object_discovery_with_scores.json",
        "scoring_partial_p0.jsonl",
    ]
    part = (port_dir / "scoring_partial_p0.jsonl").read_text().splitlines()
    assert json.loads(part[0])["_meta"] == 1 and sorted(json.loads(x)["image_id"] for x in part[1:]) == [10, 12]

    # a rerun with the same inputs skips every image and writes the same file
    object_scoring.main(argv)
    assert "resuming: 2 images already scored" in capsys.readouterr().out
    assert (port_dir / "scoring_partial_p0.jsonl").read_text().splitlines() == part
    assert json.loads((port_dir / "object_discovery_with_scores.json").read_text()) == got

    # post_process.py takes the port's output unchanged
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "post_process.py"), "--pred_annotations_path",
         str(port_dir / "object_discovery_with_scores.json"), "--gt_annotation_path", str(coco / "instances.json"),
         "--existence_score_thres", "0", "--center_score_thres", "0", "--boundary_score_thres", "-1"],
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    selected = json.loads((port_dir / "selected_training_annotations.json").read_text())
    kept = [a for a in got if a["boundary_score"] >= -1]
    assert len(selected["annotations"]) == len(kept) > 0
    assert all(a["score"] == a["area_score"] for a in selected["annotations"])
