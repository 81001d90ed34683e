"""The port's COCO evaluator and its host libraries against the JAX package.

``unmore_tpu_torch.evaluation.coco_eval.evaluate_ap`` gives the JAX
``evaluate_ap``'s 12 metrics (within 1e-12) on the hand-computed fixtures of
``tests/test_coco_eval.py`` and on seeded random sets with crowd GTs and
masks; ``python -m unmore_tpu_torch.cli.coco_eval`` writes the
``ap_score.json`` of ``COCO_evaluator/main.py``. The host library
``csrc/cocoeval.cpp`` (mask IoU, greedy matching) equals its plain versions
and the JAX package's native library; ``csrc/labels.cpp``'s uint8 INTER_LINEAR
equals OpenCV; ``csrc/paste.cpp``'s probability paste equals its plain
version.
"""

import json
import math
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from tests.test_coco_eval import _det, _gt
from unmore_tpu import native
from unmore_tpu.evaluation.coco_eval import evaluate_ap as jax_evaluate_ap
from unmore_tpu_torch.evaluation.coco_eval import IOU_THRS, evaluate_ap
from unmore_tpu_torch.ops import cocoeval, labels, paste
from unmore_tpu_torch.utils import rle

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _same_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k, v in want[task].items():
            g = got[task][k]
            assert (math.isnan(g) and math.isnan(v)) or abs(g - v) <= 1e-12, (task, k, g, v)


def _fixture_cases():
    """The scenes of tests/test_coco_eval.py, rebuilt from its helpers."""
    seg_gt = np.zeros((100, 100), np.uint8)
    seg_gt[10:30, 10:30] = 1
    segm_gt = _gt([1], [(1, (10, 10, 20, 20))])
    segm_gt["annotations"][0]["segmentation"] = rle.encode(seg_gt)
    segm_det = dict(_det(1, (10, 10, 20, 20), 0.9), segmentation=rle.encode(seg_gt))
    return {
        "perfect": (_gt([1], [(1, (10, 10, 20, 20)), (1, (50, 50, 30, 30))]),
                    [_det(1, (10, 10, 20, 20), 0.9), _det(1, (50, 50, 30, 30), 0.8)], ("bbox",)),
        "iou_060": (_gt([1], [(1, (0, 0, 10, 10))]), [_det(1, (0, 0, 10, 6), 0.9)], ("bbox",)),
        "false_positive": (_gt([1], [(1, (10, 10, 20, 20))]),
                           [_det(1, (70, 70, 10, 10), 0.95), _det(1, (10, 10, 20, 20), 0.90)], ("bbox",)),
        "crowd": (_gt([1], [(1, (10, 10, 20, 20)), (1, (60, 60, 20, 20), 1)]),
                  [_det(1, (60, 60, 20, 20), 0.95), _det(1, (10, 10, 20, 20), 0.90)], ("bbox",)),
        "area_ranges": (_gt([1], [(1, (0, 0, 16, 16)), (1, (2, 2, 97, 97))]),
                        [_det(1, (0, 0, 16, 16), 0.9), _det(1, (2, 2, 97, 97), 0.8)], ("bbox",)),
        "missed_gt": (_gt([1], [(1, (10, 10, 20, 20)), (1, (60, 60, 20, 20))]), [_det(1, (10, 10, 20, 20), 0.9)],
                      ("bbox",)),
        "segm": (segm_gt, [segm_det], ("bbox", "segm")),
        "weight_fallback": (_gt([1], [(1, (10, 10, 20, 20))]),
                            [{"image_id": 1, "category_id": 1, "bbox": [10, 10, 20, 20], "weight": 0.7}], ("bbox",)),
    }


@pytest.mark.parametrize("case", sorted(_fixture_cases()))
def test_metrics_equal_the_jax_evaluator_on_its_fixtures(case):
    gt, dets, tasks = _fixture_cases()[case]
    _same_metrics(evaluate_ap(gt, dets, iou_types=tasks), jax_evaluate_ap(gt, dets, iou_types=tasks))


def random_world(seed, n_images=5, h=60, w=80):
    """GT with masks (some crowd, sizes across the area ranges) and noisy
    detections with masks, some of them empty, on n_images images."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(1, n_images + 1):
        images.append({"id": i, "height": h, "width": w})
        for g in range(rng.randint(1, 6)):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
            m[y : y + rng.randint(3, h - y + 1), x : x + rng.randint(3, w - x + 1)] = 1
            ys, xs = np.nonzero(m)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1, "iscrowd": int(rng.rand() < 0.2),
                         "bbox": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1],
                         "area": int(m.sum()), "segmentation": rle.encode(m)})
            for _ in range(rng.randint(0, 3)):
                noisy = np.roll(m, rng.randint(-6, 7, 2), axis=(0, 1)) & (rng.rand(h, w) > 0.1)
                ys, xs = np.nonzero(noisy)
                box = [float(xs.min()), float(ys.min()), float(np.ptp(xs) + 1), float(np.ptp(ys) + 1)] if len(ys) \
                    else [0.0, 0.0, 1.0, 1.0]
                dets.append({"image_id": i, "category_id": 1, "score": float(rng.rand()), "bbox": box,
                             "segmentation": rle.encode(noisy.astype(np.uint8))})
        dets.append({"image_id": i, "category_id": 1, "score": 0.5, "bbox": [1.0, 2.0, 5.0, 5.0],
                     "segmentation": rle.encode(np.zeros((h, w), np.uint8))})
    return {"images": images, "annotations": anns}, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_evaluator_on_random_worlds(seed):
    gt, dets = random_world(seed)
    got = evaluate_ap(gt, dets, iou_types=("bbox", "segm"))
    _same_metrics(got, jax_evaluate_ap(gt, dets, iou_types=("bbox", "segm")))
    assert 0 < got["segm"]["AP50"] < 1


@pytest.mark.parametrize("seed", [0, 1])
def test_host_library_equals_plain_versions(seed):
    rng = np.random.RandomState(seed)
    masks = [(rng.rand(30, 41) > rng.rand()).astype(np.uint8) for _ in range(9)]
    masks[0][:] = 0  # an empty mask
    rles = [rle.encode(m) for m in masks]
    rles[1] = {"size": rles[1]["size"], "counts": rle.mask_to_runs(masks[1]).tolist()}  # uncompressed
    crowd = np.array([0, 1, 0, 0])
    got = cocoeval.mask_iou(rles[:5], rles[5:], crowd)
    np.testing.assert_array_equal(got, cocoeval.mask_iou_plain(rles[:5], rles[5:], crowd))
    np.testing.assert_array_equal(got, native.mask_iou(rles[:5], rles[5:], iscrowd=crowd))

    ious = np.round(rng.rand(17, 7), 2)  # ties at the thresholds
    gt_ig = np.array([0, 0, 0, 0, 1, 1, 1], np.int32)
    iscrowd = np.array([0, 1, 0, 0, 0, 1, 0], np.int32)
    got = cocoeval.coco_match(ious, gt_ig, iscrowd, IOU_THRS)
    for want in (cocoeval.coco_match_plain(ious, gt_ig, iscrowd, IOU_THRS),
                 native.coco_match(ious, gt_ig, iscrowd, IOU_THRS)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() > 0


@pytest.mark.parametrize("shape", [(100, 120, 91, 77), (375, 500, 800, 1067), (480, 640, 800, 1067),
                                   (200, 300, 100, 150), (8, 8, 800, 800), (33, 47, 61, 29), (64, 64, 64, 64)])
def test_uint8_resize_equals_opencv(shape):
    """cv2's uint8 INTER_LINEAR is fixed point: the library gives its bits
    (share of exact pixels 1.0, largest difference 0), where a rounded float
    resize is 1 level off on ~13% of the pixels. An exact 2x downscale is
    OpenCV's INTER_AREA."""
    h, w, H, W = shape
    img = (np.random.RandomState(h * w).rand(h, w, 3) * 255).astype(np.uint8)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
    got = labels.resize_linear_u8(img, (H, W))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels.resize_linear_u8_plain(img, (H, W)), want)
    np.testing.assert_array_equal(labels.resize_linear_u8(img[..., 1], (H, W)), want[..., 1])
    crop = img[3:, 5:]  # strided rows
    np.testing.assert_array_equal(labels.resize_linear_u8(crop, (H, W)),
                                  cv2.resize(np.ascontiguousarray(crop), (W, H), interpolation=cv2.INTER_LINEAR))


def test_probability_paste_equals_its_plain_version():
    rng = np.random.RandomState(0)
    for _ in range(60):
        prob = rng.rand(28, 28).astype(np.float32)
        h, w = rng.randint(20, 200, 2)
        x1, y1 = rng.rand(2) * [w, h] - 10
        bw, bh = rng.rand(2) * [w, h] + 0.5
        box = np.array([x1, y1, x1 + bw, y1 + bh], np.float32)
        assert paste.paste_prob_rle(prob, box, h, w) == paste.paste_prob_rle_plain(prob, box, h, w)


def test_cli_writes_the_ap_score_of_the_reference_cli(tmp_path):
    gt, dets = random_world(3)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    gt_path = tmp_path / "instances.json"
    gt_path.write_text(json.dumps(gt))
    for name in ("port", "jax"):
        (tmp_path / name / "preds.json").write_text(json.dumps({"annotations": dets}))
    argv = ["--gt_annotations_path", str(gt_path), "--tasks", "bbox", "segm"]
    from unmore_tpu_torch.cli import coco_eval

    coco_eval.main(["--pred_annotations_path", str(tmp_path / "port" / "preds.json"), *argv])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(ROOT, "COCO_evaluator", "main.py"), "--pred_annotations_path",
                    str(tmp_path / "jax" / "preds.json"), *argv], check=True, env=env, capture_output=True)
    got = json.loads((tmp_path / "port" / "ap_score.json").read_text())
    want = json.loads((tmp_path / "jax" / "ap_score.json").read_text())
    _same_metrics(got, want)
