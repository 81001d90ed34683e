"""The port's CAD training data (no OpenCV) against the JAX package's.

Seeded PNG scenes on disk (COCO and ``imagenet_`` ids, RLE masks at the
image's size and at another size, box-only annotations, an unreadable file)
go through both packages' ``DetectionDataset.load``, ``copy_and_paste``,
``to_lattice`` and ``detection_batch_iterator`` with equal seeds. Expected:
the same draws (sizes, instances, boxes, scores, flags), float images
within 1e-6 (OpenCV's float INTER_LINEAR against ``csrc/labels.cpp``'s),
nearest-resized masks equal. The uint8 wire format rounds those floats: a
uint8 image or box-frame mask target may differ by 1 where the float lies
at a rounding boundary, on at most 0.1% of pixels (measured here: 0.04% of
image pixels, no mask pixel).
"""

import json

import cv2
import numpy as np
import pytest

from unmore_tpu.data import detection as jax_detection
from unmore_tpu.utils import rle as jax_rle
from unmore_tpu_torch.data import detection

SIZES = ((60, 80), (96, 72), (50, 50), (81, 67))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cad_data")
    (root / "coco").mkdir()
    (root / "imagenet").mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        single = i == 3
        image_id = f"imagenet_{i}" if single else f"coco_{i}"
        folder = "imagenet" if single else "coco"
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        for k in range(1 if single else 3):
            m = np.zeros((h, w), np.uint8)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            m[y0 : y0 + rng.randint(8, h // 2), x0 : x0 + rng.randint(8, w // 2)] = 1
            ys, xs = np.nonzero(m)
            ann = {"id": len(anns) + 1, "image_id": image_id, "category_id": 1, "score": float(rng.uniform(0.5, 1)),
                   "bbox": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1]}
            if k == 1:  # a mask at another resolution than the image
                ann["segmentation"] = jax_rle.encode(cv2.resize(m, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST))
            elif k == 0:
                ann["segmentation"] = jax_rle.encode(m)
            anns.append(ann)
        cv2.imwrite(str(root / folder / f"{i}.png"), img[..., ::-1])
        images.append({"id": image_id, "file_name": f"{i}.png", "height": h, "width": w})
    images.append({"id": "coco_missing", "file_name": "missing.png", "height": 10, "width": 10})
    path = root / "train.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    roots = {"coco": str(root / "coco"), "imagenet": str(root / "imagenet"), "": str(root)}
    return str(path), roots


def _datasets(world, canvas=96, seed=3):
    path, roots = world
    return (jax_detection.DetectionDataset(path, roots, canvas, (40, 64, 96), seed),
            detection.DetectionDataset(path, roots, canvas, (40, 64, 96), seed))


def _same_sample(got, want, atol=1e-6):
    assert got["hw"] == want["hw"] and got["is_single_object"] == want["is_single_object"]
    np.testing.assert_allclose(got["image"], want["image"], atol=atol, rtol=0)
    assert len(got["instances"]) == len(want["instances"])
    for a, b in zip(got["instances"], want["instances"]):
        np.testing.assert_array_equal(a.box, b.box)
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.score == b.score


def test_load_matches(world):
    jds, ds = _datasets(world)
    for _ in range(2):  # twice: the size draws advance alike
        for i in range(len(ds)):
            want, got = jds.load(i), ds.load(i)
            if want is None:
                assert got is None and i == len(SIZES)
                continue
            _same_sample(got, want)
    assert ds.load(3)["is_single_object"] == 1.0


def test_copy_and_paste_matches(world):
    jds, ds = _datasets(world, seed=5)
    samples = [(jds.load(i), ds.load(i)) for i in range(len(SIZES))]
    n_pasted = 0
    for seed in range(6):
        jrng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for (jd, d), (jr, r) in zip(samples, samples[::-1]):
            want = jax_detection.copy_and_paste(jd, jr, jrng, rate=0.8, min_ratio=0.3, max_ratio=1.0)
            got = detection.copy_and_paste(d, r, rng, rate=0.8, min_ratio=0.3, max_ratio=1.0)
            _same_sample(got, want)
            n_pasted += want is not jr
    assert n_pasted >= 6
    assert jrng.random() == rng.random()


def test_to_lattice_and_batches_match(world):
    jds, ds = _datasets(world, seed=7)
    jit = jax_detection.detection_batch_iterator(jds, 3, 4, 16, np.random.default_rng(11), rate=1.0)
    it = detection.detection_batch_iterator(ds, 3, 4, 16, np.random.default_rng(11), rate=1.0)
    differ = {"images": 0, "gt_masks": 0}
    total = dict.fromkeys(differ, 0)
    for _ in range(4):
        want, got = next(jit), next(it)
        assert got.keys() == want.keys()
        for k in want:
            if k in differ:
                assert got[k].dtype == want[k].dtype == np.uint8
                d = np.abs(got[k].astype(int) - want[k].astype(int))
                assert d.max() <= 1, k
                differ[k] += int((d > 0).sum())
                total[k] += d.size
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(differ[k] <= 1e-3 * total[k] for k in differ), (differ, total)
    assert want["gt_valid"].sum() > 4 and want["is_single_object"].max() == 1.0
