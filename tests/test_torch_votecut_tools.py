"""The port's VoteCut tools against the JAX package's OpenCV scripts.

A VoteCut-format JSON is made from seeded numpy masks: a top mask of several
components, one whose two largest components tie in area (numbered one way
by a raster scan of first pixels and the other way by OpenCV's scan of 2x2
blocks), an empty top mask, tied weights, and an image of 300 instances (ids
past 255 wrap in the uint8 PNG). ``utils/preprocess_votecut.py`` (both
modes) and ``utils/vis_votecut.py`` run beside the port's scripts; every PNG
is equal pixel for pixel. The port's largest component equals the JAX
script's on seeded random masks, and its ``vis_label_map`` and
``get_mask_plot_colors`` equal the JAX package's.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from unmore_tpu.utils import vis as jax_vis
from unmore_tpu_torch.scripts import preprocess_votecut, vis_votecut
from unmore_tpu_torch.utils import rle, vis

ROOT = Path(__file__).resolve().parents[1]


def load_jax(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "utils" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blobs(rng, h, w, n):
    """``n`` random rectangles of a [h, w] uint8 mask."""
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        m[y : y + rng.randint(2, 12), x : x + rng.randint(2, 12)] = 1
    return m


def votecut_json(path: Path) -> Path:
    rng = np.random.RandomState(0)
    images, anns = [], []

    def add(image_id, mask, weight):
        anns.append({"id": len(anns) + 1, "image_id": image_id, "category_id": 1, "weight": weight,
                     "segmentation": rle.encode(mask), "area": int(mask.sum())})

    h, w = 48, 64
    # several components, and two lower-weight masks under them
    images.append({"id": 1, "file_name": "n01/a_0001.JPEG", "height": h, "width": w})
    add(1, blobs(rng, h, w, 6), 0.9)
    add(1, blobs(rng, h, w, 3), 0.5)
    add(1, blobs(rng, h, w, 2), 0.2)
    # two components of equal largest area: the one at (0, 20) comes first by raster order of first
    # pixels, the one at (1, 2) first in OpenCV's scan of 2x2 blocks
    tie = np.zeros((h, w), np.uint8)
    tie[0:4, 20:24] = 1
    tie[1:5, 2:6] = 1
    tie[30:32, 40:42] = 1
    images.append({"id": 2, "file_name": "n01/b_0002.JPEG", "height": h, "width": w})
    add(2, tie, 0.7)
    # an empty top mask
    images.append({"id": 3, "file_name": "n02/c_0003.JPEG", "height": h, "width": w})
    add(3, np.zeros((h, w), np.uint8), 0.99)
    add(3, blobs(rng, h, w, 2), 0.1)
    # tied weights: the first of equals wins
    images.append({"id": 4, "file_name": "n02/d_0004.jpg", "height": h, "width": w})
    add(4, blobs(rng, h, w, 4), 0.6)
    add(4, blobs(rng, h, w, 4), 0.6)
    # 300 instances in one image: one 2x2 square each, some overlapping
    images.append({"id": 5, "file_name": "n03/e_0005.JPEG", "height": 64, "width": 80})
    for k in range(300):
        m = np.zeros((64, 80), np.uint8)
        y, x = divmod(k, 38)
        m[2 * y + 1 : 2 * y + 3, 2 * x + 1 : 2 * x + 3 + (k % 7 == 0)] = 1
        add(5, m, float(rng.rand()))
    # 8-connected random masks
    for i in range(6, 10):
        images.append({"id": i, "file_name": f"n04/f_{i:04d}.JPEG", "height": h, "width": w})
        add(i, (rng.rand(h, w) > 0.55).astype(np.uint8), 0.5)
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "fg"}]}))
    return path


def pngs(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*.png")):
        with Image.open(p) as im:
            out[str(p.relative_to(root))] = (im.mode, np.asarray(im))
    return out


def assert_same_pngs(got_root: Path, want_root: Path, n_expected: int):
    got, want = pngs(got_root), pngs(want_root)
    assert sorted(got) == sorted(want) and len(want) == n_expected
    for name, (mode, pixels) in want.items():
        assert got[name][0] == mode, name
        np.testing.assert_array_equal(got[name][1], pixels, err_msg=name)


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    return votecut_json(tmp_path_factory.mktemp("votecut") / "votecut.json")


@pytest.mark.parametrize("mode", ["top1", "full"])
def test_preprocess_matches_the_cv2_script(annotations, tmp_path, mode):
    load_jax("preprocess_votecut").main(["--annotation_file", str(annotations), "--dest_folder",
                                         str(tmp_path / "jax"), "--mode", mode])
    preprocess_votecut.main(["--annotation_file", str(annotations), "--dest_folder", str(tmp_path / "port"),
                             "--mode", mode])
    assert_same_pngs(tmp_path / "port", tmp_path / "jax", 9)
    sub = "masks_top1_single_component" if mode == "top1" else "masks"
    with Image.open(tmp_path / "port" / sub / "n01" / "b_0002.png") as im:
        tie = np.asarray(im)
    if mode == "top1":
        assert tie[2, 3] == 255 and tie[1, 21] == 0  # OpenCV's choice of the tied components
    else:
        with Image.open(tmp_path / "port" / sub / "n03" / "e_0005.png") as im:
            many = np.asarray(im)
        assert many[1, 1] == 1 and many.max() == 255 and 300 % 256 in many  # ids past 255 wrapped


def test_largest_component_matches_cv2():
    jax_script = load_jax("preprocess_votecut")
    rng = np.random.RandomState(1)
    for _ in range(300):
        h, w = rng.randint(2, 40, 2)
        mask = (rng.rand(h, w) > rng.uniform(0.3, 0.9)).astype(np.uint8)
        if mask.sum():
            np.testing.assert_array_equal(preprocess_votecut.largest_component(mask),
                                          jax_script.largest_component_4(mask))


def test_vis_votecut_matches_the_cv2_script(annotations, tmp_path, capsys):
    load_jax("vis_votecut").main(["--votecut_json", str(annotations), "--out_dir", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    vis_votecut.main(["--votecut_json", str(annotations), "--out_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out.replace("port", "jax") == want_out
    assert_same_pngs(tmp_path / "port", tmp_path / "jax", 18)
    vis_votecut.main(["--votecut_json", str(annotations), "--out_dir", str(tmp_path / "few"), "--limit", "2",
                      "--no_vis"])
    assert len(pngs(tmp_path / "few")) == 2


def test_label_colours_match_the_jax_package():
    for n in (0, 1, 3, 17, 300):
        np.testing.assert_array_equal(vis.get_mask_plot_colors(n), jax_vis.get_mask_plot_colors(n))
    labels = np.random.RandomState(2).randint(0, 40, (30, 50))
    labels[labels % 3 == 0] = 0
    np.testing.assert_array_equal(vis.vis_label_map(labels), jax_vis.vis_label_map(labels))
