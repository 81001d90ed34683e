"""The port's dense-tail A/B scripts, the chain's steps for them and the
report's A/B sections, against the JAX scripts.

A small world of the analytic scenes of ``tests/test_reasoning_engine.py``
(mask ids and center fields painted into the image) is written as COCO
images and ``instances.json``. Both packages' scripts run in this process
through their own ``main``, with the fake objectness and classifier nets of
``tests/test_torch_engine.py`` in place of their builders and loaders: both
engines see bit-identical fields. Per leg, the boundary crops, the overflow
counts and the number of annotations are equal, the four AP figures agree
within 1e-4, and the boxes within 1e-3; ``delta`` (less the speedup, a ratio
of two measured walls), ``delta_legs_comparable`` and
``delta_main_minus_truncated`` are equal, and ``meta`` has the same keys.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from tests.test_reasoning_engine import make_world
from tests.test_torch_engine import jax_classifier, jax_objectness, torch_classifier, torch_objectness
from unmore_tpu.cli import common as jax_common
from unmore_tpu_torch.cli import common
from unmore_tpu_torch.scripts import max_active_ab, scale_chain, scale_report, sticky_ab
from unmore_tpu_torch.utils import rle

ROOT = Path(__file__).resolve().parents[1]
SCENES = [  # (side, rectangles (x1, y1, x2, y2)): two small scenes for the sticky A/B, a dense one for the lattice's
    (64, [(8, 8, 28, 28), (36, 34, 56, 54)]),
    (64, [(20, 18, 44, 42)]),
    (128, [(x, y, x + 22, y + 22) for y in range(4, 100, 31) for x in range(4, 100, 31)]),
]
CANVAS = 128
AP_TOL, BOX_TOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_world(root: Path) -> Path:
    """``coco/images/*.png`` and ``coco/instances.json`` of :data:`SCENES`."""
    images = root / "coco" / "images"
    images.mkdir(parents=True)
    gt = {"images": [], "annotations": [], "categories": [{"id": 1, "name": "fg", "supercategory": "fg"}]}
    for i, (size, objects) in enumerate(SCENES):
        world = make_world(size, objects)
        name = f"scene_{i:04d}.png"
        Image.fromarray(np.clip(world * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(images / name)
        gt["images"].append({"id": i + 1, "file_name": name, "height": size, "width": size})
        for x1, y1, x2, y2 in objects:
            mask = np.zeros((size, size), np.uint8)
            mask[y1:y2, x1:x2] = 1
            gt["annotations"].append({"id": len(gt["annotations"]) + 1, "image_id": i + 1, "category_id": 1,
                                      "bbox": [x1, y1, x2 - x1, y2 - y1], "area": int(mask.sum()), "iscrowd": 0,
                                      "segmentation": rle.encode(mask)})
    (root / "coco" / "instances.json").write_text(json.dumps(gt))
    return root


def main_scored(root: Path) -> Path:
    """A main run's scored file: each GT object, one of them shifted, with
    descending scores."""
    gt = json.loads((root / "coco" / "instances.json").read_text())
    anns = []
    for k, a in enumerate(gt["annotations"]):
        x, y, w, h = a["bbox"]
        if k == 1:
            x += 8
        anns.append({"image_id": a["image_id"], "category_id": 1, "bbox": [x, y, w, h],
                     "segmentation": a["segmentation"], "score": 1.0 - 0.01 * k})
    path = root / "scored.json"
    path.write_text(json.dumps(anns))
    return path


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_world(tmp_path_factory.mktemp("ab_world"))


@pytest.fixture
def fakes(monkeypatch):
    """Both packages' builders and loaders give the fake nets; the JAX
    scripts keep the suite's compile cache and find ``sticky_ab`` on the path."""
    monkeypatch.setattr(jax_common, "build_objectness", lambda args, dtype: None)
    monkeypatch.setattr(jax_common, "build_classifier", lambda dtype: None)
    monkeypatch.setattr(jax_common, "load_objectness_params", lambda path: {})
    monkeypatch.setattr(jax_common, "load_classifier_variables", lambda path: {})
    monkeypatch.setattr(jax_common, "make_apply_fns", lambda *a: (jax_objectness, jax_classifier, {}))
    monkeypatch.setattr(common, "build_objectness", lambda args, dtype, device: None)
    monkeypatch.setattr(common, "build_classifier", lambda dtype, device: None)
    monkeypatch.setattr(common, "load_objectness_weights", lambda model, path: None)
    monkeypatch.setattr(common, "load_classifier_weights", lambda model, path: None)
    monkeypatch.setattr(common, "make_apply_fns", lambda *a: (torch_objectness, torch_classifier))
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda key, value: None if key == "jax_compilation_cache_dir" else update(key, value))
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.delitem(sys.modules, "sticky_ab", raising=False)


def recording(run_mode, boxes):
    """``run_mode`` that keeps each leg's boxes in ``boxes`` by ``sticky_convergence``."""

    def run(cfg, *args):
        out = run_mode(cfg, *args)
        boxes[cfg.sticky_convergence] = out[0]
        return out

    return run


def run_jax(name, argv, monkeypatch, boxes=None):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod = load_jax_script(name)
    if boxes is not None:
        mod.run_mode = recording(mod.run_mode, boxes)
    mod.main()


def assert_same_leg(got, want, ap_keys=sticky_ab.AP_KEYS):
    for k in ap_keys:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    for k in ("boundary_crops", "split_overflow", "active_overflow", "cc_overflow", "n_annotations", "max_active"):
        assert got.get(k) == want.get(k), k
    if "meta" in want:
        assert got["meta"].keys() == want["meta"].keys()
        assert {k: v for k, v in got["meta"].items() if k not in ("recorded_utc", "backend")} == {
            k: v for k, v in want["meta"].items() if k not in ("recorded_utc", "backend")}


def test_sticky_ab_matches_the_jax_script(world, fakes, tmp_path, monkeypatch):
    common_argv = ["--synth", str(world), "--objectness", "obj.ckpt", "--classifier", "cls.ckpt",
                   "--canvas_size", str(CANVAS), "--image_batch", "2", "--start_idx", "0", "--end_idx", "2"]
    jax_boxes, port_boxes = {}, {}
    run_jax("sticky_ab", common_argv + ["--out", str(tmp_path / "jax.json")], monkeypatch, jax_boxes)
    want = json.loads((tmp_path / "jax.json").read_text())

    # the port's reference leg alone first, then the sticky leg merged into its file
    monkeypatch.setattr(sticky_ab, "run_mode", recording(sticky_ab.run_mode, port_boxes))
    port_out = tmp_path / "port.json"
    sticky_ab.main(common_argv + ["--device", "cpu", "--dtype", "float32", "--out", str(port_out),
                                  "--modes", "reference_rounds"])
    assert set(json.loads(port_out.read_text())) == {"reference_rounds"}
    sticky_ab.main(common_argv + ["--device", "cpu", "--dtype", "float32", "--out", str(port_out), "--modes", "sticky"])
    got = json.loads(port_out.read_text())

    for leg in ("sticky", "reference_rounds"):
        assert_same_leg(got[leg], want[leg])
    assert want["reference_rounds"]["boundary_crops"] > want["sticky"]["boundary_crops"] > 0
    assert want["sticky"]["n_annotations"] > 0
    assert got["delta_legs_comparable"] is want["delta_legs_comparable"] is True
    assert {k: v for k, v in got["delta"].items() if k != "speedup"} == {
        k: v for k, v in want["delta"].items() if k != "speedup"}
    assert got["delta"].keys() == want["delta"].keys()
    for mode in (True, False):
        assert sorted(port_boxes[mode]) == sorted(jax_boxes[mode])
        for image_id, b in jax_boxes[mode].items():
            assert port_boxes[mode][image_id].shape == b.shape
            np.testing.assert_allclose(port_boxes[mode][image_id], b, atol=BOX_TOL)


def test_max_active_ab_matches_the_jax_script(world, fakes, tmp_path, monkeypatch):
    argv = ["--synth", str(world), "--objectness", "obj.ckpt", "--classifier", "cls.ckpt",
            "--canvas_size", str(CANVAS), "--image_batch", "4", "--start_idx", "2", "--end_idx", "3",
            "--main_scored", str(main_scored(world)), "--main_max_active", "1024", "--max_active", "64"]
    run_jax("max_active_ab", argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    max_active_ab.main(argv + ["--device", "cpu", "--dtype", "float32", "--out", str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["meta"].keys() == want["meta"].keys() and got["meta"]["n_images"] == want["meta"]["n_images"] == 1
    assert_same_leg(got["main"], want["main"])
    assert_same_leg(got["truncated"], want["truncated"])
    assert want["truncated"]["active_overflow"] > 0 and want["main"]["n_annotations"] == len(SCENES[2][1])
    assert got["delta_main_minus_truncated"] == want["delta_main_minus_truncated"]


def test_ab_scripts_need_a_card_unless_told_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--synth", str(world), "--objectness", "o", "--classifier", "c"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sticky_ab.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        max_active_ab.main(argv + ["--main_scored", "s.json", "--main_max_active", "1536"])
    assert sticky_ab.default_out("sticky_ab_results", torch.device("cpu")).endswith(
        "scripts/torch_sticky_ab_results_cpu.json")
    assert sticky_ab.default_out("max_active_ab_results", torch.device("cuda")).endswith(
        "scripts/torch_max_active_ab_results.json")


def flags(cmd):
    """``--flag value`` pairs of a command line (bare flags map to True)."""
    out, i = {}, 0
    while i < len(cmd):
        if cmd[i].startswith("--"):
            bare = i + 1 == len(cmd) or cmd[i + 1].startswith("--")
            out[cmd[i]] = True if bare else cmd[i + 1]
            i += 1 if bare else 2
        else:
            i += 1
    return out


def test_chain_runs_both_ab_steps_with_r5_flags(tmp_path, monkeypatch):
    """``scale_chain``'s steps ``max_active_ab`` and ``sticky_ab``: the flags
    of ``scale_run_r5.sh:322-352`` from the chain's knobs, the out file in
    ``--work``, the step's log and its timing stamps."""
    seen = []
    monkeypatch.setattr(scale_chain.Chain, "run", lambda self, cmd, log=None, append=False: seen.append((cmd, log)))
    work = tmp_path / "work"
    with pytest.raises(SystemExit) as exit_:
        scale_chain.main(["--work", str(work), "--steps", "max_active_ab", "sticky_ab", "--device", "cpu",
                          "--dtype", "float32", "--backbone", "dpt_base", "--canvas", "320", "--image_batch", "2",
                          "--max_active", "512", "--ab_end", "2", "--ab_max_active", "256"])
    assert exit_.value.code == 0
    assert scale_chain.STEPS[-3:] == ("cad", "max_active_ab", "sticky_ab")
    (ma_cmd, ma_log), (st_cmd, st_log) = seen
    assert "unmore_tpu_torch.scripts.max_active_ab" in ma_cmd
    assert "unmore_tpu_torch.scripts.sticky_ab" in st_cmd
    assert (ma_log, st_log) == ("max_active_ab_r5.log", "sticky_ab_r5.log")
    chain = scale_chain.Chain(scale_chain.parse_args(["--work", str(work)]))
    shared = {"--synth": str(work / "synth"), "--backbone_type": "dpt_base", "--objectness": chain.obj_ckpt,
              "--classifier": chain.cls_ckpt, "--canvas_size": "320", "--image_batch": "2", "--start_idx": "0",
              "--end_idx": "2", "--device": "cpu", "--dtype": "float32"}
    assert flags(ma_cmd) == {**shared, "--main_scored": str(work / "results_reasoning" / "disc_r5"
                                                            / "object_discovery_with_scores.json"),
                             "--main_max_active": "512", "--max_active": "256",
                             "--out": str(work / "max_active_ab_results.json")}
    assert flags(st_cmd) == {**shared, "--out": str(work / "sticky_ab_results.json")}
    timings = (work / "scale_timings.txt").read_text()
    for step in ("max_active_ab", "sticky_ab"):
        assert f"{step} start" in timings and f"{step} done" in timings
    defaults = scale_chain.parse_args(["--work", str(work)])
    assert (defaults.ab_end, defaults.ab_max_active) == (40, 1024)


FRESH_META = {"n_images": 2, "start_idx": 0, "end_idx": 2, "synth": "/w/synth", "max_active": None,
              "max_splits": None, "recorded_utc": "2026-10-17 10:00", "backend": "cpu"}
FRESH = {"sticky": {"meta": FRESH_META, "bbox_AP50": 0.5, "boundary_crops": 10},
         "reference_rounds": {"meta": FRESH_META, "bbox_AP50": 0.49, "boundary_crops": 30},
         "delta_legs_comparable": True, "delta": {"bbox_AP50": 0.01, "boundary_crop_ratio": 3.0}}
MAX_ACTIVE = {"meta": {"n_images": 2}, "main": {"bbox_AP": 0.3}, "truncated": {"bbox_AP": 0.25},
              "delta_main_minus_truncated": {"bbox_AP": 0.05}}
ARCHIVE = ROOT / "scripts" / "sticky_ab_results_r3_sparse.json"


def _unstamped():
    return {k: ({kk: vv for kk, vv in v.items() if kk != "meta"} if k == "reference_rounds" else v)
            for k, v in FRESH.items()}


STALENESS = {  # case -> (sticky file bytes, failed steps)
    "fresh": (lambda: json.dumps(FRESH), []),
    "r3_archive": (lambda: ARCHIVE.read_text(), []),
    "failed_step": (lambda: json.dumps(FRESH), ["step_sticky_ab"]),
    "archive_and_failed_step": (lambda: ARCHIVE.read_text(), ["step_sticky_ab"]),
    "unstamped": (lambda: json.dumps(_unstamped()), []),
    "other_worlds": (lambda: json.dumps(dict(FRESH, delta_legs_comparable=False)), []),
    "no_ab_files": (None, []),
}


@pytest.mark.parametrize("case", sorted(STALENESS))
def test_report_ab_sections_match_the_jax_report(case, tmp_path, monkeypatch):
    work, repo = tmp_path / "work", tmp_path / "repo"
    (repo / "scripts").mkdir(parents=True)
    work.mkdir()
    shutil.copy(ARCHIVE, repo / "scripts" / ARCHIVE.name)
    text, failed = STALENESS[case]
    if text is not None:
        for folder in (work, repo / "scripts"):
            (folder / "sticky_ab_results.json").write_text(text())
            (folder / "max_active_ab_results.json").write_text(json.dumps(MAX_ACTIVE))
    if failed:
        (work / "failed_steps.txt").write_text("\n".join(failed) + "\n")
    monkeypatch.setattr(sys, "argv", ["scale_report", "--work", str(work), "--repo", str(repo),
                                      "--out", str(tmp_path / "jax.json")])
    load_jax_script("scale_report").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = scale_report.report(str(work))
    for key in ("max_active_ab", "sticky_ab_dense", "sticky_ab_stale"):
        assert got.get(key, "absent") == want.get(key, "absent"), key
    if case == "fresh":
        assert got["sticky_ab_dense"] == FRESH
    elif text is not None:
        assert got["sticky_ab_dense"] is None and got["sticky_ab_stale"]["reason"]
