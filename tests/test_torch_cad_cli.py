"""The port's CAD eval-only CLI against ``cad/train_net.py --eval-only``.

Both CLIs read one JAX ``TrainState`` checkpoint (saved with the JAX
package's ``train/checkpoints.py``) of the tiny detector of
``tests/test_cad_cli.py`` and evaluate three seeded 64x64 PNG scenes at
canvas 64 (so ``prepare_eval_image`` does not resize), in float32. Expected:
the same files; the same detections (boxes within 1e-2 px, scores within
1e-4); the same RLEs except at pixels whose pasted probability is within
1e-4 of 0.5; ``metrics_eval_only.json`` equal to 1e-4; ``config.yaml`` read
back by PyYAML equal to the JAX CLI's.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from tests.test_cad_cli import TINY_YAML, _load_cli, _tiny_dataset
from unmore_tpu.detector.cascade_rcnn import CascadeMaskRCNN as JaxDetector
from unmore_tpu.train.checkpoints import save_checkpoint
from unmore_tpu.train.detector import init_detector_state, make_detector_optimizer
from unmore_tpu_torch.cli import train_net
from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN, detector_forward_inference
from unmore_tpu_torch.ops.image import paste_mask_into_canvas
from unmore_tpu_torch.train import checkpoints
from unmore_tpu_torch.train.resilience import FATAL_EXIT_CODE
from unmore_tpu_torch.utils import rle


def _scenes(root, n=3, size=64):
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(1, n + 1):
        img = (rng.rand(size, size, 3) * 80).astype(np.uint8)
        for _ in range(2):
            x1, y1 = rng.randint(2, size // 2, 2)
            w, h = rng.randint(10, size // 2, 2)
            m = np.zeros((size, size), np.uint8)
            m[y1 : y1 + h, x1 : x1 + w] = 1
            img[m > 0] = rng.randint(120, 255, 3)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                         "bbox": [int(x1), int(y1), int(w), int(h)], "area": int(m.sum()),
                         "segmentation": rle.encode(m)})
        Image.fromarray(img).save(img_dir / f"{i:06d}.png")
        images.append({"id": i, "file_name": f"{i:06d}.png", "height": size, "width": size})
    gt = root / "instances.json"
    gt.write_text(json.dumps({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "fg"}]}))
    return str(img_dir), str(gt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cad_cli")
    img_dir, gt = _scenes(root)
    cfg_path = root / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.format(max_iter=4, eval_period=0, out_dir=str(root / "unused")))
    common = ["--config-file", str(cfg_path), "--canvas-size", "64", "--dtype", "float32", "--eval-bs", "8",
              "--eval-only", "--test-json", gt, "--test-image-dir", img_dir]

    # the JAX trainer's state with random weights and BatchNorm statistics
    jax_cli = _load_cli()
    det_cfg, solver, _ = jax_cli.build_from_config(jax_cli.parse_args(common))
    model = JaxDetector(det_cfg)
    state = init_detector_state(model, make_detector_optimizer(), jax.random.PRNGKey(0), det_cfg)
    rng = np.random.RandomState(2)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), method=JaxDetector.init_all))(
        jax.random.PRNGKey(3))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.uniform(0.5, 1.5, x.shape) if p[-1].key == "var" else rng.uniform(-0.1, 0.1, x.shape),
        variables["batch_stats"])
    state = state.replace(params=variables["params"],
                          batch_stats=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), stats))
    ckpt = str(root / "model_0000004.ckpt")
    save_checkpoint(ckpt, state)

    expected = ["TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 50.0, 50.0]]"]
    out = {name: str(root / name) for name in ("jax", "port")}
    jax_cli.main(common + ["MODEL.WEIGHTS", ckpt, "OUTPUT_DIR", out["jax"], *expected])
    train_net.main(common + ["--device", "cpu", "MODEL.WEIGHTS", ckpt, "OUTPUT_DIR", out["port"], *expected])
    return dict(out=out, ckpt=ckpt, common=common, gt=gt, img_dir=img_dir)


def _read(run, name):
    with open(os.path.join(run, name)) as f:
        return yaml.safe_load(f) if name.endswith(".yaml") else json.load(f)


def test_eval_only_writes_the_jax_clis_files(runs):
    names = sorted(os.listdir(runs["out"]["jax"]))
    assert names == ["coco_instances_results.json", "config.yaml", "metrics_eval_only.json"]
    assert sorted(os.listdir(runs["out"]["port"])) == names
    got, want = _read(runs["out"]["port"], "config.yaml"), _read(runs["out"]["jax"], "config.yaml")
    got["OUTPUT_DIR"] = want["OUTPUT_DIR"]
    assert got == want


def _pasted_probabilities(runs):
    """The port's pasted mask probabilities of each annotation, in the order
    of its results file (one forward of the same f32 detector)."""
    port_cfg = train_net.build_from_config(train_net.parse_args(runs["common"]))[0]
    model = CascadeMaskRCNN(port_cfg).eval()
    train_net.load_detector_weights(model, runs["ckpt"])
    from PIL import Image

    files = sorted(os.listdir(runs["img_dir"]))
    images = np.stack([np.asarray(Image.open(os.path.join(runs["img_dir"], f)).convert("RGB")) for f in files])
    hw = torch.full((len(files), 2), 64.0)
    dets = {k: v.numpy() for k, v in detector_forward_inference(model, port_cfg, torch.from_numpy(images), hw).items()}
    probs = []
    for b in range(len(files)):
        for i in np.nonzero(dets["valid"][b])[0]:
            box = np.clip(dets["boxes"][b, i], 0, 64)
            if min(box[2] - box[0], box[3] - box[1]) >= 1e-3:
                probs.append(paste_mask_into_canvas(dets["masks"][b, i], box, (64, 64)))
    return probs


def test_eval_only_detections_match_the_jax_cli(runs):
    got = _read(runs["out"]["port"], "coco_instances_results.json")
    want = _read(runs["out"]["jax"], "coco_instances_results.json")
    assert len(got) == len(want) >= 12
    probs = _pasted_probabilities(runs)
    assert len(probs) == len(got)
    used = set()
    n_mask_pixels = 0
    for g, p in zip(got, probs):
        # the JAX detection of the same image with the nearest box
        cands = [j for j, w in enumerate(want) if w["image_id"] == g["image_id"] and j not in used]
        j = min(cands, key=lambda j: np.abs(np.subtract(want[j]["bbox"], g["bbox"])).sum())
        used.add(j)
        w = want[j]
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
        assert abs(g["score"] - w["score"]) <= 1e-4
        differ = rle.decode(g["segmentation"]) != rle.decode(w["segmentation"])
        assert np.all(np.abs(p[differ] - 0.5) <= 1e-4), np.abs(p[differ] - 0.5).max()
        n_mask_pixels += int(rle.decode(g["segmentation"]).sum())
    assert n_mask_pixels > 0


def test_eval_only_metrics_match_the_jax_cli(runs):
    got = _read(runs["out"]["port"], "metrics_eval_only.json")
    want = _read(runs["out"]["jax"], "metrics_eval_only.json")
    assert got.keys() == want.keys() == {"bbox", "segm"}
    for task in want:
        for k, v in want[task].items():
            assert (np.isnan(v) and np.isnan(got[task][k])) or abs(got[task][k] - v) <= 1e-4, (task, k)


def test_expected_results_gate_and_resume(runs, tmp_path):
    out = str(tmp_path / "out")
    os.makedirs(out)
    for step in (2, 10):  # --resume takes the newest checkpoint in OUTPUT_DIR
        os.symlink(runs["ckpt"], os.path.join(out, f"model_{step:07d}.ckpt"))
    open(os.path.join(out, "model_bad.ckpt"), "w").close()
    assert train_net.find_last_checkpoint(out).endswith("model_0000010.ckpt")
    argv = runs["common"] + ["--device", "cpu", "--resume", "OUTPUT_DIR", out]
    with pytest.raises(AssertionError, match="EXPECTED_RESULTS"):
        train_net.main(argv + ["TEST.EXPECTED_RESULTS", "[['bbox', 'AP50', 99.0, 0.5]]"])
    assert _read(out, "metrics_eval_only.json") == _read(runs["out"]["port"], "metrics_eval_only.json")


def test_verify_results_semantics():
    metrics = {"bbox": {"AP": 0.385, "AP50": 0.60}}
    assert train_net.verify_results({"TEST": {"EXPECTED_RESULTS": [["bbox", "AP", 38.5, 0.2]]}}, metrics)
    for bad in ([["bbox", "AP50", 90.0, 1.0]], [["segm", "AP", 10.0, 5.0]]):  # off target; missing is NaN
        with pytest.raises(AssertionError):
            train_net.verify_results({"TEST": {"EXPECTED_RESULTS": bad}}, metrics)
    assert train_net.verify_results({}, metrics)


def test_training_is_refused_and_restarts_resume(monkeypatch):
    # training needs its annotations
    with pytest.raises(AssertionError, match="--train-json"):
        train_net.main(["--device", "cpu", "--config-file", "x.yaml"])
    seen = {}

    def supervise(build, max_restarts, hang_timeout=None):
        seen.update(first=build(0), retry=build(1), max_restarts=max_restarts, hang_timeout=hang_timeout)
        return 0

    monkeypatch.setattr(train_net.supervisor, "supervise", supervise)
    with pytest.raises(SystemExit) as exit_info:
        train_net.main(["--eval-only", "--max-restarts", "2", "--hang-timeout-min", "1", "MODEL.WEIGHTS", "w"])
    assert exit_info.value.code == 0
    assert seen["first"][1:] == ["-m", "unmore_tpu_torch.cli.train_net", "--eval-only", "--hang-timeout-min", "1",
                                 "MODEL.WEIGHTS", "w"]
    assert seen["retry"][-3:] == ["--resume", "MODEL.WEIGHTS", "w"]
    assert seen["max_restarts"] == 2 and seen["hang_timeout"] == 60


def test_train_resume_with_eval_and_precise_bn_then_eval_only(tmp_path):
    """``tests/test_cad_cli.py``'s drill through the port's CLI on the CPU:
    2 steps with a checkpoint; ``--resume`` to 4 with the in-train eval
    after PreciseBN; ``--eval-only`` on the result."""
    img_dir, json_path = _tiny_dataset(str(tmp_path))
    out_dir = str(tmp_path / "out")
    cfg_path = str(tmp_path / "tiny.yaml")

    def run(max_iter, eval_period, *flags):
        with open(cfg_path, "w") as f:
            f.write(TINY_YAML.format(max_iter=max_iter, eval_period=eval_period, out_dir=out_dir))
        return train_net.main(["--config-file", cfg_path, "--canvas-size", "64", "--dtype", "float32", "--eval-bs", "8",
                               "--device", "cpu", "--train-workers", "2", "--train-json", json_path,
                               "--image-root", f"={img_dir}", "--test-json", json_path, "--test-image-dir", img_dir,
                               *flags, "SOLVER.IMS_PER_BATCH", "2"])

    first = run(2, 0)
    assert [os.path.basename(c["path"]) for c in first["checkpoints"]] == ["model_0000002.ckpt"]
    assert first["checkpoints"][0]["bytes"] == os.path.getsize(first["checkpoints"][0]["path"])
    second = run(4, 4, "--resume")
    ckpt = os.path.join(out_dir, "model_0000004.ckpt")
    assert [c["path"] for c in second["checkpoints"]] == [ckpt]
    assert os.path.isfile(os.path.join(out_dir, "model_0000002.ckpt"))
    tree = checkpoints.load_msgpack_checkpoint(ckpt)  # resumed at 2, not restarted: 4 steps, 4 updates
    assert int(tree["step"]) == 4 and int(tree["opt_state"]["2"]["1"]["count"]) == 4
    assert len(second["precise_bn_s"]) == 1 and list(second["evals"]) == ["iter_0000004"]
    m = _read(out_dir, "metrics_iter_0000004.json")
    assert "AP" in m["bbox"] and "AP" in m["segm"]
    train_net.main(["--config-file", cfg_path, "--canvas-size", "64", "--dtype", "float32", "--eval-bs", "8",
                    "--device", "cpu", "--eval-only", "--test-json", json_path, "--test-image-dir", img_dir,
                    "MODEL.WEIGHTS", ckpt, "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 50.0, 50.0]]"])
    assert _read(out_dir, "metrics_eval_only.json").keys() == {"bbox", "segm"}


class _StubTrainer:
    """The trainer surface :func:`train_net.train_detector` drives, with a
    scripted total loss a step and no model."""

    def __init__(self, totals):
        self.totals, self.step, self.device = totals, torch.zeros((), dtype=torch.int32), torch.device("cpu")

    def train_step(self, batch):
        self.step += 1
        return {"loss_a": torch.tensor(1.0), "total": torch.tensor(self.totals(int(self.step)))}

    def checkpoint_tensors(self):
        return {"step": self.step}

    def checkpoint_tree(self, host):
        return {"step": np.asarray(host["step"], np.int32)}


def test_training_loop_logs_checkpoints_and_fails_fast(tmp_path):
    """Windows of 20 steps: a loss of 5000 under warmup (30 steps) passes,
    after it counts as corrupt; the checkpoints at 40 and 50 are skipped,
    and the second corrupt window (60) exits with code 3 without saving."""
    solver = {"max_iter": 100, "ims_per_batch": 2, "warmup_iters": 30, "checkpoint_period": 10, "eval_period": 0,
              "precise_bn": False, "precise_bn_iters": 0}
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as exit_info:
        train_net.train_detector(_StubTrainer(lambda s: 5000.0), solver, out, [lambda: {"x": np.zeros(1)}])
    assert exit_info.value.code == FATAL_EXIT_CODE
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) == [
        "model_0000010.ckpt", "model_0000020.ckpt", "model_0000030.ckpt"]
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iteration"] for x in lines] == [20, 40] and lines[0]["total"] == 5000.0
    assert {"loss_a", "total", "ips", "data_starved"} <= lines[0].keys()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(os.path.join(out, "tb")))
    summary = train_net.train_detector(_StubTrainer(lambda s: 0.5), dict(solver, max_iter=25), str(tmp_path / "ok"),
                                       [lambda: {"x": np.zeros(1)}])
    assert [os.path.basename(c["path"]) for c in summary["checkpoints"]] == [
        "model_0000010.ckpt", "model_0000020.ckpt", "model_0000025.ckpt"]
