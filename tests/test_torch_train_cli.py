"""The port's stage-1 CLI (``python -m unmore_tpu_torch.cli.train_objectness_net``).

On a tiny world of PNG files (written under the ImageNet/VoteCut names),
with tiny models put in place of the CLI's builders: both modes write the
JAX CLI's run layout; their checkpoints restore in the JAX trainer with
``target=`` and load in both packages' stage-2 loaders with equal outputs;
a JAX-written checkpoint resumes in the port's CLI; ``--eval_mode`` writes
its evaluation folder; a supervised run with ``UNMORE_FAULT_INJECT_AT``
exits 3 and resumes from the newest checkpoint. Also: the new modules and
host sources name no JAX package and import neither OpenCV nor PIL at
module level, and the CLI never moves to the CPU on its own.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from PIL import Image

from unmore_tpu.cli import common as jax_common
from unmore_tpu.config import OptimConfig as JaxOptimConfig
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.train import classifier as jax_classifier
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu.train.checkpoints import load_checkpoint, save_checkpoint as jax_save_checkpoint
from unmore_tpu_torch.cli import common, supervisor
from unmore_tpu_torch.cli import train_objectness_net as cli
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.train.resilience import FATAL_EXIT_CODE

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unmore_tpu_torch"
TINY = dict(depth=2, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TINY_DPT = dict(features=16, hooks=(0, 1, 1, 1), widths=(8, 16, 24, 24))
OBJECTNESS = ["--train_center_and_boundary", "--sdf_activation", "tanh", "--use_bg_sdf", "--use_sdf_gradient_loss",
              "--use_sdf_binary_mask_loss"]
TINY_BUILDERS = f"""
from unmore_tpu_torch.cli import train_objectness_net as cli
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig

cli.build_objectness_model = lambda a: ObjectnessNet("dpt_base", a.sdf_activation, a.use_bg_sdf,
                                                     vit_config=ViTConfig(**{TINY!r}), **{TINY_DPT!r})
cli.build_classifier_model = lambda a: BinaryClassifier(stage_blocks=(1, 1))
"""


def write_world(root: Path, n=6, size=64):
    """imagenet/<cls>/img.JPEG (PNG bytes) + masks/<cls>/img.png."""
    images, masks = root / "imagenet" / "n01", root / "masks" / "n01"
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        img = (rng.rand(size, size, 3) * 0.3 * 255).astype(np.uint8)
        mask = np.zeros((size, size), np.uint8)
        x, y = rng.randint(8, size // 2, 2)
        w, h = rng.randint(12, size // 3, 2)
        mask[y : y + h, x : x + w] = 255
        img[mask > 0] = (rng.rand(3) * 0.5 * 255 + 100).astype(np.uint8)
        Image.fromarray(img).save(images / f"img_{i:03d}.JPEG", format="PNG")
        Image.fromarray(mask).save(masks / f"img_{i:03d}.png")
    return ["--device", "cpu", "--imagenet_dir", str(root / "imagenet"), "--votecut_mask_dir", str(root / "masks"),
            "--image_size", "32", "--batch_size", "4", "--num_workers", "2", "--dtype", "float32"]


@pytest.fixture
def world(tmp_path, monkeypatch):
    for name in ("build_objectness_model", "build_classifier_model"):  # restored after the test
        monkeypatch.setattr(cli, name, getattr(cli, name))
    exec(TINY_BUILDERS, {})  # tiny models in place of the CLI's builders
    common_args = write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    return common_args


def flax_objectness():
    return FlaxObjectnessNet(backbone_type="dpt_base", vit_config=FlaxViTConfig(**TINY),
                             precision=jax.lax.Precision.HIGHEST, **TINY_DPT)


def test_objectness_run_layout_checkpoints_and_eval_mode(world):
    cli.main(world + OBJECTNESS + ["--run_name", "obj", "--train_iter", "3", "--save_ckpt_every", "2", "--log_every",
                                   "2", "--visualize_every", "4", "--N_vis", "2", "--lr_scheduler_gamma", "0.1"])
    run = Path("results_objectness/center_and_boundary/obj")
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["iter_2_model.ckpt", "iter_4_model.ckpt"]
    assert set(json.loads((run / "train_log.json").read_text())) == {"2", "4"}
    configs = json.loads((run / "configs.json").read_text())
    assert configs["run_name"] == "obj" and configs["batch_size"] == 4 and configs["lr_scheduler_gamma"] == 0.1
    assert any((run / "tb").iterdir())
    assert (run / "imgs" / "iter_4" / "s0_pred_sdf.png").exists() and (run / "imgs" / "iter_4" / "s1_gt_mask.png").exists()

    # the port's checkpoint restores in the JAX trainer, with the CLI's optimizer
    ckpt = str(run / "ckpt" / "iter_4_model.ckpt")
    tx = jax_objectness.make_optimizer(JaxOptimConfig(learning_rate=1e-4, lr_scheduler_milestones=(10000, 20000),
                                                      lr_scheduler_gamma=0.1))
    fmodel = flax_objectness()
    state = load_checkpoint(ckpt, target=jax_objectness.init_state(fmodel, tx, jax.random.PRNGKey(1), 32))
    assert int(state.step) == 4 and int(state.opt_state[0].count) == int(state.opt_state[1].count) == 4

    # both packages' stage-2 loaders read it, and the models agree
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    want = fmodel.apply({"params": jax_common.load_objectness_params(ckpt)}, jnp.asarray(x))
    model = ObjectnessNet("dpt_base", "tanh", True, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()
    common.load_objectness_weights(model, ckpt)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("sdf_maps", "center_fields"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4)

    cli.main(world + OBJECTNESS + ["--eval_mode", "--resume", ckpt, "--N_vis", "2"])
    assert (run / "evaluation" / "s1_pred_anti_center.png").exists()


def test_jax_checkpoint_resumes_in_the_port_cli(world, tmp_path):
    fmodel = flax_objectness()
    tx = jax_objectness.make_optimizer(JaxOptimConfig(learning_rate=1e-4, lr_scheduler_milestones=(10000, 20000),
                                                      lr_scheduler_gamma=1.0))
    state = jax_objectness.init_state(fmodel, tx, jax.random.PRNGKey(4), 32)
    state = state.replace(step=jnp.asarray(6, jnp.int32))
    jax_save_checkpoint(str(tmp_path / "jax.ckpt"), state)
    cli.main(world + OBJECTNESS + ["--run_name", "resumed", "--resume", str(tmp_path / "jax.ckpt"), "--train_iter", "7",
                                   "--save_ckpt_every", "8", "--log_every", "8"])
    run = Path("results_objectness/center_and_boundary/resumed")
    assert set(json.loads((run / "train_log.json").read_text())) == {"8"}
    restored = load_checkpoint(str(run / "ckpt" / "iter_8_model.ckpt"), target=state)
    assert int(restored.step) == 8 and int(restored.opt_state[0].count) == 2


def test_existence_run_eval_mode_and_both_loaders(world, tmp_path):
    cli.main(world + ["--train_existence", "--run_name", "ex", "--train_iter", "3", "--save_ckpt_every", "2",
                      "--log_every", "2", "--evaluate_every", "4", "--test_batch_size", "4"])
    run = Path("results_objectness/existence/ex")
    ckpt = str(run / "ckpt" / "iter_4_model.ckpt")
    assert set(json.loads((run / "eval_log.json").read_text())) == {"4"}
    dumps = os.listdir(run / "imgs" / "iter_4")
    assert dumps and all("_gt_" in d and "_pred_" in d for d in dumps)

    fmodel = FlaxBinaryClassifier(stage_blocks=(1, 1), precision=jax.lax.Precision.HIGHEST)
    tx = optax.adam(optax.piecewise_constant_schedule(1e-4, {10000: 1.0, 20000: 1.0}))
    state = load_checkpoint(ckpt, target=jax_classifier.init_classifier_state(fmodel, tx, jax.random.PRNGKey(2), 32))
    assert int(state.step) == 4
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    want = fmodel.apply(jax_common.load_classifier_variables(ckpt), jnp.asarray(x))
    model = BinaryClassifier(stage_blocks=(1, 1)).eval()
    common.load_classifier_weights(model, ckpt)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(want), atol=2e-5)

    cli.main(world + ["--train_existence", "--eval_mode", "--resume", ckpt, "--test_batch_size", "4"])
    assert "4" in json.loads((run / "evaluation" / "eval_log.json").read_text())
    loose = tmp_path / "loose"  # a checkpoint outside the run layout: evaluation beside it
    loose.mkdir()
    (loose / "model.ckpt").write_bytes(Path(ckpt).read_bytes())
    cli.main(world + ["--train_existence", "--eval_mode", "--resume", str(loose / "model.ckpt"), "--test_batch_size", "4"])
    assert (loose / "evaluation" / "eval_log.json").exists()


def test_supervised_fault_injection_exits_3_and_resumes(world, tmp_path):
    wrapper = tmp_path / "tiny_cli.py"
    wrapper.write_text(TINY_BUILDERS + "\nimport sys\ncli.main(sys.argv[1:])\n")
    marker = tmp_path / "fault_marker"
    args = world + ["--train_existence", "--run_name", "sup", "--train_iter", "5", "--save_ckpt_every", "2",
                    "--log_every", "2", "--evaluate_every", "100"]
    run_dir = "results_objectness/existence/sup"
    env = dict(os.environ, PYTHONPATH=str(ROOT), UNMORE_FAULT_INJECT_AT=f"4:{marker}", OMP_NUM_THREADS="2")
    code = (f"import sys; from unmore_tpu_torch.cli import supervisor, train_objectness_net as cli\n"
            f"base = [sys.executable, {str(wrapper)!r}, *{args!r}]\n"
            f"sys.exit(supervisor.run_resuming(base, lambda: cli.find_last_stage1_checkpoint({run_dir!r}), 2, 0))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-3000:]
    # windows 4 and 6 are corrupt: no checkpoint at 6, exit 3 without saving
    assert "skipping checkpoint at iter 6 (last window corrupt)" in log
    assert "FATAL: 2 consecutive corrupt loss windows at iter 6" in log
    assert "supervisor: child died (fail-fast)" in log
    # the fatal exit waits for iter 4's write: the restart resumes from it
    resumed = re.search(rf"resumed from {run_dir}/ckpt/iter_(\d)_model.ckpt at iter (\d)", log)
    assert resumed and resumed.group(1) == resumed.group(2) == "4", log[-3000:]
    assert marker.exists()
    assert cli.find_last_stage1_checkpoint(run_dir).endswith("iter_6_model.ckpt")


def test_fatal_exit_waits_for_the_checkpoint_in_flight(world, tmp_path, monkeypatch):
    """Windows 4 and 6 are corrupt: the checkpoint of iter 4 is scheduled
    before window 4 is read, and its write, slowed by 0.5 s, is still in
    flight at the fatal exit of iter 6. ``_fatal`` waits for it."""
    from unmore_tpu_torch.train import checkpoints

    save = checkpoints.save_checkpoint

    def slow_save(path, tree):
        time.sleep(0.5)
        return save(path, tree)

    monkeypatch.setattr(checkpoints, "save_checkpoint", slow_save)
    monkeypatch.setenv("UNMORE_FAULT_INJECT_AT", f"4:{tmp_path / 'fault_marker'}")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(world + ["--train_existence", "--run_name", "slow", "--train_iter", "7", "--save_ckpt_every", "2",
                          "--log_every", "2", "--evaluate_every", "100"])
    assert exit_info.value.code == FATAL_EXIT_CODE
    ckpts = sorted(os.listdir("results_objectness/existence/slow/ckpt"))
    assert ckpts == ["iter_2_model.ckpt", "iter_4_model.ckpt"], ckpts


def test_supervisor_flag_pins_the_run_and_resumes(monkeypatch):
    seen = {}

    def fake_supervise(build, max_restarts, hang_timeout=None):
        seen.update(first=build(0), restart=build(1), max_restarts=max_restarts, hang=hang_timeout)
        return 0

    monkeypatch.setattr(supervisor, "supervise", fake_supervise)
    monkeypatch.setattr(cli, "find_last_stage1_checkpoint", lambda run_dir: f"{run_dir}/ckpt/iter_9_model.ckpt")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--train_existence", "--max_restarts", "3", "--resume", "old.ckpt", "--batch_size", "2"])
    assert exit_info.value.code == 0 and seen["max_restarts"] == 3 and seen["hang"] == 40.0 * 60
    first, restart = seen["first"], seen["restart"]
    assert first[1:3] == ["-m", "unmore_tpu_torch.cli.train_objectness_net"] and "--max_restarts" not in first
    run_name = first[first.index("--run_name") + 1]
    assert run_name.endswith("_ImageNet_votecut_top1_Dataset_dpt_large")
    assert first[first.index("--resume") + 1] == "old.ckpt"
    assert restart.count("--resume") == 1  # the restart resumes from the run's newest checkpoint
    assert restart[restart.index("--resume") + 1] == f"results_objectness/existence/{run_name}/ckpt/iter_9_model.ckpt"


def test_vit_pack_is_ignored_and_no_cpu_fallback(monkeypatch, tmp_path):
    # --vit_pack is accepted and ignored: a value that does not divide the batch of 16, which the JAX CLI
    # refuses, goes on to the device; without a card neither trainer falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--train_center_and_boundary", "--batch_size", "16", "--vit_pack", "3"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--train_existence", "--imagenet_dir", str(tmp_path), "--votecut_mask_dir", str(tmp_path)])


def test_new_sources_stand_alone():
    pattern = re.compile(r"\bunmore_tpu\b(?!_torch)|^\s*(import|from)\s+(jax|flax|optax|msgpack|cv2)\b", re.M)
    top_level_pil = re.compile(r"^(import|from)\s+PIL\b", re.M)
    files = sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*.cpp")) + [ROOT / "chip_smoke.py"]
    assert PORT / "csrc" / "labels.cpp" in files and PORT / "train" / "optim.py" in files
    hits = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in files for m in pattern.finditer(p.read_text())]
    assert not hits, hits
    assert not [p for p in files if top_level_pil.search(p.read_text())]
