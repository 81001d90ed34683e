"""The port's whole chain on a tiny CPU world (twin of ``tests/test_scale_chain.py``).

``python -m unmore_tpu_torch.scripts.scale_chain --device cpu --dtype float32
--crop_chunk 16`` at the JAX smoke's knobs (``tests/test_scale_chain.py``: 2 scenes, 1 dense, 6 stage-1
images at 128 px, 2 steps of each trainer, dpt_base, one scene a discovery
process, 4 boundary rounds, a 2-step CAD of the tiny config on a 64 px
canvas): the chain ends with no failed step and leaves every file whose
presence the JAX twin checks, under the same names.
"""

import json
import os
import subprocess
import sys

import pytest

from tests.test_scale_chain import TINY_CAD_YAML
from unmore_tpu_torch.scripts import scale_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_scale_chain_on_the_cpu(tmp_path):
    work, world = tmp_path / "work", tmp_path / "world"
    cad_cfg = tmp_path / "tiny_cad.yaml"
    cad_cfg.write_text(TINY_CAD_YAML)
    # f32 and model chunks of 16 crops on the CPU (bf16 is emulated there, and a 256-crop chunk of the
    # 1024-channel heads at 128^2 holds 8.6 GB an activation)
    argv = ["--work", str(work), "--synth", str(world), "--device", "cpu", "--dtype", "float32", "--crop_chunk", "16",
            "--scenes", "2", "--stage1_n", "6", "--dense_frac", "0.5", "--dense_objects", "4", "--size", "128",
            "--s1_iters", "2", "--save_every", "2", "--s1_batch", "2", "--backbone", "dpt_base",
            "--exist_iters", "2", "--exist_save", "2", "--exist_batch", "2",
            "--canvas", "128", "--image_batch", "1", "--seg", "1",
            "--max_active", "256", "--max_proposals", "512", "--max_splits", "512", "--n_round", "4",
            "--cad_iters", "2", "--cad_step", "1", "--cad_batch", "2", "--cad_config", str(cad_cfg),
            "--cad_canvas", "64", "--cad_eval_period", "0",
            # the JAX twin trims the A/B steps too: a 256-crop model chunk of theirs does not fit a CPU run
            "--steps", *[s for s in scale_chain.STEPS if not s.endswith("_ab")]]
    proc = subprocess.run([sys.executable, "-m", "unmore_tpu_torch.scripts.scale_chain", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=3600)
    failed = work / "failed_steps.txt"
    if failed.exists():
        steps = failed.read_text().split()
        logs = "\n".join(f"--- {s}:\n" + (work / f"{s}.log").read_text()[-3000:] for s in steps)
        raise AssertionError(f"failed steps {steps}\n{logs}\nchain:\n{proc.stdout[-2000:]}")
    assert proc.returncode == 0 and "chain complete" in proc.stdout, proc.stdout[-2000:] + proc.stderr[-2000:]

    # the JAX twin's stage contracts
    assert (world / "coco" / "instances.json").is_file()
    assert (world / "imagenet_training.json").is_file()
    disc = work / "results_reasoning" / "disc_r5" / "discovery_results.json"
    with open(disc) as f:
        assert isinstance(json.load(f), dict)
    with open(work / "discovery_stats_r5.json") as f:
        stats = json.load(f)
    assert stats["all"]["images"] == 2 and stats["all"]["seed_boxes_total"] > 0
    assert (work / "results_reasoning" / "disc_r5" / "object_discovery_with_scores.json").is_file()
    assert (work / "ap_score_pseudo.json").is_file()
    assert (work / "results_reasoning" / "disc_r5" / "merged_with_imagenet"
            / "COCO_merged_IN_training_format.json").is_file()
    assert (work / "cad_r5" / "model_0000002.ckpt").is_file()
    timings = (work / "scale_timings.txt").read_text()
    for stage in ("world", "stage1", "existence", "scoring", "cad"):
        assert f"{stage} start" in timings and f"{stage} done" in timings
    report = json.loads((work / "scale_report.json").read_text())
    # two steps of training leave no boxes to score: the scoring log then has no timing split
    assert report["discovery"]["all"]["images"] == 2 and "final_annotations" in report["scoring"]
    assert set(report["stage_wall_s"]) >= {"world", "stage1", "existence", "scoring", "post+eval", "cad"}
