"""The whole three-stage chain on a synthetic shape world, unattended (the
port's counterpart of ``scripts/scale_chain_r5.sh`` with the steps of
``scripts/scale_run_r5.sh``).

    python -m unmore_tpu_torch.scripts.scale_chain --work WORK [--synth WORLD] \\
        [--steps world stage1 existence discovery scoring post_eval merge cad max_active_ab sticky_ab] \\
        [--device cpu] [knobs]

Each step runs the port's CLIs as child processes from ``--work``, so that
every file lands there:

1. ``world``: ``make_synthetic_shapes`` and ``make_imagenet_training_json``
   into ``--synth``, in this process (skipped when they are there);
2. ``stage1`` and ``existence``: ``cli.train_objectness_net`` for the
   objectness net and the existence classifier, supervised
   (``--max_restarts``), resuming from their newest periodic checkpoint when
   an earlier chain was cut, skipped when the final checkpoint is there;
3. ``discovery``: ``cli.object_reasoning`` in segments of ``--seg`` scenes,
   each a fresh supervised process with its own result folder, then the
   segments merged into ``results_reasoning/<run>/discovery_results.json``
   and their stats lines into ``discovery_stats_r5.json``;
4. ``scoring``: ``cli.object_scoring`` on the merged boxes;
5. ``post_eval``: the repository's ``post_process.py``, then
   ``cli.coco_eval`` against the GT of the discovered scenes only, into
   ``ap_score_pseudo.json``;
6. ``merge``: the repository's ``merge_coco_and_imagenet.py`` with the
   world's ImageNet training JSON;
7. ``cad``: ``cli.train_net`` on the merged labels, supervised, with
   PreciseBN and evaluation on the world's scenes;
8. ``max_active_ab``: ``scripts.max_active_ab`` on the dense tail (the
   first ``--ab_end`` scenes): the merged scored file of ``scoring``
   (discovered at ``--max_active``) against discovery and scoring again at
   ``--ab_max_active``, into ``max_active_ab_results.json``;
9. ``sticky_ab``: ``scripts.sticky_ab`` on the same scenes, sticky
   convergence against the reference's rounds, into
   ``sticky_ab_results.json``.

The files are those of the JAX chain, under the same names:
``scale_timings.txt`` (``HH:MM:SS @epoch <stage> start|done``),
``step_<name>.log``, the segment logs ``<run>_<s>_<e>.log``,
``scoring_r5.log``, ``coco_eval_r5.log``, ``cad_r5.log``,
``max_active_ab_r5.log``, ``sticky_ab_r5.log``,
``gt_discovered_subset.json``, and ``failed_steps.txt``: a step that fails
is recorded there and the chain goes on (the exit code is then 1). At the
end the chain writes ``scale_report.json`` (``scale_report``). The knobs
default to the r5 run's (``scale_run_r5.sh:33-101``), less those of the TPU
build's watchdogs (``BOUNDARY_SEG``, the busy-hang timeouts), which the
port's CLIs accept and ignore; the stats count the world's first
``round(scenes * dense_frac)`` scenes as dense, where r5 fixed 100 for its
500; ``--ab_end`` and ``--ab_max_active`` stand for r5's ``AB_END`` and
the truncated lattice of 1024 that its step 8 fixes. ``--device`` goes to
every CLI and A/B script, whose default is the card; the A/B scripts write
into ``--work``, never over the records under ``scripts/``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[2])
STEPS = ("world", "stage1", "existence", "discovery", "scoring", "post_eval", "merge", "cad", "max_active_ab",
         "sticky_ab")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", required=True, help="the chain's folder: every step runs and writes here")
    p.add_argument("--synth", default=None, help="the world's folder (default: <work>/synth)")
    p.add_argument("--steps", nargs="+", default=list(STEPS), choices=STEPS)
    p.add_argument("--device", default=None, help="torch device of every CLI (default: their own, the card)")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="--dtype of every model CLI (default: theirs, bfloat16; float32 for runs on the CPU)")
    w = p.add_argument_group("world")
    w.add_argument("--scenes", type=int, default=500)
    w.add_argument("--size", type=int, default=480, help="scene side in pixels")
    w.add_argument("--stage1_n", type=int, default=1200)
    w.add_argument("--dense_frac", type=float, default=0.2)
    w.add_argument("--dense_objects", type=int, default=50)
    t = p.add_argument_group("stage 1 and the CAD")
    t.add_argument("--backbone", default="dpt_large")
    t.add_argument("--s1_iters", type=int, default=5000)
    t.add_argument("--s1_batch", type=int, default=20)
    t.add_argument("--save_every", type=int, default=1000)
    t.add_argument("--exist_iters", type=int, default=500)
    t.add_argument("--exist_batch", type=int, default=20)
    t.add_argument("--exist_save", type=int, default=250)
    t.add_argument("--train_restarts", type=int, default=3, help="--max_restarts of the three trainers")
    t.add_argument("--cad_config", default=os.path.join(REPO, "cad", "configs", "cascade_mask_rcnn_R_50_FPN.yaml"))
    t.add_argument("--cad_canvas", type=int, default=None, help="--canvas-size of the CAD (default: the CLI's)")
    t.add_argument("--cad_iters", type=int, default=2500)
    t.add_argument("--cad_step", type=int, default=1500)
    t.add_argument("--cad_batch", type=int, default=8)
    t.add_argument("--cad_ckpt_period", type=int, default=300)
    t.add_argument("--cad_eval_period", type=int, default=1000)
    t.add_argument("--cad_out", default=None, help="the CAD's OUTPUT_DIR (default: <work>/cad_r5)")
    d = p.add_argument_group("stage 2")
    d.add_argument("--run", default="disc_r5", help="the discovery run name")
    d.add_argument("--disc_scenes", type=int, default=None, help="scenes to discover (default: all)")
    d.add_argument("--disc_start", type=int, default=0, help="first scene of the first segment")
    d.add_argument("--seg", type=int, default=100, help="scenes a discovery process")
    d.add_argument("--canvas", type=int, default=512)
    d.add_argument("--image_batch", type=int, default=4)
    d.add_argument("--max_active", type=int, default=1536)
    d.add_argument("--max_proposals", type=int, default=2048)
    d.add_argument("--max_splits", type=int, default=3072)
    d.add_argument("--n_round", type=int, default=50)
    d.add_argument("--crop_chunk", type=int, default=None,
                   help="stage 2's model microbatch (default: the CLIs', 256 and 128; smaller for runs on the CPU)")
    d.add_argument("--disc_restarts", type=int, default=3)
    d.add_argument("--disc_hang_min", type=float, default=45.0)
    d.add_argument("--score_hang_min", type=float, default=None, help="default: --disc_hang_min")
    b = p.add_argument_group("the dense-tail A/Bs")
    b.add_argument("--ab_end", type=int, default=40, help="the A/Bs run on scenes [0, ab_end), the world's dense first")
    b.add_argument("--ab_max_active", type=int, default=1024, help="the truncated leg's boundary lattice")
    args = p.parse_args(argv)
    if args.s1_iters % args.save_every or args.exist_iters % args.exist_save:
        # the next stages read each trainer's checkpoint of its last step
        p.error("--s1_iters and --exist_iters must be multiples of --save_every and --exist_save")
    args.work = os.path.abspath(args.work)
    args.synth = os.path.abspath(args.synth or os.path.join(args.work, "synth"))
    args.cad_out = os.path.abspath(args.cad_out or os.path.join(args.work, "cad_r5"))
    if args.disc_scenes is None:
        args.disc_scenes = args.scenes
    if args.score_hang_min is None:
        args.score_hang_min = args.disc_hang_min
    return args


def latest_ckpt(folder: str) -> str | None:
    """The newest ``iter_N_model.ckpt`` in ``folder`` by N (``iter_10000``
    after ``iter_2000``); in-flight ``.tmp`` writes do not count."""
    found = []
    for path in glob.glob(os.path.join(folder, "iter_*_model.ckpt")):
        m = re.fullmatch(r"iter_(\d+)_model\.ckpt", os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return max(found)[1] if found else None


class Chain:
    """One chain run: the knobs, the work folder and its logs."""

    def __init__(self, args):
        self.a = args
        self.obj_ckpt = os.path.join(args.work, "results_objectness", "center_and_boundary", "s1_r5", "ckpt",
                                     f"iter_{args.s1_iters}_model.ckpt")
        self.cls_ckpt = os.path.join(args.work, "results_objectness", "existence", "exist_r5", "ckpt",
                                     f"iter_{args.exist_iters}_model.ckpt")
        self.step_log = None

    # -------------------------------------------------------------- plumbing
    def stamp(self, label: str) -> None:
        """A ``scale_timings.txt`` line: wall clock, exact epoch seconds, label."""
        with open(os.path.join(self.a.work, "scale_timings.txt"), "a") as f:
            f.write(f"{time.strftime('%H:%M:%S', time.gmtime())} @{int(time.time())} {label}\n")

    def device(self) -> list:
        """The device and dtype flags of a model CLI, where set."""
        a = self.a
        return (["--device", a.device] if a.device else []) + (["--dtype", a.dtype] if a.dtype else [])

    def chunk(self) -> list:
        return ["--crop_chunk", str(self.a.crop_chunk)] if self.a.crop_chunk else []

    def run(self, cmd: list, log: str | None = None, append: bool = False) -> None:
        """Run ``cmd`` from the work folder, its output into the step log
        (and ``log``, under the work folder); raise on a non-zero exit."""
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        sinks = [self.step_log] + ([open(os.path.join(self.a.work, log), "a" if append else "w")] if log else [])
        try:
            for s in sinks:
                s.write(f"$ {' '.join(cmd)}\n")
                s.flush()
            proc = subprocess.Popen(cmd, cwd=self.a.work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, errors="replace")
            for line in proc.stdout:
                for s in sinks:
                    s.write(line)
                    s.flush()
            rc = proc.wait()
        finally:
            for s in sinks[1:]:
                s.close()
        if rc:
            raise RuntimeError(f"exit {rc}: {' '.join(cmd)}")

    @staticmethod
    def module(name: str) -> list:
        return [sys.executable, "-u", "-m", name]

    def say(self, msg: str) -> None:
        print(f"{time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime())} [chain] {msg}", flush=True)

    # ----------------------------------------------------------------- steps
    def step_world(self):
        from unmore_tpu_torch.scripts import make_imagenet_training_json, make_synthetic_shapes

        a = self.a
        self.stamp("world start")
        with contextlib.redirect_stdout(self.step_log):  # in this process: no model, no card
            if not os.path.isfile(os.path.join(a.synth, "coco", "instances.json")):
                make_synthetic_shapes.main([
                    "--out", a.synth, "--stage1_n", str(a.stage1_n), "--scenes", str(a.scenes), "--size", str(a.size),
                    "--dense_frac", str(a.dense_frac), "--dense_objects", str(a.dense_objects)])
            if not os.path.isfile(os.path.join(a.synth, "imagenet_training.json")):
                make_imagenet_training_json.main(["--synth", a.synth,
                                                  "--out", os.path.join(a.synth, "imagenet_training.json")])
        self.stamp("world done")

    def _trainer(self, stage: str, final: str, flags: list) -> None:
        if os.path.isfile(final):
            self.stamp(f"{stage} already complete")
            return
        resume = []
        last = latest_ckpt(os.path.dirname(final))
        if last:
            # on its own line: a restamped start scopes the wall to the resumed leg
            self.stamp(f"{stage} resume from {last}")
            resume = ["--resume", last]
        self.stamp(f"{stage} start")
        self.run(self.module("unmore_tpu_torch.cli.train_objectness_net") + flags + resume + self.device()
                 + ["--max_restarts", str(self.a.train_restarts)])
        if not os.path.isfile(final):  # e.g. a corrupt last loss window skipped it
            raise RuntimeError(f"{stage} ended without its final checkpoint {final}")
        self.stamp(f"{stage} done")

    def step_stage1(self):
        a = self.a
        self._trainer("stage1", self.obj_ckpt, [
            "--train_center_and_boundary", "--dataset", "ImageNet_votecut_top1_Dataset", "--backbone_type", a.backbone,
            "--optimizer", "adam", "--learning_rate", "1e-4", "--lr_scheduler_gamma", "0.1",
            "--batch_size", str(a.s1_batch), "--sdf_loss_type", "l1", "--center_field_loss_type", "l2",
            "--use_sdf_binary_mask_loss", "--use_sdf_gradient_loss", "--use_bg_sdf",
            "--imagenet_dir", os.path.join(a.synth, "imagenet"), "--votecut_mask_dir", os.path.join(a.synth, "masks"),
            "--train_iter", str(a.s1_iters), "--save_ckpt_every", str(a.save_every), "--visualize_every", "100000",
            "--num_workers", "2", "--run_name", "s1_r5", "--spike_guard_warmup", "1000"])

    def step_existence(self):
        a = self.a
        self._trainer("existence", self.cls_ckpt, [
            "--train_existence", "--dataset", "ImageNet_votecut_labeled_classifier_Dataset",
            "--imagenet_dir", os.path.join(a.synth, "imagenet"), "--votecut_mask_dir", os.path.join(a.synth, "masks"),
            "--batch_size", str(a.exist_batch), "--learning_rate", "1e-4", "--train_iter", str(a.exist_iters),
            "--save_ckpt_every", str(a.exist_save), "--num_workers", "2", "--run_name", "exist_r5"])

    def discovery_argv(self, start: int, end: int) -> list:
        """The discovery CLI's flags for scenes [start, end), supervision aside."""
        a = self.a
        return ["--backbone_type", a.backbone, "--use_bg_sdf", "--analyze_cc",
                "--objectness_resume", self.obj_ckpt, "--binary_classifier_resume", self.cls_ckpt,
                "--coco_image_dir", os.path.join(a.synth, "coco", "images"),
                "--coco_annotations", os.path.join(a.synth, "coco", "instances.json"),
                "--run_name", a.run, "--image_batch", str(a.image_batch), "--canvas_size", str(a.canvas),
                "--max_active", str(a.max_active), "--max_proposals", str(a.max_proposals),
                "--max_splits", str(a.max_splits), "--n_round", str(a.n_round),
                "--start_idx", str(start), "--end_idx", str(end),
                *self.device(), *self.chunk()]

    def step_discovery(self):
        from unmore_tpu_torch.scripts import parse_discovery_stats

        a = self.a
        s = a.disc_start
        while s < a.disc_scenes:
            e = min(s + a.seg, a.disc_scenes)
            folder = os.path.join(a.work, "results_reasoning", f"{a.run}_{s}_{e}")
            if os.path.isfile(os.path.join(folder, "discovery_results.json")):
                self.stamp(f"discovery seg {s}-{e} already complete")
                s = e
                continue
            self.stamp(f"discovery seg {s}-{e} start")
            # a relaunch of a half-done segment appends, so that every attempt's stats lines stay
            relaunch = os.path.isfile(os.path.join(folder, "partial_results_p0.jsonl"))
            self.run(self.module("unmore_tpu_torch.cli.object_reasoning") + self.discovery_argv(s, e)
                     + ["--max_restarts", str(a.disc_restarts), "--hang_timeout_min", str(a.disc_hang_min)],
                     log=f"{a.run}_{s}_{e}.log", append=relaunch)
            self.stamp(f"discovery seg {s}-{e} done")
            s = e
        merged = {}
        for path in sorted(glob.glob(os.path.join(a.work, "results_reasoning", f"{a.run}_*_*",
                                                  "discovery_results.json"))):
            with open(path) as f:
                merged.update(json.load(f))
        out = os.path.join(a.work, "results_reasoning", a.run)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "discovery_results.json"), "w") as f:
            json.dump(merged, f)
        self.step_log.write(f"merged {len(merged)} images\n")
        # the step log accumulates every attempt's lines; the parser keeps an image's last
        logs = sorted(glob.glob(os.path.join(a.work, f"{a.run}_*.log"))) + [self.step_log.name]
        self.step_log.flush()
        # the world's dense scenes are its first ids
        parse_discovery_stats.main(logs + ["--dense_upto", str(round(a.scenes * a.dense_frac)),
                                           "--out", os.path.join(a.work, "discovery_stats_r5.json")])

    def step_scoring(self):
        a = self.a
        self.stamp("scoring start")
        relaunch = os.path.isfile(os.path.join(a.work, "results_reasoning", a.run, "scoring_partial_p0.jsonl"))
        self.run(self.module("unmore_tpu_torch.cli.object_scoring") + [
            "--backbone_type", a.backbone, "--use_bg_sdf",
            "--objectness_resume", self.obj_ckpt, "--binary_classifier_resume", self.cls_ckpt,
            "--coco_image_dir", os.path.join(a.synth, "coco", "images"),
            "--coco_annotations", os.path.join(a.synth, "coco", "instances.json"),
            "--raw_annotations_path", f"results_reasoning/{a.run}/discovery_results.json",
            "--image_batch", str(a.image_batch), "--canvas_size", str(a.canvas),
            "--max_restarts", str(a.disc_restarts), "--hang_timeout_min", str(a.score_hang_min)]
            + self.device() + self.chunk(),
            log="scoring_r5.log", append=relaunch)
        self.stamp("scoring done")

    def step_post_eval(self):
        from unmore_tpu_torch.data.coco import COCOImages

        a = self.a
        self.stamp("post start")
        scored = f"results_reasoning/{a.run}/object_discovery_with_scores.json"
        gt_path = os.path.join(a.synth, "coco", "instances.json")
        self.run([sys.executable, "-u", os.path.join(REPO, "post_process.py"), "--pred_annotations_path", scored,
                  "--gt_annotation_path", gt_path])
        # the GT of the discovered scenes only: a scene never discovered would count as all misses
        scenes = COCOImages(os.path.join(a.synth, "coco", "images"), gt_path, 0, a.disc_scenes)
        covered = {int(scenes.image_id(i)) for i in range(len(scenes))}
        with open(gt_path) as f:
            gt = json.load(f)
        gt["images"] = [im for im in gt["images"] if im["id"] in covered]
        gt["annotations"] = [x for x in gt["annotations"] if x["image_id"] in covered]
        subset = os.path.join(a.work, "gt_discovered_subset.json")
        with open(subset, "w") as f:
            json.dump(gt, f)
        self.step_log.write(f"eval GT subset: {len(gt['images'])} images, {len(gt['annotations'])} anns\n")
        self.run(self.module("unmore_tpu_torch.cli.coco_eval") + [
            "--gt_annotations_path", subset, "--pred_annotations_path", scored, "--tasks", "bbox", "segm",
            "--out_path", os.path.join(a.work, "ap_score_pseudo.json")], log="coco_eval_r5.log")
        self.stamp("post+eval done")

    def step_merge(self):
        a = self.a
        self.run([sys.executable, "-u", os.path.join(REPO, "merge_coco_and_imagenet.py"),
                  "--coco_annotations_training_format_path",
                  f"results_reasoning/{a.run}/selected_training_annotations.json",
                  "--imagenet_annotations_training_format_path", os.path.join(a.synth, "imagenet_training.json")])

    def step_cad(self):
        a = self.a
        self.stamp("cad start")
        merged = os.path.join(a.work, "results_reasoning", a.run, "merged_with_imagenet",
                              "COCO_merged_IN_training_format.json")
        canvas = ["--canvas-size", str(a.cad_canvas)] if a.cad_canvas else []
        self.run(self.module("unmore_tpu_torch.cli.train_net") + [
            "--config-file", a.cad_config, *canvas, "--train-json", merged,
            "--image-root", f"coco={os.path.join(a.synth, 'coco', 'images')}",
            "--image-root", f"imagenet={os.path.join(a.synth, 'imagenet')}",
            "--test-json", os.path.join(a.synth, "coco", "instances.json"),
            "--test-image-dir", os.path.join(a.synth, "coco", "images"),
            "--train-workers", "4", "--max-restarts", str(a.train_restarts), *self.device(),
            "SOLVER.MAX_ITER", str(a.cad_iters), "SOLVER.STEPS", f"[{a.cad_step}]",
            "SOLVER.CHECKPOINT_PERIOD", str(a.cad_ckpt_period), "SOLVER.IMS_PER_BATCH", str(a.cad_batch),
            "TEST.EVAL_PERIOD", str(a.cad_eval_period), "OUTPUT_DIR", a.cad_out],
            log=os.path.basename(a.cad_out) + ".log")
        self.stamp("cad done")

    def ab_argv(self) -> list:
        """The flags both A/B scripts take from the chain's knobs."""
        a = self.a
        return ["--synth", a.synth, "--backbone_type", a.backbone, "--objectness", self.obj_ckpt,
                "--classifier", self.cls_ckpt, "--canvas_size", str(a.canvas), "--image_batch", str(a.image_batch),
                "--start_idx", "0", "--end_idx", str(a.ab_end), *self.device()]

    def step_max_active_ab(self):
        a = self.a
        self.stamp("max_active_ab start")
        self.run(self.module("unmore_tpu_torch.scripts.max_active_ab") + self.ab_argv() + [
            "--main_scored", os.path.join(a.work, "results_reasoning", a.run, "object_discovery_with_scores.json"),
            "--main_max_active", str(a.max_active), "--max_active", str(a.ab_max_active),
            "--out", os.path.join(a.work, "max_active_ab_results.json")], log="max_active_ab_r5.log")
        self.stamp("max_active_ab done")

    def step_sticky_ab(self):
        self.stamp("sticky_ab start")
        self.run(self.module("unmore_tpu_torch.scripts.sticky_ab") + self.ab_argv()
                 + ["--out", os.path.join(self.a.work, "sticky_ab_results.json")], log="sticky_ab_r5.log")
        self.stamp("sticky_ab done")

    # ------------------------------------------------------------------ chain
    def main(self) -> int:
        a = self.a
        os.makedirs(a.work, exist_ok=True)
        smi = shutil.which("nvidia-smi")
        if smi and a.device != "cpu":
            card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip()
            with open(os.path.join(a.work, "card.txt"), "w") as f:
                f.write(card + "\n")
        failed = []
        for step in a.steps:
            name = f"step_{step}"
            self.say(f"=== {name} start ===")
            with open(os.path.join(a.work, f"{name}.log"), "a") as self.step_log:
                try:
                    getattr(self, name)()
                except Exception as exc:  # a failed step is recorded, and the chain goes on
                    self.step_log.write(f"FAILED: {exc!r}\n")
                    failed.append(name)
                    with open(os.path.join(a.work, "failed_steps.txt"), "a") as f:
                        f.write(name + "\n")
                    self.say(f"=== {name} FAILED ({exc}); continuing ===")
                    continue
            self.say(f"=== {name} OK ===")
        from unmore_tpu_torch.scripts import scale_report

        scale_report.main(["--work", a.work, "--out", os.path.join(a.work, "scale_report.json")])
        self.say("chain complete" + (f"; failed: {' '.join(failed)}" if failed else ""))
        return 1 if failed else 0


def main(argv=None):
    sys.exit(Chain(parse_args(argv)).main())


if __name__ == "__main__":
    main()
