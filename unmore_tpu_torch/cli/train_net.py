"""CAD detector training and evaluation CLI on every card of a host, or of
several (port of ``cad/train_net.py``).

    python -m unmore_tpu_torch.cli.train_net \\
        --config-file cad/configs/cascade_mask_rcnn_R_50_FPN.yaml \\
        --train-json selected_training_annotations.json \\
        --image-root coco=/data/train2017 --image-root imagenet=/data/imagenet/train \\
        --test-json instances_val2017.json --test-image-dir /data/val2017 [--resume]
    python -m unmore_tpu_torch.cli.train_net --eval-only \\
        --config-file cad/configs/cascade_mask_rcnn_R_50_FPN.yaml \\
        --test-json instances.json --test-image-dir images MODEL.WEIGHTS model_0030000.ckpt

The JAX CLI's flags, YAML configs (``_BASE_`` inheritance, dotted ``opts``)
and files: ``OUTPUT_DIR/config.yaml`` (JSON text, which YAML readers
read), ``metrics.json`` (a line every 20 steps), TensorBoard scalars under
``tb/``, ``model_NNNNNNN.ckpt`` every ``SOLVER.CHECKPOINT_PERIOD`` steps and
at ``MAX_ITER`` (the JAX package's msgpack ``DetectorTrainState``, which
either package resumes), ``coco_instances_results.json`` and
``metrics_<tag>.json`` of each evaluation (every ``TEST.EVAL_PERIOD`` steps,
after PreciseBN when ``TEST.PRECISE_BN.ENABLED``; ``TEST.EXPECTED_RESULTS``
gates only the last one and ``--eval-only``). Training keeps f32 master
weights and runs the forward under bf16 autocast (``--dtype bfloat16``);
the batches come from ``--train-workers`` prefetch threads.
``MODEL.WEIGHTS`` (or ``--resume``, the newest checkpoint in
``OUTPUT_DIR``) takes a JAX or port checkpoint; a whole training state
resumes as it was, weights alone (or a state dict of this port) start a
fresh run from them; without one the detector gets random weights from
seed 0. Images are evaluated ``--eval-bs`` at a time (4 by default), the
last batch padded with blank images, decoded on ``--eval-workers`` threads
while the device runs. ``--max-restarts N`` relaunches the run as a
supervised child (with ``--resume``, one rank only); a run whose loss
windows look corrupt twice in a row exits with code 3 without saving.

Training and evaluation run data-parallel over every visible card, one rank
each, spawned here unless torchrun (or the JAX package's ``JAX_*``
variables, one process per host) started them, as the JAX CLI runs over
every chip of every process: ``SOLVER.REFERENCE_WORLD_SIZE`` rescales the
solver to the rank count, ``IMS_PER_BATCH`` is the global batch (divisible
by it), each host draws the JAX process's stream (worker seeds
``1000 + 17 * host + w``) and each of its ranks trains on its rows; the
images to evaluate are sharded over the ranks and rank 0 evaluates the
gathered predictions and writes every file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np

from unmore_tpu_torch.cli import supervisor

IGNORED = "accepted for compatibility and ignored by this build"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", type=str, default=None)
    p.add_argument("--num-gpus", type=int, default=1,
                   help=IGNORED + ", as by the JAX CLI: every visible card runs a rank")
    p.add_argument("--num-machines", type=int, default=1,
                   help=IGNORED + ", as by the JAX CLI: hosts join through torchrun or JAX_NUM_PROCESSES")
    p.add_argument("--machine-rank", type=int, default=0,
                   help=IGNORED + ", as by the JAX CLI: a host's index comes from torchrun or JAX_PROCESS_ID")
    p.add_argument("--dist-url", type=str, default=None,
                   help=IGNORED + ", as by the JAX CLI: the address comes from torchrun or JAX_COORDINATOR_ADDRESS")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--test-dataset", type=str, default="")
    p.add_argument("--train-dataset", type=str, default="")
    p.add_argument("--no-segm", action="store_true")
    p.add_argument("--train-json", type=str, default=None)
    p.add_argument("--image-root", action="append", default=[],
                   help="PREFIX=DIR (e.g. coco=/data/train2017); repeatable")
    p.add_argument("--test-json", type=str, default=None)
    p.add_argument("--test-image-dir", type=str, default=None)
    p.add_argument("--data-root", type=str, default=None,
                   help="resolve --test-dataset names via the dataset registry")
    p.add_argument("--canvas-size", type=int, default=1024)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--eval-bs", type=int, default=0, help="eval inference batch of a rank (0 = auto: 4)")
    p.add_argument("--eval-workers", type=int, default=2, help="image-decode threads overlapping the device")
    p.add_argument("--train-workers", type=int, default=4,
                   help="training prefetch threads (decode + copy-paste); raise on many-core hosts if data_starved "
                        "grows")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="supervise a one-rank run: relaunch it (with --resume) up to N times after a crash, a "
                        "kill or --hang-timeout-min of output silence")
    p.add_argument("--hang-timeout-min", type=float, default=40.0,
                   help="supervised runs only: kill and restart a child that prints nothing for this many "
                        "minutes (0: never)")
    p.add_argument("--busy-hang-timeout-min", type=float, default=15.0,
                   help=IGNORED + " (the busy-wedge watchdog of the TPU build)")
    p.add_argument("--corrupt-loss-ceiling", type=float, default=1e3,
                   help="a finite loss above this (after warmup) counts as a corrupt log window")
    p.add_argument("--device", type=str, default=None,
                   help="one torch device (default: every visible card, one rank each); 'cpu' runs on the CPU")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def build_from_config(args):
    """(DetectorConfig, solver dict, the YAML config dict), as the JAX CLI
    builds them from ``--config-file`` and ``opts``."""
    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import DetectorConfig
    from unmore_tpu_torch.detector.config_yaml import apply_opts, get, load_yacs_config

    cfg_yaml = load_yacs_config(args.config_file) if args.config_file else {}
    if args.opts:
        apply_opts(cfg_yaml, [o for o in args.opts if o != "--"])

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    det_cfg = DetectorConfig(
        num_classes=get(cfg_yaml, "MODEL.ROI_HEADS.NUM_CLASSES", 1),
        image_size=args.canvas_size,
        max_gt=get(cfg_yaml, "INPUT.MAX_GT", 128),
        gt_mask_res=get(cfg_yaml, "INPUT.GT_MASK_RES", 128),
        stage_blocks=tuple(get(cfg_yaml, "MODEL.RESNETS.STAGE_BLOCKS", (3, 4, 6, 3))),
        stage_samples=get(cfg_yaml, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 512),
        rpn_pre_nms_topk_train=get(cfg_yaml, "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 2000),
        rpn_pre_nms_topk_test=get(cfg_yaml, "MODEL.RPN.PRE_NMS_TOPK_TEST", 1000),
        rpn_post_nms_topk_test=get(cfg_yaml, "MODEL.RPN.POST_NMS_TOPK_TEST", 1000),
        rpn_post_nms_topk_train=get(cfg_yaml, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 4000),
        rpn_nms_thresh=get(cfg_yaml, "MODEL.RPN.NMS_THRESH", 0.65),
        use_droploss=get(cfg_yaml, "MODEL.ROI_HEADS.USE_DROPLOSS", True),
        droploss_iou_thresh=get(cfg_yaml, "MODEL.ROI_HEADS.DROPLOSS_IOU_THRESH", 0.01),
        use_soft_targets=get(cfg_yaml, "MODEL.ROI_HEADS.USE_SOFT_TARGETS", True),
        positive_fraction=get(cfg_yaml, "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.25),
        mask_on=get(cfg_yaml, "MODEL.MASK_ON", True) and not args.no_segm,
        test_score_thresh=get(cfg_yaml, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0),
        detections_per_image=get(cfg_yaml, "TEST.DETECTIONS_PER_IMAGE", 100),
        dtype=dtypes[args.dtype],
    )
    solver = {
        "base_lr": get(cfg_yaml, "SOLVER.BASE_LR", 0.01),
        "max_iter": get(cfg_yaml, "SOLVER.MAX_ITER", 30000),
        "ims_per_batch": get(cfg_yaml, "SOLVER.IMS_PER_BATCH", 16),
        "weight_decay": get(cfg_yaml, "SOLVER.WEIGHT_DECAY", 5e-5),
        "steps": tuple(get(cfg_yaml, "SOLVER.STEPS", ()) or ()),
        "gamma": get(cfg_yaml, "SOLVER.GAMMA", 0.02),
        "clip_norm": get(cfg_yaml, "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 1.0),
        "checkpoint_period": get(cfg_yaml, "SOLVER.CHECKPOINT_PERIOD", 1000),
        "min_sizes": tuple(get(cfg_yaml, "INPUT.MIN_SIZE_TRAIN", (640, 672, 704, 736, 768, 800))),
        "copy_paste": get(cfg_yaml, "DATALOADER.COPY_PASTE", True),
        "copy_paste_rate": get(cfg_yaml, "DATALOADER.COPY_PASTE_RATE", 1.0),
        "copy_paste_random_num": get(cfg_yaml, "DATALOADER.COPY_PASTE_RANDOM_NUM", True),
        "copy_paste_min_ratio": get(cfg_yaml, "DATALOADER.COPY_PASTE_MIN_RATIO", 0.3),
        "copy_paste_max_ratio": get(cfg_yaml, "DATALOADER.COPY_PASTE_MAX_RATIO", 1.0),
        "output_dir": get(cfg_yaml, "OUTPUT_DIR", "cad_results/run"),
        "weights": get(cfg_yaml, "MODEL.WEIGHTS", None),
        "eval_period": get(cfg_yaml, "TEST.EVAL_PERIOD", 0),
        "precise_bn": get(cfg_yaml, "TEST.PRECISE_BN.ENABLED", False),
        "precise_bn_iters": get(cfg_yaml, "TEST.PRECISE_BN.NUM_ITER", 200),
        "warmup_iters": get(cfg_yaml, "SOLVER.WARMUP_ITERS", 1000),
        "reference_world_size": get(cfg_yaml, "SOLVER.REFERENCE_WORLD_SIZE", 0),
    }
    return det_cfg, solver, cfg_yaml


def auto_scale_workers(solver: dict, num_workers: int) -> dict:
    """Linear-scaling-rule rescale when the device count differs from
    SOLVER.REFERENCE_WORLD_SIZE: batch and LR scale up with workers;
    iterations, steps and periods scale down. No-op when
    REFERENCE_WORLD_SIZE is 0 or already matches."""
    old = solver["reference_world_size"]
    if old == 0 or old == num_workers:
        return solver
    assert solver["ims_per_batch"] % old == 0, "Invalid REFERENCE_WORLD_SIZE in config!"
    scale = num_workers / old
    s = dict(solver)
    s["ims_per_batch"] = int(round(solver["ims_per_batch"] * scale))
    s["base_lr"] = solver["base_lr"] * scale
    s["max_iter"] = int(round(solver["max_iter"] / scale))
    s["warmup_iters"] = int(round(solver["warmup_iters"] / scale))
    s["steps"] = tuple(int(round(x / scale)) for x in solver["steps"])
    s["eval_period"] = int(round(solver["eval_period"] / scale))
    s["checkpoint_period"] = int(round(solver["checkpoint_period"] / scale))
    s["reference_world_size"] = num_workers
    print(
        f"auto-scaled config to batch_size={s['ims_per_batch']}, "
        f"learning_rate={s['base_lr']}, max_iter={s['max_iter']}, "
        f"warmup={s['warmup_iters']}."
    )
    return s


def verify_results(cfg_yaml: dict, metrics: dict) -> bool:
    """TEST.EXPECTED_RESULTS entries [task, metric, expected (0-100),
    tolerance] against metrics in [0, 1]; raises on a violation (a missing
    metric is NaN and fails)."""
    from unmore_tpu_torch.detector.config_yaml import get

    expected = get(cfg_yaml, "TEST.EXPECTED_RESULTS", []) or []
    ok = True
    for task, metric, target, tol in expected:
        actual = 100.0 * float(metrics.get(task, {}).get(metric, float("nan")))
        good = np.isfinite(actual) and abs(actual - float(target)) <= float(tol)
        print(
            f"verify_results: {task}/{metric} = {actual:.2f} "
            f"(expected {target} +/- {tol}) -> {'OK' if good else 'FAIL'}",
            flush=True,
        )
        ok = ok and good
    if not ok:
        raise AssertionError(f"eval metrics outside TEST.EXPECTED_RESULTS: {expected}")
    return ok


def find_last_checkpoint(out_dir: str) -> str | None:
    """The newest ``model_NNNNNNN.ckpt`` in ``out_dir``."""
    best, best_iter = None, -1
    if not os.path.isdir(out_dir):
        return None
    for name in os.listdir(out_dir):
        m = re.fullmatch(r"model_(\d+)\.ckpt", name)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = os.path.join(out_dir, name), int(m.group(1))
    return best


def load_detector_weights(model, path: str):
    """A JAX msgpack checkpoint (a ``TrainState``'s ``params`` and
    ``batch_stats``) or a state dict of this port (bare or under
    ``model_state_dict``) into ``model``; every key must match."""
    from unmore_tpu_torch.detector.convert import state_dict_from_flax
    from unmore_tpu_torch.models.convert import load_torch_checkpoint
    from unmore_tpu_torch.train.checkpoints import try_msgpack_checkpoint

    tree = try_msgpack_checkpoint(path)
    if tree is None:
        sd = load_torch_checkpoint(path)
    else:
        sd = state_dict_from_flax({"params": tree["params"], "batch_stats": tree.get("batch_stats", {})})
    model.load_state_dict(sd, strict=True)


def _supervised(args, argv) -> int:
    """Run this CLI as a supervised child; restarts add --resume."""
    raw = list(argv) if argv is not None else sys.argv[1:]
    base = supervisor.child_argv(__spec__.name, raw, "--max-restarts")

    def build(attempt):
        if attempt and "--resume" not in base:
            i = len(base) - len(args.opts)  # opts is a REMAINDER: flags go before it
            return base[:i] + ["--resume"] + base[i:]
        return base

    return supervisor.supervise(build, args.max_restarts, hang_timeout=args.hang_timeout_min * 60 or None)


def run_eval(model, det_cfg, cfg_yaml, out_dir: str, tag: str, dataset, test_json, device, eval_bs: int = 4,
             eval_workers: int = 2, verify: bool = False, tasks=("bbox", "segm")) -> dict:
    """Evaluate ``model`` (eval mode, in ``det_cfg.dtype``) on ``dataset``
    (``len`` and ``get(i, dtype)`` -> (image, id), as ``COCOImages``) against
    ``test_json`` (a path or the GT dict), each rank on its strided shard of
    the images: rank 0 gathers the predictions, writes
    ``coco_instances_results.json`` and ``metrics_<tag>.json`` into
    ``out_dir`` and returns the metrics (other ranks None); ``verify``
    applies ``TEST.EXPECTED_RESULTS``."""
    from concurrent.futures import ThreadPoolExecutor

    from unmore_tpu_torch.cli.common import NpEncoder
    from unmore_tpu_torch.detector.evaluation import DetectorEvaluator
    from unmore_tpu_torch.evaluation.coco_eval import evaluate_ap
    from unmore_tpu_torch.parallel import distributed as dist

    evaluator = DetectorEvaluator(model, det_cfg, device=device)
    mine = dist.host_shard_indices(len(dataset))
    n = len(mine)
    print(f"* eval[{tag}]: {n} images on {device}", flush=True)
    # the last batch is padded with blank images under a sentinel id, whose
    # predictions are dropped: every call has the same batch shape
    pad = (np.zeros((8, 8, 3), np.float32), -1)
    preds = []
    t0 = time.time()
    with ThreadPoolExecutor(max(eval_workers, 1)) as decode_pool, ThreadPoolExecutor(1) as pool:

        def load_chunk(c0):
            chunk = list(decode_pool.map(lambda i: dataset.get(int(i), dtype=np.uint8), mine[c0:c0 + eval_bs]))
            return chunk + [pad] * (eval_bs - len(chunk))

        fut = pool.submit(load_chunk, 0) if n else None
        for c0 in range(0, n, eval_bs):
            chunk = fut.result()
            if c0 + eval_bs < n:
                fut = pool.submit(load_chunk, c0 + eval_bs)
            anns = evaluator.predict_batch([im for im, _ in chunk], [int(i) for _, i in chunk])
            preds.extend(a for a in anns if a["image_id"] != -1)
            n_done = min(c0 + eval_bs, n)
            print(f"[{n_done}/{n}] ({n_done / (time.time() - t0):.2f} img/s)", flush=True)

    preds = [p for part in dist.all_gather_objects(preds) for p in part]
    if not dist.is_main():
        return None
    with open(os.path.join(out_dir, "coco_instances_results.json"), "w") as f:
        json.dump(preds, f, cls=NpEncoder)
    metrics = evaluate_ap(test_json, preds, iou_types=tasks)
    with open(os.path.join(out_dir, f"metrics_{tag}.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    if verify:
        verify_results(cfg_yaml, metrics)
    return metrics


def batch_workers(dataset_fn, det_cfg, solver: dict, n_workers: int) -> list:
    """``n_workers`` prefetch worker functions, worker ``w`` owning the
    dataset ``dataset_fn(seed)`` and a numpy generator of seed
    ``1000 + 17 * host + w`` (the JAX CLI's seeds, a host being a JAX
    process), each drawing one wire-format batch of the host's share of
    ``ims_per_batch`` images a call and returning this rank's rows of it."""
    from unmore_tpu_torch.data.detection import detection_batch_iterator
    from unmore_tpu_torch.parallel import distributed as dist

    host_bs = dist.local_batch_size(solver["ims_per_batch"]) * dist.local_world_size()
    host = dist.process_index() // dist.local_world_size()

    def worker(seed):
        it = detection_batch_iterator(
            dataset_fn(seed), host_bs, det_cfg.max_gt, det_cfg.gt_mask_res,
            np.random.default_rng(seed), copy_paste=solver["copy_paste"], rate=solver["copy_paste_rate"],
            min_ratio=solver["copy_paste_min_ratio"], max_ratio=solver["copy_paste_max_ratio"],
            random_num=solver["copy_paste_random_num"])
        return lambda: dist.local_rows(next(it))

    return [worker(1000 + 17 * host + w) for w in range(max(n_workers, 1))]


def make_trainer(det_cfg, solver: dict, device, dtype: str = "bfloat16", seed: int = 0):
    """A :class:`~unmore_tpu_torch.train.detector.DetectorTrainer` of the
    config's detector with f32 master weights (random, from ``seed``) on
    ``device`` and the solver's SGD."""
    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN
    from unmore_tpu_torch.train.detector import DetectorTrainer
    from unmore_tpu_torch.train.optim import init_like_flax

    model = CascadeMaskRCNN(dataclasses.replace(det_cfg, dtype=torch.float32))
    init_like_flax(model, seed)
    optim = {k: solver[k] for k in ("base_lr", "weight_decay", "warmup_iters", "steps", "gamma", "clip_norm")}
    return DetectorTrainer(model.to(device), det_cfg, optim, dtype=dtype)


def load_training_state(trainer, path: str):
    """A whole ``DetectorTrainState`` (either package's) into ``trainer``;
    weights alone (a tree without ``opt_state``, or a port state dict) into
    its model."""
    from unmore_tpu_torch.train.checkpoints import try_msgpack_checkpoint

    tree = try_msgpack_checkpoint(path)
    if tree is not None and "opt_state" in tree:
        trainer.load_tree(tree)
    else:
        load_detector_weights(trainer.model, path)


def eval_model_of(trainer, stats: dict | None = None):
    """A copy of the trainer's detector for evaluation: eval mode, in the
    config's dtype, with ``stats`` (buffer name -> tensor, PreciseBN's) in
    place of its BatchNorm statistics."""
    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN

    model = CascadeMaskRCNN(trainer.cfg)
    model.load_state_dict(trainer.model.state_dict())
    if stats:
        model.load_state_dict(stats, strict=False)
    return model.to(trainer.device, trainer.cfg.dtype).eval()


def train_detector(trainer, solver: dict, out_dir: str, workers: list, eval_fn=None, corrupt_loss_ceiling: float = 1e3,
                   on_step=None) -> dict:
    """The CAD training loop of ``cad/train_net.py`` from the trainer's step
    to ``solver["max_iter"]``, fed by ``workers`` (:func:`batch_workers`)
    on prefetch threads.

    Every 20 steps: the losses (4 decimals), ``iteration``, ``ips`` and
    ``data_starved`` as a ``metrics.json`` line and TensorBoard scalars, and
    the corruption check (a non-finite total, or one above
    ``corrupt_loss_ceiling`` after warmup; twice in a row exits with
    ``FATAL_EXIT_CODE`` without saving). Checkpoints (async) every
    ``checkpoint_period`` steps and at ``max_iter``, unless the last window
    looked corrupt. Every ``eval_period`` steps and at ``max_iter``:
    PreciseBN over ``max(1, precise_bn_iters // ims_per_batch)`` fresh
    batches when enabled, then ``eval_fn(model, tag, verify)`` on a copy of
    the detector with those statistics (``verify`` at ``max_iter`` only).
    ``on_step(step_no, losses)`` runs after each step's launch (no sync
    here). Returns the logged lines, the checkpoints written (path, bytes,
    seconds), the PreciseBN seconds, the evaluations' metrics and
    ``data_starved``. Over several ranks rank 0 writes the logs, metrics and
    checkpoints, and the statistics of PreciseBN are the global batch's."""
    import torch

    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.detector.cascade_rcnn import normalize
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.checkpoints import AsyncCheckpointer
    from unmore_tpu_torch.train.objectness import to_device
    from unmore_tpu_torch.train.precise_bn import precise_bn_stats
    from unmore_tpu_torch.train.resilience import (
        FATAL_EXIT_CODE, CorruptionDetector, fault_injection_active, mark_fault_injected,
    )
    from unmore_tpu_torch.utils.tensorboard import EventWriter

    os.makedirs(out_dir, exist_ok=True)
    it = PrefetchIterator(worker_fns=workers)

    def next_batch():
        host = next(it)
        host.pop("n_gt_dropped", None)
        return to_device(host, trainer.device)

    def precise_bn():
        # batches of a host, as the JAX CLI counts the batches of a process
        host_bs = dist.local_batch_size(solver["ims_per_batch"]) * dist.local_world_size()
        n_bn = max(1, solver["precise_bn_iters"] // host_bs)
        print(f"* precise_bn: {n_bn} stat batches", flush=True)
        t0 = time.perf_counter()

        def forward(batch):
            with trainer.autocast():
                trainer.model.backbone.trunk(normalize(batch["images"]))

        stats = precise_bn_stats(trainer.model, forward, (next_batch() for _ in range(n_bn)))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        summary["precise_bn_s"].append(time.perf_counter() - t0)
        return stats

    def drain():
        """Wait for the checkpoint write in flight; record its path, bytes and seconds."""
        done = writer.wait()
        if done and not any(c["path"] == done["path"] for c in summary["checkpoints"]):
            summary["checkpoints"].append(dict(done))

    writer = AsyncCheckpointer()
    main_rank = dist.is_main()
    tb = EventWriter(os.path.join(out_dir, "tb")) if main_rank else None
    metrics_path = os.path.join(out_dir, "metrics.json")
    detector = CorruptionDetector()
    summary = {"logs": [], "checkpoints": [], "precise_bn_s": [], "evals": {}}
    max_iter = solver["max_iter"]
    t0 = time.time()
    try:
        for it_no in range(int(trainer.step), max_iter):
            losses = trainer.train_step(next_batch())
            step_no = it_no + 1
            if on_step is not None:
                on_step(step_no, losses)
            if step_no % 20 == 0:
                line = {k: round(float(v), 4) for k, v in losses.items()}
                total = line.get("total", 0.0)
                corrupt = detector.loss_window_corrupt(total, ceiling=corrupt_loss_ceiling,
                                                       in_warmup=step_no <= solver["warmup_iters"])
                if detector.update(corrupt or fault_injection_active(step_no)):
                    it.close()
                    mark_fault_injected()
                    print(f"FATAL: {detector.consecutive} consecutive corrupt loss windows at iter {step_no} "
                          f"(total={total}); NOT saving — restart with --resume.", flush=True)
                    sys.exit(FATAL_EXIT_CODE)
                line["iteration"] = step_no
                line["ips"] = round(20 * solver["ims_per_batch"] / (time.time() - t0), 2)
                line["data_starved"] = round(it.starved_fraction, 3)
                t0 = time.time()
                if main_rank:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(line) + "\n")
                    for k, v in line.items():
                        if k != "iteration":
                            tb.add_scalar(k, v, step_no)
                    tb.flush()
                    print(line, flush=True)
                summary["logs"].append(line)
            if step_no % solver["checkpoint_period"] == 0 or step_no == max_iter:
                if detector.last_window_corrupt:
                    print(f"* skipping checkpoint at iter {step_no} (last loss window corrupt)")
                else:
                    if main_rank:
                        drain()
                        writer.save(os.path.join(out_dir, f"model_{step_no:07d}.ckpt"),
                                    trainer.checkpoint_tensors(), trainer.checkpoint_tree)
                        print(f"* checkpoint scheduled at iter {step_no} (async; durable after drain)")
                    dist.barrier("ckpt")
            if eval_fn is not None and solver["eval_period"] and (
                    step_no % solver["eval_period"] == 0 or step_no == max_iter):
                stats = precise_bn() if solver["precise_bn"] else None
                tag = f"iter_{step_no:07d}"
                summary["evals"][tag] = eval_fn(eval_model_of(trainer, stats), tag, step_no == max_iter)
                t0 = time.time()
        drain()
    finally:
        it.close()
        if tb is not None:
            tb.close()
    summary["data_starved"] = it.starved_fraction
    return summary


def main(argv=None):
    args = parse_args(argv)
    raw = list(argv) if argv is not None else sys.argv[1:]

    from unmore_tpu_torch.cli.common import launch_local_ranks
    from unmore_tpu_torch.parallel import mesh

    n_local = 1 if mesh.launched() else mesh.local_ranks(-1, args.device)
    if args.max_restarts > 0:
        if n_local > 1 or mesh.launched():
            # a rank that restarts alone cannot rejoin peers blocked in a collective
            raise SystemExit("--max-restarts supervises a one-rank run only; pass --device (one card) or relaunch "
                             "a run of several ranks with --resume")
        sys.exit(_supervised(args, argv))
    if not args.eval_only:
        assert args.train_json, "--train-json required for training"
    launch_local_ranks(main, raw, n_local)

    import torch

    from unmore_tpu_torch import resolve_device
    from unmore_tpu_torch.data.coco import COCOImages
    from unmore_tpu_torch.detector.config_yaml import dump_yaml
    from unmore_tpu_torch.parallel import distributed as dist

    dist.initialize()
    device = resolve_device(args.device or (str(dist.local_device()) if dist.process_count() > 1 else None))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # f32 means f32: no TF32 in cuDNN convolutions or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    det_cfg, solver, cfg_yaml = build_from_config(args)
    solver = auto_scale_workers(solver, dist.process_count())
    out_dir = solver["output_dir"]
    if dist.is_main():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.yaml"), "w") as f:
            f.write(dump_yaml(cfg_yaml) + "\n")
    dist.barrier("setup")

    trainer = make_trainer(det_cfg, solver, device, args.dtype)
    weights = find_last_checkpoint(out_dir) if args.resume else None
    if not weights and solver["weights"] and os.path.isfile(str(solver["weights"])):
        weights = solver["weights"]
    if weights and args.eval_only:  # evaluation needs the weights only
        load_detector_weights(trainer.model, weights)
        print(f"loaded weights from {weights}")
    elif weights:
        load_training_state(trainer, weights)
        print(f"resumed from {weights} at iter {int(trainer.step)}")

    if args.test_dataset and args.data_root:
        from unmore_tpu_torch.data.registry import resolve_dataset

        test_image_dir, test_json = resolve_dataset(args.test_dataset, args.data_root)
    else:
        test_image_dir, test_json = args.test_image_dir, args.test_json
    tasks = ("bbox",) if args.no_segm or not det_cfg.mask_on else ("bbox", "segm")

    def evaluate(model, tag, verify):
        assert test_json and test_image_dir, "--test-json/--test-image-dir (or --test-dataset with --data-root) required"
        return run_eval(model, det_cfg, cfg_yaml, out_dir, tag, COCOImages(test_image_dir, test_json), test_json,
                        device, args.eval_bs if args.eval_bs > 0 else 4, args.eval_workers, verify, tasks)

    if args.eval_only:
        return evaluate(eval_model_of(trainer), "eval_only", True)

    from unmore_tpu_torch.data.detection import DetectionDataset

    image_roots = {"": "."}
    for spec in args.image_root:
        prefix, _, root = spec.partition("=")
        image_roots[prefix] = root

    def dataset(seed):
        return DetectionDataset(args.train_json, image_roots, canvas_size=det_cfg.image_size,
                                min_sizes=solver["min_sizes"], seed=seed)

    return train_detector(trainer, solver, out_dir, batch_workers(dataset, det_cfg, solver, args.train_workers),
                          evaluate, args.corrupt_loss_ceiling)


if __name__ == "__main__":
    main()
