"""Stage-1 training CLI on every card of a host.

    python -m unmore_tpu_torch.cli.train_objectness_net --train_center_and_boundary \\
        --imagenet_dir IMAGES --votecut_mask_dir MASKS --sdf_activation tanh --use_bg_sdf \\
        --batch_size 20 --lr_scheduler_gamma 0.1 --use_sdf_gradient_loss --use_sdf_binary_mask_loss
    python -m unmore_tpu_torch.cli.train_objectness_net --train_existence \\
        --imagenet_dir IMAGES --votecut_mask_dir MASKS --batch_size 20

The flags, the run directory
``results_objectness/<mode>/<run>/{configs.json, train_log.json,
eval_log.json, ckpt/iter_N_model.ckpt, imgs/, tb/}`` and the checkpoint
files of the JAX package's ``train_objectness_net.py``: a checkpoint is the
JAX trainers' ``TrainState`` in flax msgpack, so either package resumes the
other's run and both packages' stage-2 CLIs load it. Without ``--resume``
the weights start from ``--seed`` with flax's initializers.

Both trainers run data-parallel over every visible card, one rank each
(spawned here unless torchrun started them), as the JAX CLI's mesh takes
every local chip: the ranks run the host's one seeded data stream and each
trains on its rows of every batch, ``--batch_size`` being the global batch
(divisible by the rank count); rank 0 writes the logs, visualisations,
evaluations and checkpoints. ``--device`` picks one torch device (default:
CUDA card ``--gpu_index`` on one card); ``--dtype bfloat16`` runs the
forward under ``torch.autocast`` over f32 parameters; TF32 stays off. One host pull of the loss per log window. The
spike guard skips bad batches on the card; two consecutive corrupt log
windows exit with code 3 without saving, and ``--max_restarts N`` relaunches
a one-rank run from its newest checkpoint. ``--vit_pack > 1`` is not ported.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import sys
import time

import numpy as np

from unmore_tpu_torch.cli import supervisor

IGNORED = "accepted for the JAX CLI's recipes and ignored"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpu_index", type=int, default=0,
                   help="CUDA card of a one-card run (with the default --device; several visible cards train "
                        "on all of them)")
    p.add_argument("--device", type=str, default=None,
                   help="one torch device; default: every visible card, one rank each; 'cpu' trains on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--save_ckpt_every", type=int, default=5000)
    p.add_argument("--evaluate_loss_every", type=int, default=1000, help=IGNORED + " (as in the reference)")
    p.add_argument("--evaluate_every", type=int, default=5000)
    p.add_argument("--visualize_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--N_vis", type=int, default=10)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--eval_mode", action="store_true")
    p.add_argument("--train_iter", type=int, default=500000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--test_batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=0.0001)
    p.add_argument("--lr_scheduler_type", type=str, default="multi_step_lr")
    p.add_argument("--lr_scheduler_milestones", nargs="+", type=int, default=[10000, 20000])
    p.add_argument("--lr_scheduler_gamma", type=float, default=1)
    p.add_argument("--ema_lr", type=float, default=0.001, help=IGNORED)
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--dataset", type=str, default="ImageNet_votecut_top1_Dataset")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--random_crop_scale_min", type=float, default=0.08)
    p.add_argument("--random_crop_scale_max", type=float, default=1.0)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--backbone_type", type=str, default="dpt_large")
    p.add_argument("--sdf_activation", type=str, default=None)
    p.add_argument("--use_bg_sdf", action="store_true")
    p.add_argument("--sdf_loss_type", type=str, default="l1")
    p.add_argument("--center_field_loss_type", type=str, default="l2")
    p.add_argument("--use_sdf_gradient_loss", action="store_true")
    p.add_argument("--use_sdf_binary_mask_loss", action="store_true")
    p.add_argument("--train_center_and_boundary", action="store_true")
    p.add_argument("--train_existence", action="store_true")
    p.add_argument("--imagenet_dir", type=str, default=None, help="ImageNet train images root")
    p.add_argument("--votecut_mask_dir", type=str, default=None, help="masks_top1_single_component root")
    p.add_argument("--votecut_full_mask_dir", type=str, default=None, help="full votecut masks (existence bg crops)")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--max_restarts", type=int, default=0,
                   help="supervise a one-rank run: relaunch it with --resume at the newest checkpoint up to N "
                        "times after the fail-fast exit (code 3), a crash or --hang_timeout_min of silence")
    p.add_argument("--hang_timeout_min", type=float, default=40.0,
                   help="supervised runs only: kill and restart a child that prints nothing for this many "
                        "minutes (0: never)")
    p.add_argument("--busy_hang_timeout_min", type=float, default=15.0,
                   help=IGNORED + " (the busy-wedge watchdog of the TPU build: under CUDA a host thread "
                                  "waiting on the device spins, so a silent child that burns CPU is normal)")
    p.add_argument("--remat_vit", action="store_true",
                   help="checkpoint the ViT blocks (recompute their activations in the backward pass); "
                        "dpt_hybrid ignores it, as the JAX package does")
    p.add_argument("--vit_pack", type=int, default=1,
                   help="ViT sequence packing; only 1 is ported (ROADMAP.md, A1-A5 left-outs)")
    p.add_argument("--skip_loss_above", type=float, default=1000.0,
                   help="spike guard: skip the update when the batch loss exceeds this "
                        "(non-finite always skips; 0 disables)")
    p.add_argument("--spike_guard_warmup", type=int, default=500,
                   help="the skip_loss_above ceiling arms only after this many steps "
                        "(non-finite losses skip during warmup too)")
    return p.parse_args(argv)


def run_dir_of_ckpt(ckpt_path: str) -> str:
    """Run directory of a checkpoint (.../<run>/ckpt/iter_N_model.ckpt ->
    .../<run>); a checkpoint outside that layout -> its own directory."""
    if "/ckpt/" in ckpt_path:
        return ckpt_path.split("/ckpt/")[0]
    return os.path.dirname(os.path.abspath(ckpt_path))


def find_last_stage1_checkpoint(run_dir: str) -> str | None:
    """Newest ckpt/iter_N_model.ckpt under a stage-1 run directory."""
    ckpt_dir = os.path.join(run_dir, "ckpt")
    best, best_iter = None, -1
    if not os.path.isdir(ckpt_dir):
        return None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"iter_(\d+)_model\.ckpt", name)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = os.path.join(ckpt_dir, name), int(m.group(1))
    return best


def default_run_name(args) -> str:
    return datetime.datetime.now().strftime("%y%m%d_%H%M%S") + "_" + args.dataset + "_" + args.backbone_type


def make_run_dir(args, mode: str) -> str:
    from unmore_tpu_torch.parallel import distributed as dist

    if args.run_name is None:
        args.run_name = default_run_name(args)
    result_folder = os.path.join("results_objectness", mode, args.run_name)
    os.makedirs(os.path.join(result_folder, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(result_folder, "imgs"), exist_ok=True)
    if dist.is_main():
        with open(os.path.join(result_folder, "configs.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    return result_folder


def append_log(path, iteration, value):
    data = {}
    if os.path.isfile(path):
        with open(path) as f:
            data = json.load(f)
    data[str(iteration)] = float(value)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


# the models; module-level so that tests can put tiny ones in their place
def build_objectness_model(args):
    from unmore_tpu_torch.models.objectness import ObjectnessNet

    return ObjectnessNet(args.backbone_type, args.sdf_activation, args.use_bg_sdf, remat_vit=args.remat_vit)


def build_classifier_model(args):
    from unmore_tpu_torch.models.resnet import BinaryClassifier

    return BinaryClassifier()


def _setup(args):
    """Join the host's ranks; the rank's training device, TF32 off. The
    global batch must split evenly over the ranks."""
    from unmore_tpu_torch.cli.common import setup_device
    from unmore_tpu_torch.parallel import distributed as dist

    dist.initialize()
    if dist.process_count() != dist.local_world_size():
        raise SystemExit("stage 1 trains on the cards of one host, as the JAX package's mesh of local chips")
    dist.local_batch_size(args.batch_size)
    return setup_device(args)


def _rows(make_batch):
    """A prefetch worker that keeps this rank's rows of each host batch."""
    from unmore_tpu_torch.parallel import distributed as dist

    return lambda: dist.local_rows(make_batch())


def _model(build, args, device):
    from unmore_tpu_torch.train.optim import init_like_flax

    model = build(args).to(device)
    init_like_flax(model, args.seed)
    return model


def _resume(trainer, args) -> int:
    from unmore_tpu_torch.train.checkpoints import load_msgpack_checkpoint

    if not args.resume:
        return 0
    trainer.load_tree(load_msgpack_checkpoint(args.resume))
    start = int(trainer.step)
    print(f"resumed from {args.resume} at iter {start}", flush=True)
    return start


def _fatal(prefetch, message: str):
    from unmore_tpu_torch.train.resilience import FATAL_EXIT_CODE, mark_fault_injected

    prefetch.close()
    mark_fault_injected()
    print(message, flush=True)
    sys.exit(FATAL_EXIT_CODE)


def train_center_and_boundary(args):
    import torch

    from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.data.votecut import VoteCutObjectnessDataset, batch_iterator
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.checkpoints import AsyncCheckpointer
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, decode_wire_batch, to_device
    from unmore_tpu_torch.train.resilience import CorruptionDetector, fault_injection_active
    from unmore_tpu_torch.utils.tensorboard import EventWriter
    from unmore_tpu_torch.utils.vis import dump_objectness_diagnostics

    cfg = TrainObjectnessConfig(
        model=ModelConfig(backbone_type=args.backbone_type, sdf_activation=args.sdf_activation,
                          use_bg_sdf=args.use_bg_sdf, image_size=args.image_size, dtype=args.dtype),
        optim=OptimConfig(optimizer=args.optimizer, learning_rate=args.learning_rate,
                          lr_scheduler_type=args.lr_scheduler_type,
                          lr_scheduler_milestones=tuple(args.lr_scheduler_milestones),
                          lr_scheduler_gamma=args.lr_scheduler_gamma),
        seed=args.seed, batch_size=args.batch_size, train_iter=args.train_iter,
        save_ckpt_every=args.save_ckpt_every, log_every=args.log_every,
        sdf_loss_type=args.sdf_loss_type, center_field_loss_type=args.center_field_loss_type,
        use_sdf_gradient_loss=args.use_sdf_gradient_loss, use_sdf_binary_mask_loss=args.use_sdf_binary_mask_loss,
        random_crop_scale_min=args.random_crop_scale_min, random_crop_scale_max=args.random_crop_scale_max,
        skip_loss_above=args.skip_loss_above, spike_guard_warmup=args.spike_guard_warmup,
    )
    device = _setup(args)
    trainer = ObjectnessTrainer(_model(build_objectness_model, args, device), cfg)
    start_iter = _resume(trainer, args)
    crop_scale = (args.random_crop_scale_min, args.random_crop_scale_max)

    def predict(images: np.ndarray) -> dict:
        batch = decode_wire_batch(to_device({"image": images}, device))
        with torch.no_grad(), trainer.autocast():
            out = trainer.model(batch["image"])
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    if args.eval_mode:
        # evaluate and exit: diagnostics of N_vis fresh samples into
        # <resumed run>/evaluation (reference train_objectness_net.py:160-164)
        if not args.resume:
            raise SystemExit("--eval_mode requires --resume")
        eval_folder = os.path.join(run_dir_of_ckpt(args.resume), "evaluation")
        os.makedirs(eval_folder, exist_ok=True)
        ds = VoteCutObjectnessDataset(args.imagenet_dir, args.votecut_mask_dir, args.image_size, args.use_bg_sdf,
                                      crop_scale=crop_scale, seed=args.seed)
        samples, i = [], 0
        while len(samples) < args.N_vis and i < 10 * args.N_vis:
            s = ds.get(i % len(ds))
            i += 1
            if s is not None:
                samples.append(s)
        out = predict(np.stack([s.image for s in samples]))
        for s_idx, s in enumerate(samples):
            dump_objectness_diagnostics(eval_folder, f"s{s_idx}", image=s.image,
                                        pred_center=out["center_fields"][s_idx], pred_sdf=out["sdf_maps"][s_idx],
                                        gt_center=s.center_field, gt_sdf=s.sdf, gt_mask=s.saliency_mask)
        print(f"Finish evaluation (wrote {eval_folder})")
        return

    result_folder = make_run_dir(args, "center_and_boundary")
    train_log_path = os.path.join(result_folder, "train_log.json")

    def worker(worker_seed):
        ds = VoteCutObjectnessDataset(args.imagenet_dir, args.votecut_mask_dir, args.image_size, args.use_bg_sdf,
                                      crop_scale=crop_scale, seed=worker_seed)
        it = batch_iterator(lambda i: ds.get(i), len(ds), args.batch_size, np.random.default_rng(worker_seed))
        return _rows(lambda: next(it))

    prefetch = PrefetchIterator(worker_fns=[worker(args.seed + 1000 * w) for w in range(max(args.num_workers, 1))])
    ckpt_writer = AsyncCheckpointer()
    main_rank = dist.is_main()  # writes the logs, diagnostics and checkpoints
    tb = EventWriter(os.path.join(result_folder, "tb")) if main_rank else None
    loss_acc = skip_acc = None  # device scalars, pulled once per log window
    detector = CorruptionDetector()  # consecutive fully-skipped windows -> fatal
    t0 = time.time()
    for iteration in range(start_iter, args.train_iter + 1):
        host_batch = next(prefetch)
        metrics = trainer.train_step(to_device(host_batch, device))
        loss_acc = metrics["total"] if loss_acc is None else loss_acc + metrics["total"]
        if "skipped" in metrics:
            skip_acc = metrics["skipped"] if skip_acc is None else skip_acc + metrics["skipped"]
        step_no = iteration + 1
        if step_no % args.save_ckpt_every == 0:
            if detector.last_window_corrupt:
                # the state may already be poisoned: a resume must never
                # land on a checkpoint written inside the incident
                print(f"* skipping checkpoint at iter {step_no} (last window corrupt)")
            else:
                if main_rank:
                    path = os.path.join(result_folder, "ckpt", f"iter_{step_no}_model.ckpt")
                    ckpt_writer.save(path, trainer.checkpoint_tensors(), trainer.checkpoint_tree)
                    print(f"* checkpoint scheduled {path} (async; durable after drain)")
                dist.barrier("ckpt")
        if step_no % args.visualize_every == 0 and main_rank:
            vis_dir = os.path.join(result_folder, "imgs", f"iter_{step_no}")
            n = min(args.N_vis, len(host_batch["image"]))
            out = predict(host_batch["image"][:n])
            for s_idx in range(n):
                dump_objectness_diagnostics(
                    vis_dir, f"s{s_idx}", image=host_batch["image"][s_idx].astype(np.float32) / 255.0,
                    pred_center=out["center_fields"][s_idx], pred_sdf=out["sdf_maps"][s_idx],
                    gt_center=host_batch["center_field"][s_idx].astype(np.float32),
                    gt_sdf=host_batch["sdf"][s_idx].astype(np.float32),
                    gt_mask=host_batch["saliency_mask"][s_idx].astype(np.float32))
            print(f"* wrote diagnostics to {vis_dir}")
        if step_no % args.log_every == 0:
            n = min(step_no - start_iter, args.log_every)
            avg = float(loss_acc) / max(n, 1)  # the window's one host pull
            n_skipped = int(skip_acc) if skip_acc is not None else 0
            loss_acc = skip_acc = None
            rate = args.log_every / (time.time() - t0)
            t0 = time.time()
            if main_rank:
                append_log(train_log_path, step_no, avg)
                tb.add_scalar("total_loss", avg, step_no)
                tb.add_scalar("imgs_per_sec", rate * args.batch_size, step_no)
                tb.flush()
                skip_note = f", {n_skipped} spike-skipped" if n_skipped else ""
                print(f"iter {step_no} loss {avg:.4f} ({rate:.2f} it/s, {rate * args.batch_size:.1f} imgs/s, "
                      f"data-starved {prefetch.starved_fraction:.1%}{skip_note})", flush=True)
            # every batch of consecutive windows skipped: the state is not to
            # be trusted; exit without saving, a restart resumes from the last
            # periodic checkpoint (train/resilience.py)
            if detector.update(n_skipped >= n or fault_injection_active(step_no)):
                _fatal(prefetch, f"FATAL: {detector.consecutive} consecutive fully-skipped log windows at iter "
                                 f"{step_no}. NOT saving; restart with --resume from the last periodic checkpoint.")
    ckpt_writer.wait()
    prefetch.close()
    if main_rank:
        tb.close()


def existence_batch_worker(args, worker_seed):
    """One prefetch worker: owns a dataset index and RNG, draws whole batches
    (the reference's DataLoader workers)."""
    from unmore_tpu_torch.data.existence import classifier_sample
    from unmore_tpu_torch.data.votecut import VoteCutObjectnessDataset, load_image_mask_pair, load_mask

    index = VoteCutObjectnessDataset(args.imagenet_dir, args.votecut_mask_dir, args.image_size, seed=worker_seed)
    full_mask_dir = args.votecut_full_mask_dir or args.votecut_mask_dir
    rng = np.random.default_rng(worker_seed)

    def sample():
        while True:
            name = index.names[int(rng.integers(0, len(index.names)))]
            image, top1 = load_image_mask_pair(os.path.join(args.imagenet_dir, name.replace(".png", ".JPEG")),
                                               os.path.join(args.votecut_mask_dir, name.replace(".JPEG", ".png")))
            if image is None:
                continue
            if full_mask_dir == args.votecut_mask_dir:
                full = top1  # the same file
            else:
                full = load_mask(os.path.join(full_mask_dir, name.replace(".JPEG", ".png")), image.shape[:2])
            if full is None:
                full = top1
            return classifier_sample(image, top1, full, args.image_size, rng)

    def batch():
        samples = [sample() for _ in range(args.batch_size)]
        images = np.clip(np.stack([s[0] for s in samples]) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return {"image": images, "label": np.array([s[1] for s in samples], np.float32)}

    return batch


def train_existence(args):
    from unmore_tpu_torch.config import OptimConfig
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.checkpoints import AsyncCheckpointer
    from unmore_tpu_torch.train.classifier import ClassifierTrainer
    from unmore_tpu_torch.train.objectness import to_device
    from unmore_tpu_torch.train.resilience import CorruptionDetector, fault_injection_active
    from unmore_tpu_torch.utils.vis import save_png

    device = _setup(args)
    # the JAX CLI's optimizer here: Adam on the multi-step schedule
    optim = OptimConfig(learning_rate=args.learning_rate, lr_scheduler_milestones=tuple(args.lr_scheduler_milestones),
                        lr_scheduler_gamma=args.lr_scheduler_gamma)
    trainer = ClassifierTrainer(_model(build_classifier_model, args, device), optim, args.dtype)
    start_iter = _resume(trainer, args)
    eval_draw: list = []  # built once, reused by every evaluation

    def evaluate_classification(step_no, result_folder):
        """Accuracy at 0.5 on freshly drawn samples, eval_log.json and the
        first batch's images named with gt and pred (reference
        evaluate_classification, train_objectness_net.py:703-743)."""
        if not eval_draw:
            eval_draw.append(existence_batch_worker(args, args.seed + 99991))
        hits = total = 0.0
        for b_idx in range(max(1, args.test_batch_size // args.batch_size * 4)):
            eb = eval_draw[0]()
            h, t, pred = trainer.eval_step(to_device(eb, device))
            hits += float(h)
            total += float(t)
            if b_idx == 0:
                img_folder = os.path.join(result_folder, "imgs", f"iter_{step_no}")
                os.makedirs(img_folder, exist_ok=True)
                pred = pred.float().cpu().numpy()
                for i in range(min(len(eb["image"]), 64)):
                    save_png(os.path.join(img_folder, f"{i}_input_image_gt_{eb['label'][i]:.0f}_pred_{pred[i]:.3f}.png"),
                             eb["image"][i])
        acc = hits / max(total, 1.0)
        append_log(os.path.join(result_folder, "eval_log.json"), step_no, acc)
        print(f"* eval acc = {hits:.0f}/{total:.0f} = {acc:.4f}", flush=True)
        return acc

    if args.eval_mode:
        if not args.resume:
            raise SystemExit("--eval_mode requires --resume")
        result_folder = os.path.join(run_dir_of_ckpt(args.resume), "evaluation")
        os.makedirs(result_folder, exist_ok=True)
        evaluate_classification(start_iter, result_folder)
        print("Finish evaluation")
        return

    result_folder = make_run_dir(args, "existence")
    train_log_path = os.path.join(result_folder, "train_log.json")
    prefetch = PrefetchIterator(worker_fns=[_rows(existence_batch_worker(args, args.seed + 1000 * w))
                                            for w in range(max(args.num_workers, 1))])
    ckpt_writer = AsyncCheckpointer()
    main_rank = dist.is_main()  # writes the logs, evaluations and checkpoints
    detector = CorruptionDetector()
    loss_acc = None
    t0 = time.time()
    for iteration in range(start_iter, args.train_iter + 1):
        metrics = trainer.train_step(to_device(next(prefetch), device))
        loss_acc = metrics["loss"] if loss_acc is None else loss_acc + metrics["loss"]
        step_no = iteration + 1
        if step_no % args.save_ckpt_every == 0:
            if detector.last_window_corrupt:
                print(f"* skipping checkpoint at iter {step_no} (last window corrupt)")
            else:
                if main_rank:
                    path = os.path.join(result_folder, "ckpt", f"iter_{step_no}_model.ckpt")
                    ckpt_writer.save(path, trainer.checkpoint_tensors(), trainer.checkpoint_tree)
                    print(f"* checkpoint scheduled {path} (async; durable after drain)")
                dist.barrier("ckpt")
        if step_no % args.evaluate_every == 0 and main_rank:
            evaluate_classification(step_no, result_folder)
        if step_no % args.log_every == 0:
            n = min(step_no - start_iter, args.log_every)
            avg = float(loss_acc) / max(n, 1)
            loss_acc = None
            rate = args.log_every / (time.time() - t0)
            t0 = time.time()
            if main_rank:
                append_log(train_log_path, step_no, avg)
                print(f"iter {step_no} loss {avg:.4f} ({rate:.2f} it/s, {rate * args.batch_size:.1f} imgs/s, "
                      f"data-starved {prefetch.starved_fraction:.1%})", flush=True)
            # a BCE window loss non-finite (or absurd) for consecutive windows
            if detector.update(detector.loss_window_corrupt(avg) or fault_injection_active(step_no)):
                _fatal(prefetch, f"FATAL: {detector.consecutive} consecutive corrupt loss windows at iter "
                                 f"{step_no} (loss={avg}); NOT saving; restart with --resume from the last "
                                 f"periodic checkpoint.")
    ckpt_writer.wait()
    prefetch.close()


def main(argv=None):
    args = parse_args(argv)
    if args.vit_pack > 1:
        raise SystemExit("--vit_pack > 1 (ViT sequence packing) is not ported; it is queued in ROADMAP.md "
                         "(section A, left out of A1-A5)")
    raw = list(argv) if argv is not None else sys.argv[1:]

    from unmore_tpu_torch.cli.common import launch_local_ranks, pin_run_name
    from unmore_tpu_torch.parallel import mesh

    n_local = 1 if mesh.launched() or args.eval_mode else mesh.local_ranks(-1, args.device)
    several = n_local > 1 or mesh.launched()
    if several and args.max_restarts > 0 and not args.eval_mode:
        # a rank that restarts alone cannot rejoin peers blocked in a collective
        raise SystemExit("--max_restarts supervises a one-rank run only; pass --device (one card) or relaunch "
                         "a run of several ranks with --resume")
    if (several or args.max_restarts > 0) and not args.eval_mode:
        # pin the run name, so that every rank and every child writes to one
        # run directory and a restart finds its checkpoints
        raw = pin_run_name(args, raw, default_run_name(args))
    launch_local_ranks(main, raw, n_local)
    if args.max_restarts > 0 and not args.eval_mode:
        # run single-shot children
        mode = "center_and_boundary" if args.train_center_and_boundary else "existence"
        run_dir = os.path.join("results_objectness", mode, args.run_name)
        base = supervisor.child_argv(__spec__.name, raw, "--max_restarts")
        sys.exit(supervisor.run_resuming(base, lambda: find_last_stage1_checkpoint(run_dir), args.max_restarts,
                                         args.hang_timeout_min))
    if args.train_center_and_boundary:
        train_center_and_boundary(args)
    elif args.train_existence:
        train_existence(args)
    else:
        print("Please Specify Models To Be Trained.")


if __name__ == "__main__":
    main()
