#!/usr/bin/env python3
"""Where a stage-1 training step of the PyTorch port spends its time, on one card.

    python3 scripts/torch_train_profile.py [--steps 20] [--profile-steps 3]

For the objectness trainer (DPT-Large, tanh bg-SDF) and the existence
classifier (ResNet-50) at the ``script.sh`` recipe (batch 20 at 128^2, bf16
autocast over f32 weights, Adam), in one process:

* ``fixed``: synchronised steps on one batch already on the card (no data
  pipeline), the median step ms;
* ``prefetch``: the same steps fed by ``chip_smoke.py``'s in-process
  synthetic world through the prefetch threads, as the smoke runs them; the
  difference to ``fixed`` is what the host-side data work (which shares the
  interpreter lock with the thread that launches the kernels) costs;
* ``fixed_cudnn_benchmark``: ``fixed`` again with
  ``torch.backends.cudnn.benchmark = True``;
* the optimizer step alone (events around ``Optimizer.step``);
* a ``torch.profiler`` trace of ``--profile-steps`` fixed steps: device
  kernel time by category, the device's busy share of the traced wall.

Prints one JSON line per trainer, then the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("layout transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("gemm", ("gemm", "sm90_xmma", "cutlass", "cublas")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop")),
    ("normalization", ("norm",)),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "fill", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def median_step_ms(trainer, next_batch, steps, sync):
    seconds = []
    for _ in range(steps):
        batch = next_batch()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        sync()
        seconds.append(time.perf_counter() - t0)
    return statistics.median(seconds) * 1e3


def optimizer_ms(trainer, iters=10):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    trainer.opt.step()
    start.record()
    for _ in range(iters):
        trainer.opt.step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(trainer, batch, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_cat, n_kernels = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            cat = category(evt.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + evt.self_device_time_total / 1e3 / steps
            n_kernels += evt.count
    busy = sum(by_cat.values())
    return {"traced_step_wall_ms": wall / steps * 1e3, "device_ms_per_step": busy,
            "busy_share": busy / (wall / steps * 1e3), "kernels_per_step": n_kernels / steps,
            "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))}


def run(name, trainer, worker, device, args):
    import torch

    import chip_smoke
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.train.objectness import to_device

    def sync():
        torch.cuda.synchronize(device)

    prefetch = PrefetchIterator(worker_fns=[worker(100 + w) for w in range(chip_smoke.TRAIN_WORKERS)])
    try:
        fixed = to_device(next(prefetch), device)
        for _ in range(5):  # warm-up: allocator, cuDNN plans
            trainer.train_step(fixed)
        out = {"trainer": name,
               "fixed_step_ms": median_step_ms(trainer, lambda: fixed, args.steps, sync),
               "prefetch_step_ms": median_step_ms(trainer, lambda: to_device(next(prefetch), device), args.steps, sync),
               "starved_fraction": prefetch.starved_fraction}
    finally:
        prefetch.close()
    out["fixed_step_ms_again"] = median_step_ms(trainer, lambda: fixed, args.steps, sync)
    out["optimizer_ms"] = optimizer_ms(trainer)
    out["profile"] = profile(trainer, fixed, args.profile_steps)
    torch.backends.cudnn.benchmark = True
    for _ in range(3):
        trainer.train_step(fixed)
    out["fixed_cudnn_benchmark_step_ms"] = median_step_ms(trainer, lambda: fixed, args.steps, sync)
    torch.backends.cudnn.benchmark = False
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--profile-steps", type=int, default=3)
    args = p.parse_args()

    import torch

    import chip_smoke
    from unmore_tpu_torch.cli.common import build_classifier, build_objectness
    from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.train.classifier import ClassifierTrainer
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer
    from unmore_tpu_torch.train.optim import init_like_flax

    if not torch.cuda.is_available():
        sys.exit("torch_train_profile.py measures the card: no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, masks = chip_smoke.shape_world(seed=0, **chip_smoke.TRAIN_WORLD)

    model = build_objectness(chip_smoke.DptLarge, "float32", device)
    init_like_flax(model, seed=0)
    trainer = ObjectnessTrainer(model, TrainObjectnessConfig(model=ModelConfig(dtype="bfloat16")))
    print(json.dumps(run("objectness", trainer, lambda s: chip_smoke.objectness_worker(images, masks, s), device, args)),
          flush=True)
    del trainer, model
    torch.cuda.empty_cache()

    model = build_classifier("float32", device)
    init_like_flax(model, seed=0)
    trainer = ClassifierTrainer(model, OptimConfig(), "bfloat16")
    print(json.dumps(run("classifier", trainer, lambda s: chip_smoke.classifier_worker(images, masks, s), device, args)),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
