#!/usr/bin/env python3
"""Where the PyTorch port's discovery time goes on one CUDA card.

    python3 scripts/torch_discovery_profile.py

Runs the main path of ``chip_smoke.py`` (DPT-Large + ResNet-50 in bf16,
seeded random weights, the same cuts and images) three times:

1. a warm-up run;
2. a run with each engine phase and each model call timed on the host
   clock between two ``torch.cuda.synchronize()`` calls (inclusive
   seconds: a phase's time holds its model calls);
3. a run under ``torch.profiler`` with no ranges, whose device kernels are
   summed by category (convolution, layout transposes, GEMM, elementwise,
   ...) against that run's wall: the device's busy share.

Prints one JSON line with the card (nvidia-smi name and power limit).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

# first matching pattern names a kernel's category
CATEGORIES = (
    ("decode_kernel", r"union_pack|erode_score|decode_keys"),
    ("layout_transpose", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"fprop|dgrad|conv|implicit_gemm|cudnn"),
    ("gemm", r"gemm|nvjet|cutlass|xmma"),
    ("softmax", r"softmax"),
    ("norm", r"layer_norm|batch_norm|bn_fw|LayerNorm"),
    ("reduce", r"reduce_kernel"),
    ("index_gather", r"index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unmore_tpu_torch.ops import cuda_build
    from unmore_tpu_torch.reasoning import engine as engine_mod
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profile measures the card")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_build.build(list(chip_smoke.KERNEL_SOURCES))
    _, _, (obj_fn, cls_fn), cuts, images = chip_smoke.main_path_setup(device)
    cfg = ReasoningConfig(**cuts)

    engine = ObjectDiscoveryEngine(obj_fn, cls_fn, cfg, device=device)
    engine.discover_batch(images)  # warm-up
    torch.cuda.synchronize()

    # run 2: synchronized host-clock ranges
    seconds, calls = defaultdict(float), defaultdict(int)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return wrapper

    originals = {n: getattr(engine_mod, n) for n in
                 ("crop_and_resize", "label_components", "component_boxes", "fused_center_decode")}
    for name, fn in originals.items():
        setattr(engine_mod, name, timed(f"op:{name}", fn))
    ranged = ObjectDiscoveryEngine(timed("model:objectness", obj_fn), timed("model:classifier", cls_fn), cfg,
                                   device=device)
    for name in ("_existence_phase", "_center_phase", "_boundary_phase", "_batched_nms"):
        setattr(ranged, name, timed(f"phase:{name.strip('_')}", getattr(ranged, name)))
    t0 = time.perf_counter()
    ranged.discover_batch(images)
    torch.cuda.synchronize()
    ranged_wall = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(engine_mod, name, fn)

    # run 3: device kernels under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.discover_batch(images)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_cat, kernels = defaultdict(float), []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_cat[category(evt.key)] += us / 1e6
        kernels.append((us / 1e6, evt.count, evt.key[:120]))
    busy = sum(by_cat.values())
    kernels.sort(reverse=True)
    print(json.dumps({
        "card": smi,
        "ranged_run": {"wall_s": ranged_wall, "inclusive_s": dict(sorted(seconds.items(), key=lambda kv: -kv[1])),
                       "calls": dict(calls)},
        "profiled_run": {
            "wall_s": prof_wall, "device_busy_s": busy if busy else "not measured",
            "device_busy_share": busy / prof_wall if busy else "not measured",
            "kernel_s_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"s": s, "launches": n, "name": k} for s, n, k in kernels[:12]],
        },
    }))


if __name__ == "__main__":
    main()
