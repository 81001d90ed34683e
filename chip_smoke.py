#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one card.

    python3 chip_smoke.py

Runs only ``unmore_tpu_torch`` (no JAX) on CUDA device 0, in thirteen
phases, each printing one JSON line:

1. build: the card's name and power limit (nvidia-smi) and the seconds that
   nvcc took to build every kernel of the main path from ``unmore_tpu_torch/csrc``
   (and g++ the host libraries ``csrc/{paste,labels,cocoeval,flax_init}.cpp``, in
   parallel);
2. kernel: ``fused_center_decode`` against its plain PyTorch version on the
   card at the main path's shapes [256,128,128] and [32,128,128] and on a
   dense [256,128,128] input where every crop scores (union exact, scores
   to atol 2e-5, argmax equal where the score is > 1e-4), with the bound,
   the plain version's time and two times of the kernel: ``ms`` from events
   around back-to-back wrapper calls (host work included) and
   ``device_ms``, its launches' own device time from ``torch.profiler``;
3. main_path: ``ObjectDiscoveryEngine.discover_batch`` on two seeded uint8
   images with DPT-Large (ViT-L/16, features 256, tanh bg-sdf) and the full
   ResNet-50 classifier, seeded random weights, bf16 (a smaller canvas and
   lattices, and thresholds set for random weights); launch counts are
   zeroed just before and read just after, and every kernel of the path
   must have launched; a run with the plain decode, made first, must give
   the same results; model FLOPs are counted per crop and per phase; both
   bf16 models must hold their norms' leaves in float32. The
   path's first center chunk is kept, and after the run the kernel is held
   against its plain version and timed on it, as in phase 2;
4. scoring: ``ObjectScoringEngine.score_batch`` at the ``ScoringConfig``
   defaults with phase 3's models on four seeded uint8 images (phase 3's two
   and 480x640, 640x427) with 64 boxes each, phase 3's discovered boxes
   topped up with seeded random ones: a 256-slot lattice in two model
   chunks. Checks: the host library's tight boxes, areas and RLEs equal its
   plain version on the same union masks; the batched call equals four
   ``score_image`` calls; ``post_process.py`` takes the annotation JSON.
   Timings, crops per second, model FLOPs and MFU, peak memory;
5. bf16: the full-width ObjectnessNet's f32 and bf16 forwards on 8 crops;
6. train: stage 1 at the ``script.sh`` recipe (batch 20 at 128^2, bf16
   autocast over f32 weights, Adam 1e-4 on milestones 10000/20000). A seeded
   synthetic VoteCut world made in process goes through ``synthesize_labels``
   / ``classifier_sample``, ``batch_iterator`` and the prefetch threads into
   30 steps of the DPT-Large objectness trainer and 30 of the ResNet-50
   existence classifier: synchronised step ms (median of steps 11-30),
   img/s, fwd+bwd FLOPs (``FlopCounterMode``), MFU, peak memory, loss trace,
   ``starved_fraction``. Checks: a NaN batch is skipped with parameters and
   optimizer state unchanged; the loss of a fresh trainer falls on a fixed
   batch (at 1/10 of the rate, past Adam's first-step transient); the classifier
   evaluates; one f32 step of a narrow model on the card against the CPU;
   each trainer's checkpoint through the async writer reads back leaf for
   leaf, and loads through ``cli/common.py`` into the stage-2 engine, which
   runs one discovery image group on the trained weights;
7. cad: stage 3, the CAD Cascade Mask R-CNN of
   ``cad/configs/cascade_mask_rcnn_R_50_FPN.yaml`` at full width (R50-FPN,
   1000 proposals, 3 cascade stages, masks, 100 detections, canvas 1024,
   batch 4, bf16, seeded random weights) through ``DetectorEvaluator.predict_batch``
   on four seeded synthetic scenes with exact GT (480x640, 640x427,
   375x500, 800x800), then ``evaluate_ap`` on boxes and masks: img/s, the
   synchronised seconds of trunk+FPN, RPN+proposals (NMS rounds counted),
   cascade, mask head, host paste+RLE and evaluation, RoIAlign alone,
   GFLOP an image, MFU, peak memory. Checks: the host library's mask IoU,
   matching and uint8 resize equal their plain versions; batched f32 calls
   equal per-image calls; an f32 narrow detector on the card agrees with
   the CPU; the bf16 detector holds its BatchNorms' leaves in float32. The
   path runs no kernel of ``csrc/*.cu`` (the JAX package's
   detector reaches no Pallas kernel);
8. cad_train: CAD training through ``cli/train_net.py``'s ``train_detector``
   at the YAML's full width (batch 16, canvas 1024, copy-paste, remat, SGD
   with warmup and clipping, bf16 autocast over f32 weights, seeded random
   weights) for 30 steps on 32 synthetic scenes made in memory, fed by 4
   prefetch threads; checkpoints at steps 15 and 30, PreciseBN and the
   in-train eval (phase 7's scenes) at 30: median synchronised step of steps
   6-30 and on a fixed batch, img/s, FLOPs of a step (``FlopCounterMode``),
   MFU, ``data_starved``, peak memory, losses, checkpoint bytes and seconds,
   PreciseBN and eval seconds. Checks: every loss finite; the step-15
   checkpoint reads back leaf for leaf; a trainer resumed from it runs step
   16; a NaN step keeps parameters and statistics and moves step, count and
   trace as optax does; the samplers' draws of one step at batch 16
   (``jax.random``'s threefry stream, 4.26 M uniforms) on the card equal the
   CPU's bit for bit, and ``next_draws`` is timed (median of 20 synchronised
   calls, and its kernels' device time); on a narrow detector (trunk
   (1,1,1,1), canvas 256, top-k 128, 32 RoIs), one f32 step on the card against the CPU replaying
   the card's discrete decisions (losses 1e-4 relative, gradient 1e-3 of
   its max-abs or twice the CPU's own f32-to-f64 distance, parameters 1e-6)
   and remat on against off (equal statistics). The bf16 gradient against
   the f32 one (same decisions) is reported. No kernel of ``csrc/*.cu`` runs
   here either;
9. hybrid: the ``dpt_hybrid`` ObjectnessNet (ResNetV2-50 trunk (3, 4, 9)
   with GroupNorm(32) and weight-standardised convs, ViT-B/16 tapped at blocks
   8 and 11, reassemble widths (256, 512, 768, 768), features 256, tanh
   bg-sdf; seeded ``init_like_flax`` weights) at full width: 30 steps of
   phase 6's recipe on phase 6's world through the prefetch threads (no step
   may be skipped), then steps on a fixed batch (synchronised ms, FLOPs of a
   step, MFU, peak memory, parameters), its checkpoint read back leaf for
   leaf; the trained weights through ``cli/common.py``'s loader into the bf16
   stage-2 engine (trunk kernels kept in f32, the rest rounded to bf16) and
   one discovery image group at phase 3's images and cuts, the threshold
   calibrated on this model (30 steps leave the SDF negative everywhere: the
   group drops every proposal in the first boundary round), then the same
   group on phase 3's seeded random weights with the reference's rounds
   (``sticky_convergence=False``), which must run all 50: wall, GFLOP a crop,
   MFU, peak, live and executed crops; decode launches counted
   from zero over both groups, each launch's output equal to the plain
   version's on its inputs (max abs error 0.0); one scoring call at phase 4's
   inputs (``device_s``, ``host_s``, MFU); a narrow f32 hybrid on the card
   against the CPU (forward atol 1e-4, losses rtol 1e-5, gradient rel L2
   1e-3); bf16 against f32 at full width on one 256-crop chunk whose first 8
   crops are phase 5's, beside phase 5's DPT-Large figures;
10. dist: data parallelism (``unmore_tpu_torch/parallel``). A one-rank NCCL
   group (``initialize`` given the address and one process; backend and NCCL
   version printed) runs a DPT-Large stage-1 step's flat-gradient
   ``all_reduce_mean_`` (equal bits) and one ``all_gather_objects``. Then two
   ranks share the one card over gloo (NCCL refuses two ranks on one device),
   spawned through ``parallel/mesh.py`` with a group timeout of 600 s and a
   join timeout of 600 s that kills them and fails, each against one rank on
   the same global batches: (a) DPT-Large at the ``script.sh`` recipe's
   global batch 20 (10 a rank), 3 steps in f32 with TF32 off (first loss
   rel 1e-6, first gradient rel L2 1e-4, parameters within 2.01 * steps * lr:
   an Adam step moves a weight by at most ~1.004 lr in its first steps, either
   way where its gradient is within rounding of zero; the later losses, which
   the recipe's rate throws up by orders of magnitude, are reported), then
   6 bf16 steps timed, fed by the host's stream (each rank keeps its rows);
   (b) one f32 step of the ResNet-50 classifier (loss rel 1e-5; the flat
   gradient as close to the float64 one, in rel L2, as twice one rank's f32
   gradient is: BatchNorm at random initialisation makes it ill-posed;
   running statistics atol 1e-5 of their scale); (c) the CAD at
   full width, global batch 16 (8 a rank): one f32 step on the global
   batch's draws with the one-rank run's decisions replayed (losses rel
   1e-4, parameters 1e-6, BatchNorm statistics 1e-4), then 4 bf16 steps
   timed with ``data_starved``; (d) discovery through the CLI on phase 3's
   images and two more (phase 3's cuts, one image a group, f32, sticky
   convergence, 5 boundary rounds, model chunks of 64 crops): the merged
   ``discovery_results.json`` equal to the one-rank
   run's, every decode launch of each rank equal to the plain version; (e)
   scoring of those boxes through the CLI, the merged annotations equal to
   the one-rank run's after sorting. Per-rank peaks, times and ``phase_s``
   are printed as two processes sharing one card, not a scaling figure;
11. chain: the whole three-stage chain, ``python -m
   unmore_tpu_torch.scripts.scale_chain`` (every CLI a child process, each
   trainer and stage-2 CLI supervised) on a world it writes to
   ``build/smoke_chain``: 6 scenes at 320^2, 2 of them dense, and 60
   single-shape images; DPT-Large stage 1 and the ResNet-50 classifier at
   the recipe (batch 20, bf16, ``--max_restarts 1``) for 200 steps and one
   checkpoint each; discovery in two segments of 3 scenes at phase 3's
   canvas, image batch and lattices and every other default; scoring,
   ``post_process.py``, the port's evaluator, the merge; the CAD's YAML at
   batch 8 for 30 steps, one checkpoint, evaluated at the end; then the two
   dense-tail A/Bs on the 2 dense scenes (one image group; r5 ran 40):
   ``max_active_ab`` with the truncated lattice at 256, half the chain's
   512 (r5: 1024 against 1536), and ``sticky_ab``, both legs in bf16.
   Checks: the chain exits 0 with no failed step, within 900 s (its process
   group is killed then); the files ``tests/test_scale_chain.py`` checks
   exist; discovery finds boxes on at least 5 of the 6 scenes; the report
   holds both legs of ``max_active_ab`` and a fresh ``sticky_ab_dense``
   whose boundary-crop ratio is at least 1; the first segment's discovery
   run again in this process through the CLI's entry on the chain's
   checkpoints launches the decode kernel, every launch equal to the plain
   version (max abs error 0.0), and gives the boxes of the chain's
   ``discovery_results.json``; the sticky A/B's ``reference_rounds`` leg run
   again in this process through the script's entry the same way, every
   decode launch exact, with the chain's boundary crops, annotations and
   AP figures; DPT-Large's f32 forward on 8 crops with two crops a packed
   ViT sequence (``--vit_pack 2``) within 1e-4 of the unpacked one, and both
   bf16 forwards timed on a 256-crop chunk. Printed: each stage's wall
   (``scale_timings.txt``), discovery img/s, scoring's device / host split,
   bbox and segm AP and AP50 of the pseudo-labels, the CAD's img/s and its
   evaluation, and of the A/Bs each leg's AP and AP50, the boundary crops,
   discovery walls, the truncated leg's ``active_overflow`` and both deltas;
12. parity: the real-weights parity harness, ``python -m
   unmore_tpu_torch.scripts.check_parity``, as a child on the card at tol
   1e-3 on a fixture in the reference's formats: DPT-Large (tanh, bg-sdf)
   and the ResNet-50 classifier with seeded random weights saved as
   ``{'model_state_dict': ...}`` ``.ckpt`` files, and an npz in the dump's
   NCHW layout of two 128^2 crops through an f32 forward on the CPU with
   hooks at the reference's taps (``scratch.layer{1..4}_rn``,
   ``scratch.refinenet{1..4}``). It must print ``PARITY OK`` and exit 0, and
   exit 1 with one ``scratch`` weight moved by 0.05. Printed: each tap's
   max abs difference, card against CPU;
13. init: flax's seeded init (``models/flax_init.py``), the one that every
   phase's seeded weights come from, of DPT-Large + ResNet-50 (stage 2's
   ``init_random_variables``), of ``dpt_hybrid`` and of the CAD (the YAML's
   detector), from seed 0 on the card (twice: cold, then warm) and on the
   CPU (the host library ``csrc/flax_init.cpp``). Checks: every element of
   every random leaf within 2 ulp of the CPU's, every zero and one leaf
   exact. Printed: each side's wall, elements, leaves, max ulp and the share
   of bit-equal elements.

Every phase line carries the card's name and power limit (nvidia-smi).
Then the kernels' JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
KERNEL_SOURCES = {"decode": "unmore_tpu_torch/csrc/decode.cu"}
DECODE_LAUNCHES = "ops.decode.launches"  # the port's tracer counts the decode kernel's launches here
# host code, not kernels: the paste-back of scoring and of the detector's masks, the label
# synthesis and image resizes, the COCO evaluator's mask IoU and matching, flax's seeded
# init on the CPU
HOST_SOURCES = {"paste": "unmore_tpu_torch/csrc/paste.cpp", "labels": "unmore_tpu_torch/csrc/labels.cpp",
                "cocoeval": "unmore_tpu_torch/csrc/cocoeval.cpp", "flax_init": "unmore_tpu_torch/csrc/flax_init.cpp"}
H100_BF16_FLOPS = 989e12  # dense bf16, H100 SXM data sheet


class DptLarge:
    """The main path's ObjectnessNet flags (the reference's canonical point)."""

    backbone_type, sdf_activation, use_bg_sdf = "dpt_large", "tanh", True


# the main path's cut: every value that differs from ReasoningConfig's default
# (and center_score_max_thres, set from the data: see calibrate)
MAIN_PATH_CUTS = dict(canvas_size=320, image_batch=2, max_proposals=512, max_splits=512,
                      max_active=512, class_score_thres=0.0)


CARD = {"nvidia_smi": None}  # the card's name and power limit, printed beside each phase's numbers


def emit(obj):
    if "phase" in obj:
        obj = {"phase": obj["phase"], "nvidia_smi": CARD["nvidia_smi"], **obj}
    print(json.dumps(obj), flush=True)


def norm_leaves(model):
    """The floating leaves of ``model``'s norms (and weight-standardised
    convolutions) and the names of those not in float32: a bf16 model keeps
    them in float32, as flax does."""
    import torch

    from unmore_tpu_torch.models.norms import KeepsFloat32

    leaves = {f"{name}.{leaf}": t for name, m in model.named_modules() if isinstance(m, KeepsFloat32)
              for leaf, t in (*m.named_parameters(recurse=False), *m.named_buffers(recurse=False))
              if t.is_floating_point()}
    return {"count": len(leaves), "not_float32": [n for n, t in leaves.items() if t.dtype != torch.float32]}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3):
    """Milliseconds per call, from events around back-to-back calls: the
    host's work in the call counts where it is longer than the device's."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """The kernels' own time per call: every CUDA kernel that ``iters``
    calls launched, summed from ``torch.profiler``'s ``key_averages()``.
    Returns (ms per call, {kernel name: ms per call})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):  # CUPTI has returned an empty trace once on an H100 host: trace again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel = {evt.key[:80]: evt.self_device_time_total / 1e3 / iters
                     for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA}
        if sum(by_kernel.values()) > 0:
            return sum(by_kernel.values()), by_kernel
    fail("torch.profiler recorded no device time for the kernel in two traces")


def replaces_of(source: str) -> str:
    """The TPU kernel a CUDA source replaces, from its 'Replaces:' note."""
    m = re.search(r"Replaces:\s*(\S+)", Path(source).read_text())
    if m is None:
        fail(f"{source} names no TPU kernel it replaces")
    return m.group(1)


# ------------------------------------------------------------------ phase 2
def decode_inputs(B, S, seed, device):
    """Random fields, blob crops with real eroded interiors, and one
    all-background crop."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    sdf = torch.randn(B, S, S, generator=g, device=device) * 2
    center = torch.randn(B, S, S, 2, generator=g, device=device)
    for b in range(min(B - 1, 8)):  # blobs of several sizes
        m = 8 + 4 * b
        sdf[b] = -1.0
        sdf[b, m : S - m, m + b : S - m] = 2.0
        center[b] *= 0.3
    sdf[B - 1] = -1.0
    center[B - 1] = 0.0
    return sdf.contiguous(), center.contiguous()


def dense_decode_inputs(B, S, seed, device):
    """Every crop all foreground: the eroded interior, and so the scored
    region, is as large as it can be."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    sdf = 1.0 + torch.randn(B, S, S, generator=g, device=device).abs()
    center = torch.randn(B, S, S, 2, generator=g, device=device) * 0.3
    return sdf, center


def decode_bound_ms(B, S, union, border=10, erode_k=9, erode_rounds=3, anti_k=5):
    """Least time for the decode on an H100: the larger of the bytes it must
    move (inputs read once, outputs written once) over HBM bandwidth and its
    f32/compare operations over the f32 rate. The anti-center sum runs only
    on eroded interior pixels of this run's union."""
    from unmore_tpu_torch.ops.fields import batch_erode

    n_bytes = B * S * S * (4 + 8 + 4) + B * (4 + 8)
    eroded = batch_erode(union, erode_k, erode_rounds)
    n_score = int(eroded[:, border : S - border, border : S - border].sum())
    taps = anti_k * anti_k - 1
    ops = B * S * S * (4 + 2 * erode_k * erode_rounds + 2) + n_score * (4 * taps + 1)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes


def decode_row(name, sdf, center, require_scored=True):
    """Hold the kernel against its plain version on one input (union exact,
    scores to atol 2e-5, argmax equal where the score is > 1e-4) and time
    both beside the bound."""
    import torch

    from unmore_tpu_torch.ops.decode import fused_center_decode
    from unmore_tpu_torch.ops.fields import center_singularity_scores

    got = fused_center_decode(sdf, center)
    want = center_singularity_scores(sdf, center)
    torch.cuda.synchronize()
    if not torch.equal(got[2], want[2]):
        fail(f"decode kernel union differs from the plain version on {name}")
    err = float((got[0] - want[0]).abs().max())
    if not err <= 2e-5:
        fail(f"decode kernel scores differ by {err} on {name} (atol 2e-5)")
    pos = want[0] > 1e-4
    if require_scored and int(pos.sum()) == 0:
        fail(f"no crop gave a meaningful score on {name}: the check would be empty")
    if not torch.equal(got[1][pos], want[1][pos]):
        fail(f"decode kernel argmax differs from the plain version on {name}")
    B, S, _ = sdf.shape
    bound_ms, bound_by, n_bytes = decode_bound_ms(B, S, want[2])
    dev_ms, by_kernel = device_ms(lambda: fused_center_decode(sdf, center))
    return {
        "input": name, "shape": [B, S, S], "max_abs_err": err, "n_scored_crops": int(pos.sum()),
        "ms": time_ms(lambda: fused_center_decode(sdf, center)), "device_ms": dev_ms,
        "device_ms_by_kernel": by_kernel,
        "plain_ms": time_ms(lambda: center_singularity_scores(sdf, center)),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
    }


def phase_kernel(device):
    rows = {
        "random_256": decode_row("random_256", *decode_inputs(256, 128, 256, device)),
        "random_32": decode_row("random_32", *decode_inputs(32, 128, 32, device)),
        "dense_256": decode_row("dense_256", *dense_decode_inputs(256, 128, 7, device)),
    }
    emit({"phase": "kernel", "name": "fused_center_decode", "tolerance": {"scores_atol": 2e-5},
          "results": list(rows.values())})
    return rows


# ------------------------------------------------------------------ phase 3
def synthetic_images(seed, sizes=((320, 320), (240, 300))):
    """uint8 scenes of the given sizes: a few flat-coloured rectangles and
    discs on a noisy background."""
    import numpy as np

    rng = np.random.RandomState(seed)
    images = []
    for h, w in sizes:
        img = (rng.rand(h, w, 3) * 40 + 100).astype(np.float32)
        yy, xx = np.mgrid[:h, :w]
        for _ in range(5):
            colour = rng.rand(3) * 255
            cy, cx = rng.randint(20, h - 20), rng.randint(20, w - 20)
            r = rng.randint(15, 60)
            if rng.rand() < 0.5:
                sel = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r * 0.7)
            else:
                sel = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[sel] = colour
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def calibrate(objectness, image, cfg, device):
    """``center_score_max_thres`` for random weights, whose singularity
    scores lie far above a trained model's (every proposal would split and
    none would reach the boundary phase): the median score over one chunk
    of the image's seed crops, so that about half the proposals split and
    half go on to the boundary rounds."""
    import numpy as np
    import torch

    from unmore_tpu_torch.ops.fields import center_singularity_scores
    from unmore_tpu_torch.ops.image import crop_and_resize
    from unmore_tpu_torch.reasoning.proposals import seed_proposals

    seeds = seed_proposals(*image.shape[:2]).astype(np.float32)[: cfg.crop_chunk]
    canvas = torch.from_numpy(image).to(device).float()[None] / 255.0
    idx = torch.zeros(len(seeds), dtype=torch.long, device=device)
    crops = crop_and_resize(canvas, torch.from_numpy(seeds).to(device), cfg.crop_size, cfg.gather_chunk, idx)
    with torch.inference_mode():
        out = objectness(crops)
    sing = center_singularity_scores(out["sdf_maps"], out["center_fields"])[0]
    return {"center_score_max_thres": float(sing.median())}


def main_path_setup(device):
    """DPT-Large + ResNet-50 in bf16 with seeded random weights, the two
    seeded images and the main path's config (cuts plus calibration)."""
    from unmore_tpu_torch.cli.common import (
        build_classifier, build_objectness, init_random_variables, make_apply_fns,
    )
    from unmore_tpu_torch.reasoning.engine import ReasoningConfig

    objectness = build_objectness(DptLarge, "bfloat16", device)
    classifier = build_classifier("bfloat16", device)
    init_random_variables(objectness, classifier, seed=0)
    images = synthetic_images(seed=0)
    cuts = dict(MAIN_PATH_CUTS, **calibrate(objectness, images[0], ReasoningConfig(), device))
    return objectness, classifier, make_apply_fns(objectness, classifier), cuts, images


def model_flops_per_crop(objectness, classifier, crop_size, device):
    """Matmul and convolution FLOPs of one crop's forward, counted by
    PyTorch's FlopCounterMode: (both heads, SDF head only, classifier)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    crop = torch.zeros(1, crop_size, crop_size, 3, device=device)
    out = []
    for fn in (lambda: objectness(crop), lambda: objectness(crop, compute_center=False), lambda: classifier(crop)):
        counter = FlopCounterMode(display=False)
        with torch.inference_mode(), counter:
            fn()
        out.append(counter.get_total_flops())
    return out


def executed_crops(n_live, chunk, tail):
    """Crops a live-prefix map runs for ``n_live`` live rows: full chunks,
    then tail chunks over the rest (dead rows in the last tail chunk run too)."""
    full = (n_live // chunk) * chunk
    return full + -(-(n_live - full) // tail) * tail


def crop_counts(results, cfg):
    """(live, executed) crops of each model phase of one discovery image group."""
    s0 = results[0]["stats"]
    exist_tail = min(cfg.crop_chunk, cfg.exist_tile) if cfg.exist_tile > cfg.crop_chunk else cfg.tail
    n_seed = sum(r["stats"]["n_seed"] for r in results)
    n_split_kept = min(s0["n_split"], cfg.max_splits * cfg.image_batch)
    live = {"existence": n_seed + n_split_kept, "center": s0["n_center_in"],
            "recheck_center": s0["n_recheck_center_in"], "boundary": sum(s0["boundary_active_trace"])}
    executed = {
        "existence": sum(executed_crops(n, cfg.exist_tile, exist_tail) for n in (n_seed, n_split_kept)),
        "center": executed_crops(s0["n_center_in"], cfg.crop_chunk, cfg.tail),
        "recheck_center": executed_crops(s0["n_recheck_center_in"], cfg.crop_chunk, cfg.tail),
        "boundary": sum(executed_crops(n, cfg.crop_chunk, cfg.tail) for n in s0["boundary_active_trace"]),
    }
    return live, executed


def group_flops(executed, both, sdf_only, cls):
    """Model FLOPs of a group: the classifier on the existence crops, both
    heads on the center crops, the SDF head on the boundary rounds."""
    return (executed["existence"] * cls + (executed["center"] + executed["recheck_center"]) * both
            + executed["boundary"] * sdf_only)


def check_boxes(images, results, what):
    """Every image's boxes: finite [n, 4] inside the image."""
    import numpy as np

    for img, res in zip(images, results):
        b = res["boxes"]
        if b.ndim != 2 or b.shape[1] != 4 or not np.isfinite(b).all():
            fail(f"{what} returned malformed boxes {b.shape}")
        h, w = img.shape[:2]
        if len(b) and ((b[:, :2] < 0).any() or (b[:, 2] > w).any() or (b[:, 3] > h).any()):
            fail(f"{what} returned boxes outside the image")


def phase_main_path(device, kernel_counters):
    import numpy as np
    import torch

    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig

    objectness, classifier, fns, cuts, images = main_path_setup(device)
    cfg = ReasoningConfig(**cuts)

    # the same run with the decode's plain version, first: it warms cuDNN and
    # the allocator up, and the kernel run below must give the same result
    plain = ObjectDiscoveryEngine(*fns, ReasoningConfig(**cuts, use_decode_kernel=False), device=device)
    t0 = time.perf_counter()
    reference = plain.discover_batch(images)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    engine = ObjectDiscoveryEngine(*fns, cfg, device=device)
    first_chunk = []  # the main path's first center chunk, timed on its own below

    def capture(sdf, center, decode=engine._decode):
        if not first_chunk:
            first_chunk.extend((sdf.clone(), center.clone()))
        return decode(sdf, center)

    engine._decode = capture
    torch.cuda.reset_peak_memory_stats()
    start = launch_counts(kernel_counters)
    t0 = time.perf_counter()
    results = engine.discover_batch(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernel_counters, since=start)
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")

    check_boxes(images, results, "discover_batch")
    for res, ref in zip(results, reference):
        if res["stats"] != ref["stats"] or not np.array_equal(res["boxes"], ref["boxes"]):
            fail(f"kernel and plain decode disagree end to end: {res['stats']} vs {ref['stats']}")

    live, executed = crop_counts(results, cfg)
    both, sdf_only, cls = model_flops_per_crop(objectness, classifier, cfg.crop_size, device)
    flops = group_flops(executed, both, sdf_only, cls)
    norms = {"objectness": norm_leaves(objectness), "classifier": norm_leaves(classifier)}
    if any(v["not_float32"] or not v["count"] for v in norms.values()):
        fail(f"bf16 main-path models with norm leaves not in float32: {norms}")
    emit({
        "phase": "main_path", "model": "dpt_large (vitl16_384, features 256, tanh bg-sdf) + resnet50, bf16",
        "norm_leaves": norms, "wall_s_pr10": 14.218,
        "cuts": cuts, "crop_size": cfg.crop_size, "crop_chunk": cfg.crop_chunk,
        "crop_chunk_tail": cfg.crop_chunk_tail, "wall_s": wall, "plain_decode_wall_s": plain_wall,
        "live_crops_per_phase": live, "executed_crops_per_phase": executed,
        "gflop_per_crop": {"objectness_both_heads": both / 1e9, "objectness_sdf_only": sdf_only / 1e9,
                           "classifier": cls / 1e9},
        "model_tflop": flops / 1e12, "achieved_tflop_per_s": flops / wall / 1e12,
        "mfu_vs_989_tflops_bf16": flops / wall / 989e12,
        "kernel_launches": launches, "max_memory_allocated_bytes": peak,
        "stats": [r["stats"] for r in results], "n_boxes": [len(r["boxes"]) for r in results],
    })
    # outside the counted run: the kernel against its plain version on that chunk
    chunk_row = decode_row("main_path_chunk", *first_chunk, require_scored=False)
    emit({"phase": "kernel_main_path_chunk", "name": "fused_center_decode", "result": chunk_row})
    return {"objectness": objectness, "fns": fns, "images": images, "results": results, "launches": launches,
            "cuts": cuts,
            "chunk_row": chunk_row, "gflop_per_crop": {"both_heads": both / 1e9, "classifier": cls / 1e9}}


# ------------------------------------------------------------------ phase 4
SCORING_BOXES_PER_IMAGE = 64


def scoring_inputs(discovered, seed=1):
    """Phase 3's two images and two more (480x640, 640x427), each with 64
    boxes: the discovered ones first, topped up with seeded random boxes
    inside the image."""
    import numpy as np

    images = synthetic_images(seed=0) + synthetic_images(seed, sizes=((480, 640), (640, 427)))
    rng = np.random.RandomState(seed)
    boxes = []
    for g, img in enumerate(images):
        h, w = img.shape[:2]
        found = discovered[g]["boxes"] if g < len(discovered) else []
        found = np.asarray(found, np.float32).reshape(-1, 4)[:SCORING_BOXES_PER_IMAGE]
        n = SCORING_BOXES_PER_IMAGE - len(found)
        wh = rng.uniform([16, 16], [0.6 * w, 0.6 * h], (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - wh)
        boxes.append(np.concatenate([found, np.concatenate([xy, xy + wh], 1).astype(np.float32)]))
    return images, boxes


def check_pastes(calls):
    """Every recorded paste of the host library against its plain version:
    (tight boxes and areas, RLEs) exact. Returns the number of mismatches."""
    import numpy as np

    from unmore_tpu_torch.ops.paste import paste_rle_plain, paste_stats_plain

    bad = 0
    for kind, args, got in calls:
        if kind == "stats":
            want = paste_stats_plain(*args)
            bad += int(not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])))
        else:
            bad += int(got != paste_rle_plain(*args))
    return bad


def compare_annotations(batched, single):
    """(largest score difference relative to the score, list of mismatches
    in counts, tight boxes or segmentations, scores beyond rtol 1e-3)."""
    diffs, problems = [0.0], []
    for g, (a, b) in enumerate(zip(batched, single)):
        if len(a) != len(b):
            problems.append(f"image {g}: {len(a)} annotations batched, {len(b)} alone")
            continue
        for x, y in zip(a, b):
            if x["bbox"] != y["bbox"] or x["segmentation"] != y["segmentation"]:
                problems.append(f"image {g}: tight box or segmentation differs")
            for key in ("score", "existence_score", "center_score", "boundary_score", "area_score"):
                d = abs(x[key] - y[key])
                diffs.append(d / max(abs(y[key]), 1e-30) if d else 0.0)
                if d > 1e-3 * abs(y[key]):
                    problems.append(f"image {g}: {key} {x[key]} batched, {y[key]} alone")
    return max(diffs), problems


def run_post_process(anns, images):
    """``post_process.py`` on the annotation JSON in a subprocess, with
    thresholds that keep every annotation: it must exit 0 and keep them all."""
    from unmore_tpu_torch.cli.common import NpEncoder

    folder = Path("build") / "smoke_scoring"
    folder.mkdir(parents=True, exist_ok=True)
    pred, gt = folder / "object_discovery_with_scores.json", folder / "instances.json"
    pred.write_text(json.dumps(anns, cls=NpEncoder))
    gt.write_text(json.dumps({"images": [{"id": g + 1, "file_name": f"{g}.png", "height": int(im.shape[0]),
                                          "width": int(im.shape[1])} for g, im in enumerate(images)]}))
    out = subprocess.run(
        [sys.executable, "post_process.py", "--pred_annotations_path", str(pred), "--gt_annotation_path", str(gt),
         "--existence_score_thres", "-1", "--center_score_thres", "-1", "--boundary_score_thres", "-2"],
        capture_output=True, text=True, timeout=120,
    )
    if out.returncode != 0:
        return f"post_process.py exited {out.returncode}: {out.stderr[-500:]}"
    kept = json.loads((folder / "selected_training_annotations.json").read_text())["annotations"]
    return None if len(kept) == len(anns) else f"post_process.py kept {len(kept)} of {len(anns)}"


def phase_scoring(device, main_path):
    import numpy as np
    import torch

    from unmore_tpu_torch.reasoning import scoring
    from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig

    images, boxes = scoring_inputs(main_path["results"])
    ids = list(range(1, len(images) + 1))
    cfg = ScoringConfig()
    engine = ObjectScoringEngine(*main_path["fns"], cfg, device=device)

    # first call: warms the chunk-128 shapes up and records every call of the
    # host library, which is checked against its plain version afterwards
    calls = []
    real_stats, real_rle = scoring.paste_stats, scoring.paste_rle

    def stats(masks, bx, h, w):
        out = real_stats(masks, bx, h, w)
        calls.append(("stats", (masks.copy(), bx.copy(), h, w), out))
        return out

    def rle(mask, box, h, w):
        out = real_rle(mask, box, h, w)
        calls.append(("rle", (mask.copy(), np.array(box), h, w), out))
        return out

    scoring.paste_stats, scoring.paste_rle = stats, rle
    try:
        t0 = time.perf_counter()
        first = engine.score_batch(images, boxes, ids)
        first_wall = time.perf_counter() - t0
    finally:
        scoring.paste_stats, scoring.paste_rle = real_stats, real_rle

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batched = engine.score_batch(images, boxes, ids)
    wall = time.perf_counter() - t0
    timings = dict(engine.last_timings)
    peak = torch.cuda.max_memory_allocated()
    single = [engine.score_image(im, bx, i) for im, bx, i in zip(images, boxes, ids)]

    problems = []
    n_paste_bad = check_pastes(calls)
    if n_paste_bad:
        problems.append(f"{n_paste_bad} of {len(calls)} host-library pastes differ from the plain version")
    max_rel, mismatch = compare_annotations(batched, single)
    problems += mismatch
    anns = [a for per_image in batched for a in per_image]
    for a in anns:
        if not all(np.isfinite(a[k]) for k in ("score", "existence_score", "center_score", "boundary_score")):
            problems.append("non-finite score")
            break
    pp = run_post_process(anns, images)
    if pp:
        problems.append(pp)

    n_crops = -(-sum(len(b) for b in boxes) // cfg.slot_multiple) * cfg.slot_multiple
    gflop = main_path["gflop_per_crop"]
    flops = n_crops * (gflop["both_heads"] + gflop["classifier"]) * 1e9
    emit({
        "phase": "scoring", "config": dataclasses.asdict(cfg),
        "images": [list(im.shape[:2]) for im in images], "boxes_per_image": [len(b) for b in boxes],
        "lattice_slots": n_crops, "annotations_per_image": [len(a) for a in batched],
        "device_s": timings["device_s"], "host_s": timings["host_s"], "wall_s": wall, "first_call_wall_s": first_wall,
        "crops_per_s": n_crops / wall, "crops_per_device_s": n_crops / timings["device_s"],
        "gflop_per_crop": gflop, "model_tflop": flops / 1e12,
        "mfu_vs_989_tflops_bf16_device_s": flops / timings["device_s"] / H100_BF16_FLOPS,
        "max_memory_allocated_bytes": peak, "pastes_checked": len(calls),
        "max_rel_score_diff_batched_vs_single": max_rel, "repeat_call_equal": first == batched,
        "checks_failed": problems,
    })
    if problems:
        fail(f"scoring phase: {problems[:5]}")


# ------------------------------------------------------------------ phase 5
def random_crops(image, n, seed, device):
    """``n`` 128^2 crops of seeded random boxes (40-160 px) of a uint8 image."""
    import torch

    from unmore_tpu_torch.ops.image import crop_and_resize

    canvas = torch.from_numpy(image).to(device).float()[None] / 255.0
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=g) * 160
    wh = torch.rand(n, 2, generator=g) * 120 + 40
    boxes = torch.cat([xy, xy + wh], dim=1).to(device)
    return crop_and_resize(canvas, boxes, out_size=128, image_idx=torch.zeros(n, dtype=torch.long, device=device))


def phase_bf16(device, objectness_bf16, images):
    import torch

    from unmore_tpu_torch.cli.common import build_objectness, init_random_variables

    # the same seeded weights in f32 (the bf16 model holds them rounded)
    ref = build_objectness(DptLarge, "float32", device)
    init_random_variables(ref, seed=0)
    crops = random_crops(images[0], 8, 1, device)
    with torch.inference_mode():
        want = ref(crops)
        got = objectness_bf16(crops)
    sdf_err = float((got["sdf_maps"] - want["sdf_maps"]).abs().max())
    center_err = float((got["center_fields"] - want["center_fields"]).abs().max())
    agree = float(((got["sdf_maps"] > 0) == (want["sdf_maps"] > 0)).float().mean())
    if not all(torch.isfinite(t).all() for t in (*got.values(), *want.values())):
        fail("non-finite objectness output")
    row = {"phase": "bf16", "crops": 8, "sdf_max_abs_diff": sdf_err, "center_max_abs_diff": center_err,
           "sdf_sign_agreement": agree}
    emit(row)
    return row


# ------------------------------------------------------------------ phase 6
# the stage-1 recipe of script.sh: batch 20 at 128^2, Adam 1e-4 with
# milestones 10000/20000 and gamma 0.1, SDF L1, center L2, gradient and mask
# losses, bf16 autocast over f32 weights, spike guard 1000 from step 500
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, TRAIN_TIMED_FROM = 20, 128, 30, 10  # steps 11-30 are timed
TRAIN_WORLD = dict(n=48, sizes=((375, 500), (500, 375), (333, 500)))  # ImageNet-like sizes
TRAIN_FIXED_STEPS = 8  # steps of a fresh trainer on one fixed batch, whose loss must fall
TRAIN_WORKERS = 4


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset=False):
    """``max_memory_allocated`` of a card (None on the CPU); ``reset`` starts a new peak."""
    import torch

    if device.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device)


def shape_world(seed, n, sizes):
    """A seeded synthetic VoteCut world, as ``scripts/make_synthetic_shapes.py``
    draws it, in numpy: one rotated rectangle, ellipse or triangle of a solid
    noisy colour on a low-frequency textured background per image. Returns
    (float32 images in [0, 1], uint8 masks)."""
    import numpy as np

    from unmore_tpu_torch.ops.labels import resize_linear

    rng = np.random.default_rng(seed)
    images, masks = [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = np.ones((h, w, 3), np.float32) * rng.uniform(0.1, 0.6, 3).astype(np.float32)
        img += 0.06 * resize_linear(rng.normal(0, 1, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32), (h, w))
        img += np.linspace(-0.05, 0.05, h, dtype=np.float32)[:, None, None]
        img += np.linspace(-0.05, 0.05, w, dtype=np.float32)[None, :, None]
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        s = rng.uniform(0.2, 0.6) * min(h, w)
        cx, cy = rng.uniform(s * 0.6, w - s * 0.6), rng.uniform(s * 0.6, h - s * 0.6)
        kind, angle = i % 3, rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)
        v = -(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)
        if kind == 0:
            sel = (np.abs(u) < s / 2) & (np.abs(v) < s * rng.uniform(0.25, 0.5))
        elif kind == 1:
            sel = (u / (s / 2)) ** 2 + (v / (s * rng.uniform(0.25, 0.5))) ** 2 <= 1
        else:
            p = np.stack([cx, cy]) + rng.uniform(-s, s, (3, 2))
            d = [(xx - p[j, 0]) * (p[(j + 1) % 3, 1] - p[j, 1]) - (yy - p[j, 1]) * (p[(j + 1) % 3, 0] - p[j, 0])
                 for j in range(3)]
            sel = ((d[0] >= 0) & (d[1] >= 0) & (d[2] >= 0)) | ((d[0] <= 0) & (d[1] <= 0) & (d[2] <= 0))
        sel[:1], sel[-1:], sel[:, :1], sel[:, -1:] = False, False, False, False
        colour = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        img[sel] = colour + 0.05 * rng.normal(0, 1, (int(sel.sum()), 3)).astype(np.float32)
        images.append(np.clip(img, 0.0, 1.0))
        masks.append(sel.astype(np.uint8))
    return images, masks


def objectness_worker(images, masks, seed):
    """One prefetch worker: synthesize_labels -> batch_iterator (wire format)."""
    import numpy as np

    from unmore_tpu_torch.data.votecut import batch_iterator, synthesize_labels

    rng = np.random.default_rng(seed)
    it = batch_iterator(lambda i: synthesize_labels(images[i], masks[i], TRAIN_SIZE, True, rng),
                        len(images), TRAIN_BATCH, rng)
    return lambda: next(it)


def classifier_worker(images, masks, seed):
    """One prefetch worker: classifier_sample batches in the wire format."""
    import numpy as np

    from unmore_tpu_torch.data.existence import classifier_sample

    rng = np.random.default_rng(seed)

    def batch():
        samples = [classifier_sample(images[j], masks[j], masks[j], TRAIN_SIZE, rng)
                   for j in rng.integers(0, len(images), TRAIN_BATCH)]
        return {"image": np.clip(np.stack([s[0] for s in samples]) * 255.0 + 0.5, 0, 255).astype(np.uint8),
                "label": np.array([s[1] for s in samples], np.float32)}

    return batch


def step_flops(trainer, batch, key):
    """Matmul and convolution FLOPs of one forward and backward (FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        trainer.loss(batch)[key].backward()
    trainer.flat.grad.zero_()
    return counter.get_total_flops()


def timed_steps(trainer, prefetch, device, key):
    """TRAIN_STEPS synchronised steps from the prefetcher: per-step seconds
    (upload, step, synchronise) and the loss trace."""
    from unmore_tpu_torch.train.objectness import to_device

    seconds, losses, skipped = [], [], 0.0
    for _ in range(TRAIN_STEPS):
        host = next(prefetch)
        t0 = time.perf_counter()
        out = trainer.train_step(to_device(host, device))
        sync(device)
        seconds.append(time.perf_counter() - t0)
        losses.append(float(out[key]))
        skipped += float(out.get("skipped", 0.0))
    return seconds, losses, skipped


def train_summary(name, trainer, prefetch, device, key):
    """Run the timed steps and return the phase's numbers for one trainer."""
    import statistics

    from unmore_tpu_torch.train.objectness import to_device

    flops = step_flops(trainer, to_device(next(prefetch), device), key)
    peak_bytes(device, reset=True)
    seconds, losses, skipped = timed_steps(trainer, prefetch, device, key)
    step_s = statistics.median(seconds[TRAIN_TIMED_FROM:])
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail(f"{name}: non-finite training loss {losses}")
    return {
        "step_ms_median_11_30": step_s * 1e3, "step_ms": [s * 1e3 for s in seconds], "img_per_s": TRAIN_BATCH / step_s,
        "tflop_per_step": flops / 1e12, "achieved_tflop_per_s": flops / step_s / 1e12,
        "mfu_vs_989_tflops_bf16": flops / step_s / H100_BF16_FLOPS,
        "max_memory_allocated_bytes": peak_bytes(device),
        "loss_trace": losses, "skipped_in_timed_steps": skipped, "starved_fraction": prefetch.starved_fraction,
    }


def falls_on_fixed_batch(device, batch_host, cfg):
    """TRAIN_FIXED_STEPS steps of a fresh DPT-Large trainer on one batch at
    1/10 of the recipe's rate: the mean loss of the last three must be below
    that of the first three. (At the recipe's 1e-4, Adam's first steps move
    every weight by 1e-4 at once: the loss jumps by orders of magnitude and
    then oscillates for dozens of steps, as the JAX package notes for its
    spike guard, so a few steps say nothing about the gradients.)"""
    from unmore_tpu_torch.cli.common import build_objectness
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, to_device
    from unmore_tpu_torch.train.optim import init_like_flax

    model = build_objectness(DptLarge, "float32", device)
    init_like_flax(model, seed=1)
    slow = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, learning_rate=cfg.optim.learning_rate / 10))
    trainer = ObjectnessTrainer(model, slow)
    batch = to_device(batch_host, device)
    losses = [float(trainer.train_step(batch)["total"]) for _ in range(TRAIN_FIXED_STEPS)]
    if not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"the loss does not fall on a fixed batch: {losses}")
    return {"learning_rate": slow.optim.learning_rate, "losses": losses}


def guard_check(trainer, batch):
    """A non-finite batch must be skipped: parameters, moments and counts
    equal before and after, the step count one higher."""
    import torch

    before = {"params": trainer.flat.data.clone(), **{k: v.clone() for k, v in trainer.opt.state_tensors().items()}}
    step = int(trainer.step)
    bad = dict(batch, sdf=torch.full_like(batch["sdf"], float("nan")))
    out = trainer.train_step(bad)
    after = {"params": trainer.flat.data, **trainer.opt.state_tensors()}
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    ok = float(out["skipped"]) == 1.0 and not changed and int(trainer.step) == step + 1
    if not ok:
        fail(f"spike guard: skipped={float(out['skipped'])}, changed {changed}, step {step} -> {int(trainer.step)}")
    return {"skipped": float(out["skipped"]), "loss": repr(float(out["total"])), "state_unchanged": True,
            "counts": {k: int(v) for k, v in before.items() if v.ndim == 0}, "step": [step, int(trainer.step)]}


def tiny_objectness():
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.vit import ViTConfig

    return ObjectnessNet("dpt_base", "tanh", True, features=64, hooks=(0, 1, 2, 3), widths=(32, 64, 128, 128),
                         vit_config=ViTConfig(depth=4, dim=128, heads=4, mlp_dim=256, pretrain_grid=8))


def f32_card_vs_cpu(device, batch_host):
    """One f32 step of a narrow ObjectnessNet (TF32 off) on the card and on
    the CPU from equal weights and an equal batch: the largest differences."""
    import torch

    from unmore_tpu_torch.config import ModelConfig, TrainObjectnessConfig
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, to_device
    from unmore_tpu_torch.train.optim import init_like_flax

    cfg = TrainObjectnessConfig(model=ModelConfig(dtype="float32"))
    cpu_model = tiny_objectness()
    init_like_flax(cpu_model, 5)
    card_model = tiny_objectness()
    card_model.load_state_dict(cpu_model.state_dict())
    host = {k: v[:2] for k, v in batch_host.items()}
    outs = []
    for model, dev in ((cpu_model, torch.device("cpu")), (card_model.to(device), device)):
        trainer = ObjectnessTrainer(model, cfg)
        losses = trainer.train_step(to_device(host, dev))
        outs.append(({k: float(v) for k, v in losses.items()}, trainer.flat.data.cpu()))
    (l_cpu, p_cpu), (l_card, p_card) = outs
    return {"crops": 2, "losses_cpu": l_cpu, "losses_card": l_card,
            "max_abs_loss_diff": max(abs(l_cpu[k] - l_card[k]) for k in l_cpu),
            "max_abs_param_diff_after_step": float((p_cpu - p_card).abs().max())}


def same_tree(got, want, path="ckpt"):
    """Mismatching leaves of two checkpoint trees (dtype, shape, bits)."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path]
        return [bad for k in want for bad in same_tree(got[k], want[k], f"{path}/{k}")]
    g, w = np.asarray(got), np.asarray(want)
    return [] if g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w) else [path]


def checkpoint_round_trip(name, trainer, folder):
    """One checkpoint through the async writer, read back leaf for leaf."""
    from unmore_tpu_torch.train.checkpoints import AsyncCheckpointer, load_msgpack_checkpoint

    path = str(folder / f"{name}.ckpt")
    writer = AsyncCheckpointer()
    t0 = time.perf_counter()
    writer.save(path, trainer.checkpoint_tensors(), trainer.checkpoint_tree)
    save_call_s = time.perf_counter() - t0
    info = writer.wait()
    want = trainer.checkpoint_tree({k: v.cpu().numpy() for k, v in trainer.checkpoint_tensors().items()})
    t0 = time.perf_counter()
    got = load_msgpack_checkpoint(path)
    read_s = time.perf_counter() - t0
    bad = same_tree(got, want)
    if bad:
        fail(f"{name} checkpoint read back differs at {bad[:5]}")
    return path, {"bytes": info["bytes"], "save_call_s": save_call_s, "write_s": info["seconds"], "read_s": read_s,
                  "leaves_equal": True}


def stage2_on_trained(device, obj_path, cls_path, trainers):
    """The trained weights through cli/common.py's loaders into the stage-2
    engine (bf16), equal to the trainers' weights rounded to bf16, then one
    discovery image group as in phase 3."""
    import numpy as np
    import torch

    from unmore_tpu_torch.cli.common import (
        build_classifier, build_objectness, load_classifier_weights, load_objectness_weights, make_apply_fns,
    )
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig

    objectness = build_objectness(DptLarge, "bfloat16", device)
    load_objectness_weights(objectness, obj_path)
    classifier = build_classifier("bfloat16", device)
    load_classifier_weights(classifier, cls_path)
    for model, trainer in zip((objectness, classifier), trainers):
        loaded, trained = model.state_dict(), trainer.model.state_dict()
        keys = [*trainer.layout, *getattr(trainer, "stats_layout", ())]
        bad = [k for k in keys if not torch.equal(loaded[k], trained[k].to(loaded[k].dtype))]
        if bad:
            fail(f"stage-2 loader gave other weights than the trainer's at {bad[:5]}")
    images = synthetic_images(seed=0)
    cuts = dict(MAIN_PATH_CUTS, **calibrate(objectness, images[0], ReasoningConfig(), device))
    t0 = time.perf_counter()
    results = ObjectDiscoveryEngine(*make_apply_fns(objectness, classifier), ReasoningConfig(**cuts),
                                    device=device).discover_batch(images)
    sync(device)
    wall = time.perf_counter() - t0
    for r in results:
        b = r["boxes"]
        if b.ndim != 2 or b.shape[1] != 4 or not np.isfinite(b).all():
            fail(f"stage 2 on the trained weights returned malformed boxes {b.shape}")
    return {"wall_s": wall, "cuts": cuts, "n_boxes": [len(r["boxes"]) for r in results],
            "stats": [r["stats"] for r in results]}


def phase_train(device):
    import torch

    from unmore_tpu_torch.cli.common import build_classifier, build_objectness
    from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.train.classifier import ClassifierTrainer
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, to_device
    from unmore_tpu_torch.train.optim import init_like_flax

    t0 = time.perf_counter()
    images, masks = shape_world(seed=0, **TRAIN_WORLD)
    world_s = time.perf_counter() - t0
    folder = Path("build") / "smoke_train"
    folder.mkdir(parents=True, exist_ok=True)
    cfg = TrainObjectnessConfig(model=ModelConfig(dtype="bfloat16"), optim=OptimConfig(), batch_size=TRAIN_BATCH)

    # objectness: DPT-Large, tanh bg-SDF, f32 master weights, bf16 autocast
    model = build_objectness(DptLarge, "float32", device).train()
    init_like_flax(model, seed=0)
    obj = ObjectnessTrainer(model, cfg)
    prefetch = PrefetchIterator(worker_fns=[objectness_worker(images, masks, 100 + w) for w in range(TRAIN_WORKERS)])
    try:
        obj_row = train_summary("objectness", obj, prefetch, device, "total")
        fixed = to_device(next(prefetch), device)
    finally:
        prefetch.close()
    obj_row["guard"] = guard_check(obj, fixed)
    obj_path, obj_row["checkpoint"] = checkpoint_round_trip("objectness", obj, folder)
    obj_row["params"] = obj.flat.data.numel()

    # existence classifier: ResNet-50, BN in train mode, Adam on the schedule
    model = build_classifier("float32", device)
    init_like_flax(model, seed=0)
    cls = ClassifierTrainer(model, OptimConfig(), "bfloat16")
    prefetch = PrefetchIterator(worker_fns=[classifier_worker(images, masks, 200 + w) for w in range(TRAIN_WORKERS)])
    try:
        cls_row = train_summary("classifier", cls, prefetch, device, "loss")
        hits = total = 0.0
        for _ in range(4):
            h, t, _ = cls.eval_step(to_device(next(prefetch), device))
            hits, total = hits + float(h), total + float(t)
        batch_host = objectness_worker(images, masks, 300)()
    finally:
        prefetch.close()
    cls_row["eval_accuracy_at_0_5"] = {"hits": hits, "total": total, "accuracy": hits / total}
    cls_path, cls_row["checkpoint"] = checkpoint_round_trip("classifier", cls, folder)
    cls_row["params"] = cls.flat.data.numel()

    stage2 = stage2_on_trained(device, obj_path, cls_path, (obj, cls))
    del obj, cls
    obj_row["fixed_batch"] = falls_on_fixed_batch(device, batch_host, cfg)
    f32 = f32_card_vs_cpu(device, batch_host)
    emit({"phase": "train", "world": {"images": TRAIN_WORLD["n"], "sizes": TRAIN_WORLD["sizes"], "make_s": world_s},
          "recipe": {"batch": TRAIN_BATCH, "size": TRAIN_SIZE, "dtype": "bfloat16 autocast, f32 master weights",
                     "optim": dataclasses.asdict(cfg.optim), "skip_loss_above": cfg.skip_loss_above,
                     "spike_guard_warmup": cfg.spike_guard_warmup},
          "objectness": dict(obj_row, model="dpt_large (vitl16_384, features 256, tanh bg-sdf)"),
          "classifier": dict(cls_row, model="resnet50 existence classifier"),
          "f32_card_vs_cpu": f32, "stage2_on_trained_weights": stage2})
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 7
# the CAD at cad/configs/cascade_mask_rcnn_R_50_FPN.yaml, as build_from_config
# reads it: R50-FPN (3,4,6,3), RPN top-k 1000/1000 at NMS 0.65, 3 cascade
# stages, masks, 100 detections at score threshold 0 and NMS 0.5, canvas
# 1024, min_size 800, eval batch 4, bf16
CAD_CONFIG = "cad/configs/cascade_mask_rcnn_R_50_FPN.yaml"
CAD_SCENES = ((480, 640), (640, 427), (375, 500), (800, 800))
CAD_TIMED_CALLS = 5


def synced_stages(device, times, rounds):
    """A ``stage(name)`` context manager for the detector that synchronises
    at both ends and adds each part's seconds to ``times`` and the NMS rounds
    run inside it to ``rounds``."""
    import contextlib

    from unmore_tpu_torch.utils import tracing

    @contextlib.contextmanager
    def stage(name):
        sync(device)
        t0, r0 = time.perf_counter(), tracing.counter("ops.nms.rounds")
        yield
        sync(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        rounds[name] = rounds.get(name, 0) + tracing.counter("ops.nms.rounds") - r0

    return stage


def match_detections(got, want):
    """Pair each annotation of ``got`` with the unused one of ``want`` on
    the same image with the nearest box: (largest box difference, largest
    score difference, share of mask pixels that differ, unmatched count)."""
    import numpy as np

    from unmore_tpu_torch.utils import rle

    used, box_d, score_d, px, area, unmatched = set(), 0.0, 0.0, 0, 0, 0
    for g in got:
        cands = [j for j, w in enumerate(want) if w["image_id"] == g["image_id"] and j not in used]
        if not cands:
            unmatched += 1
            continue
        j = min(cands, key=lambda j: float(np.abs(np.subtract(want[j]["bbox"], g["bbox"])).sum()))
        used.add(j)
        box_d = max(box_d, float(np.abs(np.subtract(want[j]["bbox"], g["bbox"])).max()))
        score_d = max(score_d, abs(want[j]["score"] - g["score"]))
        if "segmentation" in g:
            a, b = rle.decode(g["segmentation"]), rle.decode(want[j]["segmentation"])
            px += int((a != b).sum())
            area += int(a.sum() + b.sum())
    return box_d, score_d, px / max(area, 1), unmatched + len(want) - len(used)


def cad_model(cfg, device, seed=0):
    """The detector of ``cfg`` with seeded random weights (the JAX package's
    initializers), in eval mode on ``device`` in ``cfg.dtype``."""
    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN
    from unmore_tpu_torch.train.optim import init_like_flax

    model = CascadeMaskRCNN(cfg)
    init_like_flax(model, seed)
    return model.to(device, cfg.dtype).eval()


def cad_card_vs_cpu(device):
    """An f32 narrow detector (trunk blocks (1,1,1,1), canvas 256, RPN top-k
    128, 16 detections) on the card (TF32 off) and on the CPU from equal
    weights and inputs. On given boxes (no ranking): the largest differences
    of boxes, scores and masks. End to end: each card detection paired with
    the CPU one of its image with the nearest box (random weights give
    near-equal scores, whose order two devices may swap), the largest
    differences and the detections left unpaired."""
    import numpy as np
    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import (
        DetectorConfig, detector_forward_inference, detector_forward_with_boxes,
    )

    cfg = DetectorConfig(image_size=256, stage_blocks=(1, 1, 1, 1), rpn_pre_nms_topk_test=128,
                         rpn_post_nms_topk_test=128, detections_per_image=16, dtype=torch.float32)
    cpu_model = cad_model(cfg, torch.device("cpu"), seed=3)
    card_model = cad_model(cfg, torch.device("cpu"), seed=3).to(device)
    rng = np.random.RandomState(4)
    images = torch.from_numpy((rng.rand(2, 256, 256, 3) * 255).astype(np.uint8))
    hw = torch.tensor([[256.0, 256.0], [192.0, 240.0]])
    xy = torch.from_numpy(rng.rand(2, 24, 2).astype(np.float32) * 180)
    boxes = torch.cat([xy, xy + torch.from_numpy(rng.rand(2, 24, 2).astype(np.float32) * 120 + 8)], -1)
    valid = torch.ones(2, 24, dtype=torch.bool)
    on_boxes = [detector_forward_with_boxes(m, cfg, images.to(d), hw.to(d), boxes.to(d), valid.to(d))
                for m, d in ((cpu_model, torch.device("cpu")), (card_model, device))]
    want, got = on_boxes[0], {k: v.cpu() for k, v in on_boxes[1].items()}
    out = {"given_boxes": {f"max_abs_{k}_diff": float((want[k] - got[k]).abs().max())
                           for k in ("boxes", "scores", "masks")}}
    ends = [detector_forward_inference(m, cfg, images.to(d), hw.to(d))
            for m, d in ((cpu_model, torch.device("cpu")), (card_model, device))]
    want, got = ends[0], {k: v.cpu() for k, v in ends[1].items()}
    box_d = score_d = mask_d = 0.0
    unpaired = 0
    for b in range(2):
        w_idx = [int(i) for i in torch.nonzero(want["valid"][b])]
        for i in map(int, torch.nonzero(got["valid"][b])):
            if not w_idx:
                unpaired += 1
                continue
            j = min(w_idx, key=lambda j: float((want["boxes"][b, j] - got["boxes"][b, i]).abs().max()))
            w_idx.remove(j)
            box_d = max(box_d, float((want["boxes"][b, j] - got["boxes"][b, i]).abs().max()))
            score_d = max(score_d, abs(float(want["scores"][b, j] - got["scores"][b, i])))
            mask_d = max(mask_d, float((want["masks"][b, j] - got["masks"][b, i]).abs().max()))
        unpaired += len(w_idx)
    out["end_to_end"] = {"n_valid": [int(want["valid"].sum()), int(got["valid"].sum())], "unpaired": unpaired,
                         "max_abs_box_diff": box_d, "max_abs_score_diff": score_d, "max_abs_mask_diff": mask_d}
    return out


def cad_roi_align_ms(model, cfg, images, device):
    """Event-timed ms of the RoIAlign gathers alone on the batch's own boxes:
    one cascade stage's 7x7 pooling of the proposals, and the 14x14 pooling
    of the final detections (the share a hand kernel could win)."""
    import numpy as np
    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import (
        backbone_features, detector_forward_inference, level_anchors,
    )
    from unmore_tpu_torch.detector.evaluation import prepare_eval_image
    from unmore_tpu_torch.detector.fpn import LEVELS
    from unmore_tpu_torch.detector.rpn import generate_proposals

    prepared = [prepare_eval_image(im, cfg.image_size) for im in images]
    canvases = torch.from_numpy(np.stack([p[0] for p in prepared])).to(device)
    hw = torch.tensor([p[2] for p in prepared], dtype=torch.float32, device=device)
    with torch.inference_mode():
        feats, roi = backbone_features(model, canvases)
        rpn_out = model.rpn(feats)
        proposals = generate_proposals(level_anchors(cfg.image_size, device),
                                       [rpn_out[n]["objectness"] for n in LEVELS],
                                       [rpn_out[n]["deltas"] for n in LEVELS], hw, cfg.rpn_pre_nms_topk_test,
                                       cfg.rpn_post_nms_topk_test, cfg.rpn_nms_thresh)[0]
        dets = detector_forward_inference(model, cfg, canvases, hw)["boxes"]
        return {"box_7x7_per_stage": time_ms(lambda: roi.pool(proposals, 7, cfg.pooler_sampling)),
                "mask_14x14": time_ms(lambda: roi.pool(dets, 14, cfg.pooler_sampling)),
                "boxes": [list(proposals.shape[:2]), list(dets.shape[:2])]}


def cad_flops_per_image(model, cfg, device):
    """Matmul and convolution FLOPs of one batch-4 inference over 4, by
    FlopCounterMode (RoIAlign's gathers and the NMS count nothing)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from unmore_tpu_torch.detector.cascade_rcnn import detector_forward_inference

    images = torch.zeros(4, cfg.image_size, cfg.image_size, 3, dtype=torch.uint8, device=device)
    hw = torch.full((4, 2), float(cfg.image_size), device=device)
    counter = FlopCounterMode(display=False)
    with counter:
        detector_forward_inference(model, cfg, images, hw)
    return counter.get_total_flops() / 4


def phase_cad(device, smi):
    import statistics

    import numpy as np
    import torch

    import unmore_tpu_torch.evaluation.coco_eval as coco_eval_module
    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.detector.evaluation import DetectorEvaluator
    from unmore_tpu_torch.ops import cocoeval
    from unmore_tpu_torch.ops.labels import resize_linear_u8, resize_linear_u8_plain

    t0 = time.perf_counter()
    from unmore_tpu_torch.scripts.make_synthetic_shapes import scene_world

    images, gt = scene_world(0, CAD_SCENES)
    world_s = time.perf_counter() - t0
    ids = [im["id"] for im in gt["images"]]
    args = train_net.parse_args(["--config-file", CAD_CONFIG, "--eval-only"])
    cfg = train_net.build_from_config(args)[0]
    model = cad_model(cfg, device)
    evaluator = DetectorEvaluator(model, cfg, device=device)

    first = evaluator.predict_batch(images, ids)  # warm-up: cuDNN, allocator, host library
    walls, parts, rounds = [], [], []
    sync(device)
    peak_bytes(device, reset=True)
    for _ in range(CAD_TIMED_CALLS):
        times, nms_rounds = {}, {}
        t0 = time.perf_counter()
        preds = evaluator.predict_batch(images, ids, stage=synced_stages(device, times, nms_rounds))
        walls.append(time.perf_counter() - t0)
        parts.append(times)
        rounds.append(nms_rounds)
    peak = peak_bytes(device)
    wall = statistics.median(walls)
    median_parts = {k: statistics.median(p[k] for p in parts) for k in parts[0]}

    # the evaluator, with every call of the host library recorded
    calls = []
    real_iou, real_match = cocoeval.mask_iou, cocoeval.coco_match

    def mask_iou(a, b, iscrowd=None):
        out = real_iou(a, b, iscrowd)
        calls.append(("iou", (a, b, iscrowd), out))
        return out

    def coco_match(*a):
        out = real_match(*a)
        calls.append(("match", tuple(np.copy(x) for x in a), out))
        return out

    cocoeval.mask_iou, cocoeval.coco_match = mask_iou, coco_match
    try:
        t0 = time.perf_counter()
        metrics = coco_eval_module.evaluate_ap(gt, preds, iou_types=("bbox", "segm"))
        eval_s = time.perf_counter() - t0
    finally:
        cocoeval.mask_iou, cocoeval.coco_match = real_iou, real_match

    problems = []
    bad = 0
    for kind, a, got in calls:
        want = cocoeval.mask_iou_plain(*a) if kind == "iou" else cocoeval.coco_match_plain(*a)
        same = np.array_equal(got, want) if kind == "iou" else all(map(np.array_equal, got, want))
        bad += int(not same)
    if bad or not calls:
        problems.append(f"{bad} of {len(calls)} host-library evaluator calls differ from the plain version")
    for img in images:
        scale = min(800 / min(img.shape[:2]), cfg.image_size / max(img.shape[:2]))
        hw = (int(round(img.shape[0] * scale)), int(round(img.shape[1] * scale)))
        if not np.array_equal(resize_linear_u8(img, hw), resize_linear_u8_plain(img, hw)):
            problems.append(f"uint8 resize of {img.shape[:2]} -> {hw} differs from the plain version")
    if first != preds:
        problems.append("two bf16 calls on the same batch gave different predictions")
    n_per_image = [sum(a["image_id"] == i for a in preds) for i in ids]
    if not all(n == cfg.detections_per_image for n in n_per_image):
        problems.append(f"detections per image {n_per_image}, expected {cfg.detections_per_image} each")
    if not all(np.isfinite(a["score"]) and np.isfinite(a["bbox"]).all() for a in preds):
        problems.append("non-finite detections")
    if not all(np.isfinite(v) for m in metrics.values() for k, v in m.items() if k in ("AP", "AR100")):
        problems.append(f"non-finite metrics {metrics}")

    # batched equal to per-image calls, in f32 (TF32 off), where bf16
    # rounding does not mask a fault of the per-image bookkeeping
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ev32 = DetectorEvaluator(cad_model(cfg32, device), cfg32, device=device)
    batched = ev32.predict_batch(images, ids)
    single = [a for img, i in zip(images, ids) for a in ev32.predict_image(img, i)]
    box_d, score_d, px_share, unmatched = match_detections(batched, single)
    batched_vs_single = {"max_abs_box_diff_px": box_d, "max_abs_score_diff": score_d,
                         "mask_pixels_differing_share": px_share, "unmatched": unmatched}
    if unmatched or box_d > 0.05 or score_d > 1e-4 or px_share > 1e-3:
        problems.append(f"batched and per-image f32 calls differ: {batched_vs_single}")
    del ev32
    card_vs_cpu = cad_card_vs_cpu(device)
    given, end = card_vs_cpu["given_boxes"], card_vs_cpu["end_to_end"]
    # boxes within 1e-2 px, scores within 1e-4, masks within 1e-3; end to end
    # at most one detection an image may fall on the other side of the top 16
    if not (given["max_abs_boxes_diff"] <= 1e-2 and given["max_abs_scores_diff"] <= 1e-4
            and given["max_abs_masks_diff"] <= 1e-3 and end["unpaired"] <= 2 and end["max_abs_box_diff"] <= 1e-2
            and end["max_abs_score_diff"] <= 1e-4 and end["max_abs_mask_diff"] <= 1e-3):
        problems.append(f"f32 card and CPU detectors differ: {card_vs_cpu}")

    norms = norm_leaves(model)
    if norms["not_float32"] or not norms["count"]:
        problems.append(f"bf16 detector with norm leaves not in float32: {norms}")
    roi_align_ms = cad_roi_align_ms(model, cfg, images, device) if device.type == "cuda" else None
    flops = cad_flops_per_image(model, cfg, device)
    device_s = sum(median_parts[k] for k in ("backbone", "rpn", "cascade", "mask"))
    emit({
        "phase": "cad", "nvidia_smi": smi, "config": CAD_CONFIG,
        "model": "cascade mask r-cnn r50-fpn, seeded random weights, bf16",
        "detector_config": {k: str(v) if k == "dtype" else v for k, v in dataclasses.asdict(cfg).items()},
        "images": [list(im.shape[:2]) for im in images], "gt_instances": len(gt["annotations"]),
        "world_make_s": world_s, "batch": len(images), "timed_calls": CAD_TIMED_CALLS,
        "wall_s": walls, "wall_s_median": wall, "wall_s_median_pr6_7": [0.1031, 0.1482],
        "img_per_s": len(images) / wall, "norm_leaves": norms,
        "synchronised_s_median": {"trunk_fpn": median_parts["backbone"], "rpn_proposals": median_parts["rpn"],
                                  "cascade": median_parts["cascade"], "mask_head": median_parts["mask"],
                                  "host_paste_rle": median_parts["paste"]},
        "nms_rounds_per_call": {"rpn": rounds[0].get("rpn", 0), "cascade": rounds[0].get("cascade", 0)},
        "evaluation_s": eval_s, "roi_align_ms_per_call": roi_align_ms, "gflop_per_image": flops / 1e9,
        "mfu_vs_989_tflops_bf16_device_s": flops * len(images) / device_s / H100_BF16_FLOPS,
        "mfu_vs_989_tflops_bf16_wall": flops * len(images) / wall / H100_BF16_FLOPS,
        "max_memory_allocated_bytes": peak, "detections_per_image": n_per_image, "metrics": metrics,
        "host_library_calls_checked": len(calls), "batched_vs_single_f32": batched_vs_single,
        "f32_card_vs_cpu": card_vs_cpu, "kernels_on_path": [], "checks_failed": problems,
    })
    if problems:
        fail(f"cad phase: {problems[:5]}")
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8
# CAD training at cad/configs/cascade_mask_rcnn_R_50_FPN.yaml as
# build_from_config reads it (R50-FPN with remat, RPN top-k 2000/4000, 256
# anchors and 512 RoIs an image, 3 cascade stages, masks, max_gt 128,
# canvas 1024, MIN_SIZE_TRAIN 240-1024, copy-paste, batch 16, SGD 0.01 with
# warmup 1000 and clip 1.0, bf16 autocast), cut in steps only
CAD_TRAIN_CUTS = ("SOLVER.MAX_ITER", "30", "SOLVER.CHECKPOINT_PERIOD", "15", "TEST.EVAL_PERIOD", "30",
                  "TEST.PRECISE_BN.NUM_ITER", "32")
CAD_TRAIN_TIMED_FROM = 5  # the median step is of steps 6-30
CAD_TRAIN_SIZES = ((480, 640), (640, 427), (375, 500), (800, 800), (427, 640), (500, 375), (612, 612), (333, 500))
CAD_TRAIN_WORLD = 32  # scenes, a quarter of them ImageNet-like single objects
CAD_TRAIN_WORKERS = 4  # the CLI's --train-workers default


def cad_train_world(seed, n=CAD_TRAIN_WORLD):
    """A training JSON in memory (``merge_coco_and_imagenet.py``'s shape:
    ``coco_`` scenes of 2-6 shapes, ``imagenet_`` images of one shape, each
    annotation with a pseudo-label score) and its images by file name."""
    import numpy as np

    from unmore_tpu_torch.scripts.make_synthetic_shapes import scene_world

    n_single = n // 4
    rng = np.random.default_rng(seed)
    images, anns, files = [], [], {}
    for prefix, count, shapes, s0 in (("coco", n - n_single, (2, 7), seed), ("imagenet", n_single, (1, 2), seed + 1)):
        sizes = [CAD_TRAIN_SIZES[i % len(CAD_TRAIN_SIZES)] for i in range(count)]
        pixels, gt = scene_world(s0, sizes, shapes)
        for info, img in zip(gt["images"], pixels):
            name = f"{prefix}/{info['id']}.jpg"
            files[name] = img
            images.append({"id": f"{prefix}_{info['id']}", "file_name": name, "height": info["height"],
                           "width": info["width"]})
        for a in gt["annotations"]:
            anns.append(dict(a, id=len(anns) + 1, image_id=f"{prefix}_{a['image_id']}",
                             score=float(rng.uniform(0.5, 1.0))))
    return {"images": images, "annotations": anns}, files


class MemoryImages:
    """In-memory images with ``COCOImages``'s ``len`` and ``get``."""

    def __init__(self, images, ids):
        self.images, self.ids = images, ids

    def __len__(self):
        return len(self.images)

    def get(self, idx, dtype=None):
        return self.images[idx], self.ids[idx]


def narrow_train_cfg():
    """The f32 checks' detector: trunk blocks (1,1,1,1), canvas 256, RPN
    top-k 128, 32 RoIs an image."""
    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import DetectorConfig

    return DetectorConfig(image_size=256, max_gt=16, gt_mask_res=32, stage_blocks=(1, 1, 1, 1),
                          rpn_pre_nms_topk_train=128, rpn_post_nms_topk_train=128, rpn_pre_nms_topk_test=128,
                          rpn_post_nms_topk_test=128, stage_samples=32, detections_per_image=16, dtype=torch.float32)


def narrow_batch(train_json, files, cfg, seed=3):
    """One wire-format batch of 2 images at the narrow config's canvas."""
    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.data.detection import DetectionDataset

    solver = {"ims_per_batch": 2, "copy_paste": True, "copy_paste_rate": 1.0, "copy_paste_min_ratio": 0.3,
              "copy_paste_max_ratio": 1.0, "copy_paste_random_num": True}
    worker = train_net.batch_workers(
        lambda s: DetectionDataset(train_json, {"": ""}, cfg.image_size, (160, 200, 256), s, read_image=files.get),
        cfg, solver, 1)[0]
    host = worker()
    host.pop("n_gt_dropped")
    return host


DECISIONS = ("generate_proposals", "droploss_weights", "match_and_label")


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x)


@contextlib.contextmanager
def decisions(record=None, replay=None, device=None):
    """The training forward's discrete decisions (the RPN's proposals, the
    DropLoss weights, the cascade stages' matches): appended to ``record``
    as they are made, or taken from ``replay`` (moved to ``device``) in
    place of being made. With random weights, near-equal scores and boxes
    near an IoU threshold let two devices or precisions decide differently,
    and one other RoI moves a loss by a percent; replaying one run's
    decisions in the other compares their arithmetic alone."""
    import unmore_tpu_torch.detector.cascade_rcnn as cascade

    originals = {name: getattr(cascade, name) for name in DECISIONS}
    used = dict.fromkeys(DECISIONS, 0)

    def wrap(name):
        def decide(*args, **kwargs):
            if replay is not None:
                used[name] += 1
                return _tree(replay[name][used[name] - 1], lambda t: t.to(device))
            out = originals[name](*args, **kwargs)
            if record is not None:
                record.setdefault(name, []).append(_tree(out, lambda t: t.detach().clone()))
            return out
        return decide

    for name in DECISIONS:
        setattr(cascade, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(cascade, name, fn)


def narrow_step_checks(device, train_json, files):
    """On the narrow detector with equal weights, batch and draws: one f32
    step on the card (TF32 off) against the CPU replaying the card's
    decisions (losses, flat gradient, parameters after the step; the
    decisions that the CPU's own run makes otherwise are counted), the bf16
    autocast gradient against the f32 one on the card (same decisions), and
    remat on against off (BatchNorm statistics after one f32 step)."""
    import dataclasses as dc

    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN, uniform_draws
    from unmore_tpu_torch.train.detector import DetectorTrainer
    from unmore_tpu_torch.train.objectness import to_device
    from unmore_tpu_torch.train.optim import init_like_flax
    from unmore_tpu_torch.utils.prng import prng_key

    cfg = narrow_train_cfg()
    host = narrow_batch(train_json, files, cfg)
    draws = uniform_draws(cfg, prng_key(5), 2, "cpu")
    ref = CascadeMaskRCNN(cfg)
    init_like_flax(ref, 3)
    weights = ref.state_dict()

    def step(dev, dtype="float32", remat=True, weights_dtype=torch.float32, **decide):
        model = CascadeMaskRCNN(dc.replace(cfg, remat_backbone=remat))
        model.load_state_dict(weights)
        trainer = DetectorTrainer(model.to(dev, weights_dtype), cfg, {"warmup_iters": 1000}, dtype=dtype)
        initial = trainer.stats.cpu().clone()
        with decisions(device=dev, **decide):
            losses = trainer.train_step(to_device(host, dev), {k: v.to(dev) for k, v in draws.items()})
        return ({k: float(v) for k, v in losses.items()}, trainer.flat.grad.cpu().clone(), trainer.flat.data.cpu(),
                trainer.stats.cpu(), initial)

    on_card, on_cpu = {}, {}
    card = step(device, record=on_card)
    step(torch.device("cpu"), record=on_cpu)  # the CPU's own decisions, to count those that differ
    cpu = step(torch.device("cpu"), replay=on_card)
    cpu64 = step(torch.device("cpu"), replay=on_card, weights_dtype=torch.float64)
    bf16, no_remat = step(device, "bfloat16", replay=on_card), step(device, remat=False)
    g_scale = float(cpu64[1].abs().max())
    (card_boxes, _, card_valid), (cpu_boxes, _, cpu_valid) = on_card["generate_proposals"][0], \
        on_cpu["generate_proposals"][0]
    differ = {
        "proposal_slots": int(((card_boxes.cpu() - cpu_boxes).abs().amax(-1) > 1e-3).sum()
                              + (card_valid.cpu() != cpu_valid).sum()),
        "droploss_weights": sum(int((a.cpu() != b).sum()) for a, b in zip(on_card["droploss_weights"],
                                                                          on_cpu["droploss_weights"])),
        "cascade_fg": sum(int((a["fg"].cpu() != b["fg"]).sum()) for a, b in zip(on_card["match_and_label"],
                                                                                 on_cpu["match_and_label"])),
    }
    return {
        "config": {"image_size": 256, "stage_blocks": [1, 1, 1, 1], "rpn_topk_train": 128, "stage_samples": 32,
                   "batch": 2},
        "decisions_card_vs_cpu_differ": differ,
        "losses_cpu_on_card_decisions": cpu[0], "losses_card": card[0],
        "max_rel_loss_diff": max(abs(cpu[0][k] - card[0][k]) / max(abs(cpu[0][k]), 1e-12) for k in cpu[0]),
        "grad_max_abs": g_scale, "max_abs_grad_diff_over_max_abs": float((cpu[1] - card[1]).abs().max()) / g_scale,
        # how well posed an f32 gradient is here: both devices' distance to the f64 one
        "cpu_f32_vs_f64_grad_over_max_abs": float((cpu[1] - cpu64[1]).abs().max()) / g_scale,
        "card_f32_vs_f64_grad_over_max_abs": float((card[1] - cpu64[1]).abs().max()) / g_scale,
        "max_abs_param_diff_after_step": float((cpu[2] - card[2]).abs().max()),
        "bf16_vs_f32_grad_max_abs_diff_over_max_abs": float((bf16[1] - card[1]).abs().max()) / g_scale,
        "bf16_vs_f32_grad_rel_l2": float((bf16[1] - card[1]).norm() / card[1].norm()),
        "remat_on_vs_off_max_abs_stats_diff": float((card[3] - no_remat[3]).abs().max()),
        "stats_moved_by_step": float((card[3] - card[4]).abs().max()),
    }


def full_width_bf16_vs_f32(trainer, batch):
    """The gradient of one bf16 autocast step of the full-width detector on
    2 of the batch's images against the f32 one (same draws, the bf16 run's
    decisions replayed); the trainer's statistics and random key are
    restored afterwards."""
    import torch

    two = {k: v[:2] for k, v in batch.items()}
    stats, rng = trainer.stats.clone(), trainer.rng.copy()
    draws = trainer.next_draws(2)
    grads, made = [], {}
    for bf16, decide in ((True, {"record": made}), (False, {"replay": made})):
        trainer.bf16 = bf16
        trainer.flat.grad.zero_()
        with decisions(device=trainer.device, **decide):
            trainer.loss(two, draws)["total"].backward()
        grads.append(trainer.flat.grad.clone())
    trainer.bf16 = True
    trainer.flat.grad.zero_()
    trainer.stats.copy_(stats)
    trainer.rng = rng
    scale = float(grads[1].abs().max())
    out = {"images": 2, "f32_grad_max_abs": scale,
           "max_abs_diff_over_max_abs": float((grads[0] - grads[1]).abs().max()) / scale,
           "rel_l2": float((grads[0] - grads[1]).norm() / grads[1].norm())}
    del grads
    torch.cuda.empty_cache()
    return out


CAD_DRAWS_TIMED = 20


def draws_check(trainer, batch_size):
    """The samplers' draws of one step at ``batch_size`` on the card against
    the CPU's under the same step key (equal bits); the synchronised ms of
    ``next_draws`` (median of 20 calls), its kernels' device ms and the
    host's split of the step key; the trainer's key is restored."""
    import statistics

    import torch

    from unmore_tpu_torch.detector.cascade_rcnn import uniform_draws
    from unmore_tpu_torch.utils import prng

    rng = trainer.rng.copy()
    step = prng.split(rng)[1]
    card = uniform_draws(trainer.cfg, step, batch_size, trainer.device)
    cpu = uniform_draws(trainer.cfg, step, batch_size, "cpu")
    equal = all(torch.equal(card[k].cpu().view(torch.int32), cpu[k].view(torch.int32)) for k in cpu)
    times, split_s = [], []
    for _ in range(CAD_DRAWS_TIMED + 2):
        sync(trainer.device)
        t = time.perf_counter()
        trainer.next_draws(batch_size)
        sync(trainer.device)
        times.append(time.perf_counter() - t)
        t = time.perf_counter()
        prng.split(trainer.rng)
        split_s.append(time.perf_counter() - t)
    # the kernels' own time, apart from the host's launches and its split of the step key
    kernels_ms = device_ms(lambda: trainer.next_draws(batch_size))[0] if trainer.device.type == "cuda" else None
    trainer.rng = rng
    return {"batch": batch_size, "shapes": {k: list(v.shape) for k, v in cpu.items()},
            "elements": sum(v.numel() for v in cpu.values()), "card_equals_cpu_bits": equal,
            "next_draws_ms_median": statistics.median(times[2:]) * 1e3, "next_draws_ms": [x * 1e3 for x in times],
            "next_draws_kernels_ms": kernels_ms, "host_key_split_ms_median": statistics.median(split_s[2:]) * 1e3}


def nan_guard_check(trainer, batch):
    """A step fed a non-finite loss (NaN pseudo-label scores) keeps the
    parameters and statistics and advances the step, the count and the trace
    as optax does (zero gradient: trace = momentum * trace + wd * params)."""
    import torch

    opt = trainer.opt
    before = {"params": trainer.flat.data.clone(), "stats": trainer.stats.clone(), "trace": opt.trace.clone(),
              "count": int(opt.count), "step": int(trainer.step), "skipped": int(trainer.skipped)}
    bad = dict(batch, gt_scores=torch.where(batch["gt_valid"], torch.full_like(batch["gt_scores"], float("nan")),
                                            batch["gt_scores"]))
    loss = float(trainer.train_step(bad)["total"])
    want_trace = before["trace"] * opt.momentum + before["params"] * opt.weight_decay
    trace_err = float((opt.trace - want_trace).abs().max())
    out = {"loss": repr(loss), "params_kept": torch.equal(trainer.flat.data, before["params"]),
           "stats_kept": torch.equal(trainer.stats, before["stats"]),
           "step": [before["step"], int(trainer.step)], "count": [before["count"], int(opt.count)],
           "skipped": [before["skipped"], int(trainer.skipped)], "trace_max_abs_err": trace_err,
           "trace_max_abs": float(want_trace.abs().max())}
    ok = (loss != loss or abs(loss) == float("inf")) and out["params_kept"] and out["stats_kept"] and \
        out["step"][1] == out["step"][0] + 1 and out["count"][1] == out["count"][0] + 1 and \
        out["skipped"][1] == out["skipped"][0] + 1 and trace_err <= 1e-6 * max(out["trace_max_abs"], 1e-30)
    return out, ok


def phase_cad_train(device, smi):
    import shutil
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.data.detection import DetectionDataset
    from unmore_tpu_torch.scripts.make_synthetic_shapes import scene_world
    from unmore_tpu_torch.train.checkpoints import load_msgpack_checkpoint
    from unmore_tpu_torch.train.objectness import to_device

    problems = []
    t0 = time.perf_counter()
    train_json, files = cad_train_world(seed=1)
    eval_images, eval_gt = scene_world(0, CAD_SCENES)
    world_s = time.perf_counter() - t0
    folder = Path("build") / "smoke_cad_train"
    shutil.rmtree(folder, ignore_errors=True)
    args = train_net.parse_args(["--config-file", CAD_CONFIG, *CAD_TRAIN_CUTS, "OUTPUT_DIR", str(folder / "run")])
    det_cfg, solver, cfg_yaml = train_net.build_from_config(args)
    solver = train_net.auto_scale_workers(solver, 1)
    out_dir = solver["output_dir"]

    def dataset(seed):
        return DetectionDataset(train_json, {"": ""}, det_cfg.image_size, solver["min_sizes"], seed,
                                read_image=files.get)

    eval_s = []

    def evaluate(model, tag, verify):
        t = time.perf_counter()
        metrics = train_net.run_eval(model, det_cfg, cfg_yaml, out_dir, tag,
                                     MemoryImages(eval_images, [im["id"] for im in eval_gt["images"]]), eval_gt,
                                     device, 4, 2, verify)
        eval_s.append(time.perf_counter() - t)
        return metrics

    trainer = train_net.make_trainer(det_cfg, solver, device, "bfloat16")
    # FLOPs of one step (and the warm-up of cuDNN and the allocator) on a
    # batch of its own; the statistics and the random key are restored
    flop_batch = to_device({k: v for k, v in train_net.batch_workers(dataset, det_cfg, solver, 1)[0]().items()
                            if k != "n_gt_dropped"}, device)
    stats, rng = trainer.stats.clone(), trainer.rng.copy()
    counter = FlopCounterMode(display=False)
    with counter:
        trainer.loss(flop_batch)["total"].backward()
    flops = counter.get_total_flops()
    trainer.flat.grad.zero_()
    trainer.stats.copy_(stats)
    trainer.rng = rng
    sync(device)
    peak_bytes(device, reset=True)

    step_s, losses, state15, last = [], {}, {}, [time.perf_counter()]

    def on_step(step_no, out):
        sync(device)
        now = time.perf_counter()
        step_s.append(now - last[0])
        losses[step_no] = {k: float(v) for k, v in out.items()}
        if step_no == 15:
            state15["tree"] = trainer.state_tree()
        last[0] = time.perf_counter()

    summary = train_net.train_detector(trainer, solver, out_dir,
                                       train_net.batch_workers(dataset, det_cfg, solver, CAD_TRAIN_WORKERS), evaluate,
                                       on_step=on_step)
    peak = peak_bytes(device)
    step_ms = statistics.median(step_s[CAD_TRAIN_TIMED_FROM:]) * 1e3
    skipped = int(trainer.skipped)

    if not all(v == v and abs(v) != float("inf") for step in losses.values() for v in step.values()):
        problems.append("a non-finite training loss")
    if not all(v == v for line in summary["logs"] for v in line.values()):
        problems.append(f"a non-finite logged loss {summary['logs']}")
    names = [Path(c["path"]).name for c in summary["checkpoints"]]
    if names != ["model_0000015.ckpt", "model_0000030.ckpt"] or not all(Path(c["path"]).is_file()
                                                                        for c in summary["checkpoints"]):
        problems.append(f"checkpoints {names}")
    t = time.perf_counter()
    bad = same_tree(load_msgpack_checkpoint(str(Path(out_dir) / "model_0000015.ckpt")), state15["tree"])
    read_s = time.perf_counter() - t
    if bad:
        problems.append(f"the step-15 checkpoint reads back other than the state saved, at {bad[:5]}")
    if not summary["evals"]:
        problems.append("no in-train evaluation")

    fixed = to_device({k: v for k, v in train_net.batch_workers(dataset, det_cfg, solver, 1)[0]().items()
                       if k != "n_gt_dropped"}, device)
    fixed_s = []
    for _ in range(4):
        sync(device)
        t = time.perf_counter()
        trainer.train_step(fixed)
        sync(device)
        fixed_s.append(time.perf_counter() - t)
    bf16_vs_f32 = full_width_bf16_vs_f32(trainer, fixed)
    draws = draws_check(trainer, solver["ims_per_batch"])
    draws["share_of_fixed_batch_step"] = draws["next_draws_ms_median"] / (statistics.median(fixed_s) * 1e3)
    if not draws["card_equals_cpu_bits"]:
        problems.append("the card's step draws differ from the CPU's")
    guard, ok = nan_guard_check(trainer, fixed)
    if not ok:
        problems.append(f"NaN guard: {guard}")
    del trainer, flop_batch, fixed
    torch.cuda.empty_cache()

    # a fresh trainer resumed from the step-15 checkpoint runs step 16
    resumed = train_net.make_trainer(det_cfg, solver, device, "bfloat16")
    train_net.load_training_state(resumed, str(Path(out_dir) / "model_0000015.ckpt"))
    first_step = int(resumed.step)
    again = train_net.train_detector(resumed, dict(solver, max_iter=16, eval_period=0), str(folder / "resumed"),
                                     train_net.batch_workers(dataset, det_cfg, solver, 1))
    resume = {"loaded_step": first_step, "step_after": int(resumed.step),
              "checkpoints": [Path(c["path"]).name for c in again["checkpoints"]]}
    if first_step != 15 or resume["step_after"] != 16 or resume["checkpoints"] != ["model_0000016.ckpt"]:
        problems.append(f"resume from the step-15 checkpoint: {resume}")
    del resumed
    torch.cuda.empty_cache()

    narrow = narrow_step_checks(device, train_json, files)
    # the gradient within 1e-3 of its max-abs, or, where f32 itself is that
    # far from f64 on the CPU, no more than twice the CPU's own distance
    grad_tol = max(1e-3, 2 * narrow["cpu_f32_vs_f64_grad_over_max_abs"])
    if not (narrow["max_rel_loss_diff"] <= 1e-4 and narrow["max_abs_grad_diff_over_max_abs"] <= grad_tol
            and narrow["max_abs_param_diff_after_step"] <= 1e-6):
        problems.append(f"f32 card and CPU training steps differ: {narrow}")
    if not (narrow["remat_on_vs_off_max_abs_stats_diff"] <= 1e-6 and narrow["stats_moved_by_step"] > 0):
        problems.append(f"remat changes the BatchNorm statistics: {narrow['remat_on_vs_off_max_abs_stats_diff']}")

    first, last_step = min(losses), max(losses)
    emit({
        "phase": "cad_train", "nvidia_smi": smi, "config": CAD_CONFIG,
        "model": "cascade mask r-cnn r50-fpn, seeded random weights (init_like_flax), f32 master weights, "
                 "bf16 autocast",
        "detector_config": {k: str(v) if k == "dtype" else v for k, v in dataclasses.asdict(det_cfg).items()},
        "solver": {k: v for k, v in solver.items() if k != "weights"},
        "cuts": {"MAX_ITER": "30000 -> 30", "CHECKPOINT_PERIOD": "1000 -> 15", "EVAL_PERIOD": "0 -> 30",
                 "PRECISE_BN.NUM_ITER": "200 -> 32",
                 "data": f"{CAD_TRAIN_WORLD} synthetic scenes in memory, "
                         f"{CAD_TRAIN_WORLD // 4} of them imagenet_ single objects",
                 "eval": "the 4 synthetic scenes of phase cad"},
        "world": {"images": len(train_json["images"]), "annotations": len(train_json["annotations"]),
                  "make_s": world_s},
        "steps": len(step_s), "step_ms_median_6_30": step_ms, "img_per_s": solver["ims_per_batch"] / step_ms * 1e3,
        "step_ms": [x * 1e3 for x in step_s], "fixed_batch_step_ms": [x * 1e3 for x in fixed_s],
        "tflop_per_step": flops / 1e12, "gflop_per_image": flops / solver["ims_per_batch"] / 1e9,
        "mfu_vs_989_tflops_bf16": flops / (step_ms / 1e3) / H100_BF16_FLOPS,
        "data_starved": summary["data_starved"], "max_memory_allocated_bytes": peak,
        "losses_first_step": losses[first], "losses_last_step": losses[last_step], "logs": summary["logs"],
        "nonfinite_steps_skipped": skipped, "checkpoints": summary["checkpoints"], "checkpoint_read_s": read_s,
        "precise_bn_s": summary["precise_bn_s"], "eval_s": eval_s,
        "eval_img_per_s": [len(eval_images) / x for x in eval_s], "eval_metrics": summary["evals"],
        "resume": resume, "nan_guard": guard, "bf16_vs_f32_full_width": bf16_vs_f32, "draws": draws,
        "narrow_checks": narrow,
        "kernels_on_path": [], "checks_failed": problems,
    })
    if problems:
        fail(f"cad_train phase: {problems[:5]}")
    shutil.rmtree(folder)  # three checkpoints of ~0.6 GB
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
# the dpt_hybrid backbone (ResNetV2-50 trunk + ViT-B/16) at full width through
# stage-1 training, discovery and scoring: phase 6's recipe and world, phase
# 3's images and cuts, phase 4's inputs
class DptHybrid:
    backbone_type, sdf_activation, use_bg_sdf = "dpt_hybrid", "tanh", True


HYBRID_FIXED_STEPS = 10  # synchronised steps on one batch, after the 30 fed ones
HYBRID_BF16_CROPS = 256  # one crop chunk
HYBRID_F32_TOL = {"forward_abs": 1e-4, "loss_rel": 1e-5, "grad_rel_l2": 1e-3}


def tiny_hybrid():
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.vit import ViTConfig

    trunk = dict(stem_width=32, stage_widths=((32, 64), (64, 128), (128, 256)), stage_blocks=(2, 2, 2), groups=8)
    return ObjectnessNet("dpt_hybrid", "tanh", True, features=64, hooks=(1, 3), widths=(64, 128, 128, 128),
                         vit_config=ViTConfig(depth=4, dim=128, heads=4, mlp_dim=256, pretrain_grid=8),
                         hybrid_resnet_kwargs=trunk)


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def hybrid_train(device, world, folder):
    """30 prefetch-fed steps of the hybrid at the script.sh recipe, then
    HYBRID_FIXED_STEPS on one batch, then its checkpoint read back."""
    import statistics

    from unmore_tpu_torch.cli.common import build_objectness
    from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, to_device
    from unmore_tpu_torch.train.optim import init_like_flax

    cfg = TrainObjectnessConfig(model=ModelConfig(backbone_type="dpt_hybrid", dtype="bfloat16"), optim=OptimConfig(),
                                batch_size=TRAIN_BATCH)
    model = build_objectness(DptHybrid, "float32", device).train()
    init_like_flax(model, seed=0)
    trainer = ObjectnessTrainer(model, cfg)
    prefetch = PrefetchIterator(worker_fns=[objectness_worker(*world, 400 + w) for w in range(TRAIN_WORKERS)])
    try:
        row = train_summary("dpt_hybrid", trainer, prefetch, device, "total")
        fixed = to_device(next(prefetch), device)
    finally:
        prefetch.close()
    if row["skipped_in_timed_steps"]:
        fail(f"dpt_hybrid: the spike guard skipped {row['skipped_in_timed_steps']} of {TRAIN_STEPS} steps")
    fixed_s = []
    for _ in range(HYBRID_FIXED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(fixed)
        sync(device)
        fixed_s.append(time.perf_counter() - t0)
    row["fixed_batch_step_ms"] = [x * 1e3 for x in fixed_s]
    row["fixed_batch_step_ms_median"] = statistics.median(fixed_s) * 1e3
    row["params"] = trainer.flat.data.numel()
    path, row["checkpoint"] = checkpoint_round_trip("dpt_hybrid", trainer, folder)
    return trainer, path, row


def hybrid_discovery(device, trainer, obj_path, kernel_counters):
    """The trained weights through cli/common.py's loader into the bf16 stage-2
    engine (trunk kernels and norm leaves kept in f32, every other weight
    rounded to bf16) and
    one discovery image group at phase 3's images and cuts, the threshold
    calibrated on this model. Thirty steps leave the SDF negative on every
    crop, so that group drops every proposal in the first boundary round; a
    second group, the one timed, runs on phase 3's seeded random weights
    (``init_random_variables``) with the reference's round semantics
    (``sticky_convergence=False``: converged boxes are predicted again every
    round), so that all ``n_round`` boundary rounds run. Decode launches are
    counted over both groups, and each is held against the plain version on
    its own inputs afterwards."""
    import torch

    from unmore_tpu_torch.cli.common import (
        build_classifier, build_objectness, init_random_variables, load_objectness_weights, make_apply_fns,
    )
    from unmore_tpu_torch.models.hybrid import StdConv2dSame
    from unmore_tpu_torch.ops.fields import center_singularity_scores
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig

    objectness = build_objectness(DptHybrid, "bfloat16", device)
    load_objectness_weights(objectness, obj_path)
    loaded, trained = objectness.state_dict(), trainer.model.state_dict()
    bad = [k for k in trainer.layout if not torch.equal(loaded[k], trained[k].to(loaded[k].dtype))]
    ws = [f"{n}.weight" for n, m in objectness.named_modules() if isinstance(m, StdConv2dSame)]
    bad += [k for k in ws if loaded[k].dtype != torch.float32] + norm_leaves(objectness)["not_float32"]
    if bad or not ws:
        fail(f"stage-2 loader gave other weights than the trainer's, or norm leaves not in float32, at {bad[:5]} "
             f"({len(ws)} standardised convs)")
    classifier = build_classifier("bfloat16", device)
    init_random_variables(classifier, seed=0)
    images = synthetic_images(seed=0)
    fns = make_apply_fns(objectness, classifier)
    calls = []

    def group(**extra):
        cuts = dict(MAIN_PATH_CUTS, **extra, **calibrate(objectness, images[0], ReasoningConfig(), device))
        engine = ObjectDiscoveryEngine(*fns, ReasoningConfig(**cuts), device=device)

        def record(sdf, center, decode=engine._decode):
            out = decode(sdf, center)
            calls.append((sdf.clone(), center.clone(), [t.clone() for t in out]))
            return out

        engine._decode = record
        peak_bytes(device, reset=True)
        t0 = time.perf_counter()
        results = engine.discover_batch(images)
        sync(device)
        wall = time.perf_counter() - t0
        check_boxes(images, results, "dpt_hybrid discovery")
        return results, cuts, wall, peak_bytes(device)

    start = launch_counts(kernel_counters)
    on_trained = group()
    init_random_variables(objectness, seed=0)
    results, cuts, wall, peak = group(sticky_convergence=False)
    launches = launch_counts(kernel_counters, since=start)
    cfg = ReasoningConfig(**cuts)
    rounds = [r["stats"]["boundary_rounds"] for r in results]
    if rounds != [cfg.n_round] * len(results):
        fail(f"the dpt_hybrid group ran {rounds} boundary rounds, not all {cfg.n_round}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the dpt_hybrid path")

    errors = []
    for sdf, center, got in calls:  # outside the counted runs
        want = center_singularity_scores(sdf, center)
        pos = want[0] > 1e-4
        if not (torch.equal(got[2], want[2]) and torch.equal(got[1][pos], want[1][pos])):
            fail("the decode kernel's union or argmax differs from the plain version on the dpt_hybrid path")
        errors.append(float((got[0] - want[0]).abs().max()))
    if len(calls) != launches["fused_center_decode"] or any(e != 0.0 for e in errors):
        fail(f"dpt_hybrid decode launches against the plain version: {errors} ({len(calls)} recorded)")

    live, executed = crop_counts(results, cfg)
    both, sdf_only, cls = model_flops_per_crop(objectness, classifier, cfg.crop_size, device)
    flops = group_flops(executed, both, sdf_only, cls)
    row = {
        "on_trained_weights": {"cuts": on_trained[1], "wall_s": on_trained[2], "stats": [r["stats"] for r in
                                                                                       on_trained[0]]},
        "weights": "phase 3's seeded random weights (init_random_variables, seed 0); the reference's rounds",
        "cuts": cuts, "wall_s": wall, "live_crops_per_phase": live, "executed_crops_per_phase": executed,
        "gflop_per_crop": {"objectness_both_heads": both / 1e9, "objectness_sdf_only": sdf_only / 1e9,
                           "classifier": cls / 1e9},
        "model_tflop": flops / 1e12, "mfu_vs_989_tflops_bf16": flops / wall / H100_BF16_FLOPS,
        "max_memory_allocated_bytes": peak, "kernel_launches": launches, "f32_standardised_kernels": len(ws),
        "decode_max_abs_err_per_launch": errors,
        "stats": [r["stats"] for r in results], "n_boxes": [len(r["boxes"]) for r in results],
    }
    return fns, row, {"both_heads": both / 1e9, "classifier": cls / 1e9}


def hybrid_scoring(device, fns, gflop, discovered):
    """One scoring call at phase 4's inputs after a warm-up call: device and
    host seconds and MFU."""
    import numpy as np

    from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig

    images, boxes = scoring_inputs(discovered)
    ids = list(range(1, len(images) + 1))
    cfg = ScoringConfig()
    engine = ObjectScoringEngine(*fns, cfg, device=device)
    t0 = time.perf_counter()
    first = engine.score_batch(images, boxes, ids)
    first_wall = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    anns = engine.score_batch(images, boxes, ids)
    wall = time.perf_counter() - t0
    timings = dict(engine.last_timings)
    scores = [a[k] for per_image in anns for a in per_image for k in ("score", "existence_score", "center_score",
                                                                      "boundary_score")]
    if not all(np.isfinite(scores)) or anns != first:
        fail("dpt_hybrid scoring: non-finite scores, or two calls on the same inputs differ")
    n_crops = -(-sum(len(b) for b in boxes) // cfg.slot_multiple) * cfg.slot_multiple
    flops = n_crops * (gflop["both_heads"] + gflop["classifier"]) * 1e9
    return {"lattice_slots": n_crops, "annotations_per_image": [len(a) for a in anns],
            "device_s": timings["device_s"], "host_s": timings["host_s"], "wall_s": wall,
            "first_call_wall_s": first_wall, "crops_per_device_s": n_crops / timings["device_s"],
            "mfu_vs_989_tflops_bf16_device_s": flops / timings["device_s"] / H100_BF16_FLOPS}


def hybrid_f32_card_vs_cpu(device, batch_host):
    """A narrow f32 hybrid (TF32 off) on the card and on the CPU from equal
    weights: one forward, then one training step on an equal batch."""
    import torch

    from unmore_tpu_torch.config import ModelConfig, TrainObjectnessConfig
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer, decode_wire_batch, to_device
    from unmore_tpu_torch.train.optim import init_like_flax

    cfg = TrainObjectnessConfig(model=ModelConfig(dtype="float32"))
    cpu_model = tiny_hybrid()
    init_like_flax(cpu_model, 5)
    card_model = tiny_hybrid()
    card_model.load_state_dict(cpu_model.state_dict())
    host = {k: v[:2] for k, v in batch_host.items()}
    outs = []
    for model, dev in ((cpu_model, torch.device("cpu")), (card_model.to(device), device)):
        batch = to_device(host, dev)
        with torch.no_grad():
            fwd = {k: v.cpu() for k, v in model.eval()(decode_wire_batch(batch)["image"]).items()}
        trainer = ObjectnessTrainer(model, cfg)
        losses = trainer.train_step(batch)
        outs.append((fwd, {k: float(v) for k, v in losses.items()}, trainer.flat.grad.cpu(), trainer.flat.data.cpu()))
    (f_cpu, l_cpu, g_cpu, p_cpu), (f_card, l_card, g_card, p_card) = outs
    row = {"crops": 2, "tolerance": HYBRID_F32_TOL,
           "forward_max_abs_diff": max(float((f_cpu[k] - f_card[k]).abs().max()) for k in f_cpu),
           "losses_cpu": l_cpu, "losses_card": l_card,
           "max_rel_loss_diff": max(abs(l_cpu[k] - l_card[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu),
           "grad_rel_l2": rel_l2(g_card, g_cpu),
           "max_abs_param_diff_after_step": float((p_cpu - p_card).abs().max())}
    if not (row["forward_max_abs_diff"] <= HYBRID_F32_TOL["forward_abs"]
            and row["max_rel_loss_diff"] <= HYBRID_F32_TOL["loss_rel"]
            and row["grad_rel_l2"] <= HYBRID_F32_TOL["grad_rel_l2"]):
        fail(f"f32 dpt_hybrid on the card and on the CPU differ: {row}")
    return row


def hybrid_bf16_vs_f32(device, images):
    """The full-width hybrid in bf16 and in f32 from the same seeded weights
    (phase 5's) on one chunk of HYBRID_BF16_CROPS crops of phase 3's first
    image, the first 8 of them phase 5's."""
    import torch

    from unmore_tpu_torch.cli.common import build_objectness, init_random_variables

    crops = torch.cat([random_crops(images[0], 8, 1, device),
                       random_crops(images[0], HYBRID_BF16_CROPS - 8, 2, device)])
    out = {}
    for dtype in ("bfloat16", "float32"):
        model = build_objectness(DptHybrid, dtype, device)
        init_random_variables(model, seed=0)
        chunk = HYBRID_BF16_CROPS if dtype == "bfloat16" else 64  # f32 activations of 256 crops do not fit twice
        with torch.inference_mode():
            parts = [model(crops[i : i + chunk]) for i in range(0, HYBRID_BF16_CROPS, chunk)]
        out[dtype] = {k: torch.cat([p[k] for p in parts]) for k in ("sdf_maps", "center_fields")}
        del model, parts
        if device.type == "cuda":
            torch.cuda.empty_cache()
    got, want = out["bfloat16"], out["float32"]
    if not all(torch.isfinite(t).all() for d in out.values() for t in d.values()):
        fail("non-finite dpt_hybrid output")
    return {"crops": HYBRID_BF16_CROPS,
            **{f"{k}_max_abs_diff": float((got[k] - want[k]).abs().max()) for k in got},
            **{f"{k}_rel_l2": rel_l2(got[k], want[k]) for k in got},
            "sdf_sign_agreement": float(((got["sdf_maps"] > 0) == (want["sdf_maps"] > 0)).float().mean()),
            "phase_5_crops": {f"{k}_max_abs_diff": float((got[k][:8] - want[k][:8]).abs().max()) for k in got}}


def phase_hybrid(device, kernel_counters, discovered, dpt_large_bf16):
    import shutil

    import torch

    t_phase = t0 = time.perf_counter()
    world = shape_world(seed=0, **TRAIN_WORLD)
    world_s = time.perf_counter() - t0
    folder = Path("build") / "smoke_hybrid"
    folder.mkdir(parents=True, exist_ok=True)
    trainer, obj_path, train_row = hybrid_train(device, world, folder)
    fns, discovery, gflop = hybrid_discovery(device, trainer, obj_path, kernel_counters)
    launches = discovery["kernel_launches"]
    del trainer
    scoring = hybrid_scoring(device, fns, gflop, discovered)
    del fns
    if device.type == "cuda":
        torch.cuda.empty_cache()
    f32 = hybrid_f32_card_vs_cpu(device, objectness_worker(*world, 500)())
    bf16 = hybrid_bf16_vs_f32(device, synthetic_images(seed=0))
    emit({"phase": "hybrid", "model": "dpt_hybrid (vitb_rn50_384: resnetv2-50 (3,4,9) GroupNorm(32) + vit-b/16 "
                                      "taps (8,11), widths (256,512,768,768), features 256, tanh bg-sdf)",
          "world_make_s": world_s, "train": train_row, "discovery": discovery, "scoring": scoring,
          "f32_card_vs_cpu": f32, "bf16_vs_f32": bf16, "dpt_large_bf16_vs_f32_8_crops": dpt_large_bf16,
          "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(folder)  # the checkpoint of ~1.5 GB
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 10
# two ranks share the one card over gloo (NCCL refuses two ranks on one device);
# their times are of two processes on one card, not a scaling figure
DIST_RANKS = 2
DIST_JOIN_TIMEOUT_S = 600  # the ranks are killed, and the smoke fails, after this
DIST_GROUP_TIMEOUT_S = 600  # a collective that waits longer raises in the rank
DIST_F32_STEPS = 3
DIST_BF16_STEPS = 6
DIST_CAD_BF16_STEPS = 4
DIST_FOLDER = Path("build") / "smoke_dist"
# discovery in f32 runs ~40x slower than phase 3's bf16 group: 5 boundary
# rounds of 50, model chunks of 64 crops (two f32 ranks of 256 overfill the card)
DIST_STAGE2_CUTS = ("--n_round", "5", "--crop_chunk", "64")


def dist_images():
    """Phase 3's two images and two more seeded ones: with one image a
    discovery group, each rank discovers two groups."""
    return synthetic_images(seed=0) + synthetic_images(seed=5, sizes=((256, 256), (240, 320)))


class MemoryCOCO(MemoryImages):
    """``COCOImages``'s interface over :func:`dist_images` made in process (the
    stage-2 CLIs' paths are not read: the card machine may lack PIL)."""

    def __init__(self, *paths):
        images = dist_images()
        super().__init__(images, list(range(1, len(images) + 1)))

    def image_id(self, idx):
        return self.ids[idx]


def dist_stage2_argv(run, center_thres, one_rank, device):
    """The discovery and scoring CLIs' argv: phase 3's cuts and
    :data:`DIST_STAGE2_CUTS`, one image a group, f32 (TF32 off), sticky
    convergence, ``device`` for every rank."""
    model = ["--device", str(device), "--dtype", "float32", "--sdf_activation", "tanh", "--use_bg_sdf",
             "--coco_image_dir", "memory", "--coco_annotations", "memory", *(["--devices", "1"] if one_rank else [])]
    cuts = ["--canvas_size", str(MAIN_PATH_CUTS["canvas_size"]), "--image_batch", "1",
            "--max_proposals", str(MAIN_PATH_CUTS["max_proposals"]), "--max_splits", str(MAIN_PATH_CUTS["max_splits"]),
            "--max_active", str(MAIN_PATH_CUTS["max_active"]), "--class_score_thres", "0.0",
            "--center_score_max_thres", repr(center_thres), *DIST_STAGE2_CUTS]
    return (model + cuts + ["--run_name", run],
            model + ["--raw_annotations_path", f"results_reasoning/{run}/discovery_results.json"])


@contextlib.contextmanager
def stage2_in(folder):
    """The stage-2 CLIs run in ``folder`` on :class:`MemoryCOCO`."""
    import os

    from unmore_tpu_torch.data import coco

    real, cwd = coco.COCOImages, os.getcwd()
    coco.COCOImages = MemoryCOCO
    os.chdir(folder)
    try:
        yield
    finally:
        os.chdir(cwd)
        coco.COCOImages = real


def dist_cad_setup():
    """The CAD YAML at full width (batch 16 global), its solver and an
    in-memory dataset function."""
    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.data.detection import DetectionDataset

    train_json, files = cad_train_world(seed=1)
    args = train_net.parse_args(["--config-file", CAD_CONFIG])
    det_cfg, solver, _ = train_net.build_from_config(args)

    def dataset(seed):
        return DetectionDataset(train_json, {"": ""}, det_cfg.image_size, solver["min_sizes"], seed,
                                read_image=files.get)

    return det_cfg, solver, dataset


def dist_inputs():
    """The global batches every run of the phase takes: 3 objectness batches
    and one classifier batch of 20 (phase 6's world), one CAD batch of 16."""
    from unmore_tpu_torch.cli import train_net

    images, masks = shape_world(seed=0, **TRAIN_WORLD)
    obj, cls = objectness_worker(images, masks, 500), classifier_worker(images, masks, 600)
    det_cfg, solver, dataset = dist_cad_setup()
    cad = train_net.batch_workers(dataset, det_cfg, solver, 1)[0]()
    cad.pop("n_gt_dropped")
    return {"objectness": [obj() for _ in range(DIST_F32_STEPS)], "classifier": cls(), "cad": cad}


def dist_objectness_trainer(device):
    from unmore_tpu_torch.cli.common import build_objectness
    from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer
    from unmore_tpu_torch.train.optim import init_like_flax

    model = build_objectness(DptLarge, "float32", device).train()
    init_like_flax(model, seed=7)
    cfg = TrainObjectnessConfig(model=ModelConfig(dtype="float32"), optim=OptimConfig(), batch_size=TRAIN_BATCH)
    return ObjectnessTrainer(model, cfg)


def dist_classifier_trainer(device):
    from unmore_tpu_torch.cli.common import build_classifier
    from unmore_tpu_torch.config import OptimConfig
    from unmore_tpu_torch.train.classifier import ClassifierTrainer
    from unmore_tpu_torch.train.optim import init_like_flax

    model = build_classifier("float32", device)
    init_like_flax(model, seed=8)
    return ClassifierTrainer(model, OptimConfig(), "float32")


def dist_nccl_one_rank(device):
    """A one-rank NCCL group (``initialize`` given the address and one
    process): a DPT-Large stage-1 step's flat gradient through
    ``all_reduce_mean_`` (equal bits: one rank), one step whose own
    all-reduce runs on NCCL, one ``all_gather_objects``."""
    import datetime
    import socket

    import torch

    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.objectness import to_device

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.initialize(f"127.0.0.1:{port}", 1, 0, timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    try:
        trainer = dist_objectness_trainer(device)
        trainer.bf16 = True
        images, masks = shape_world(seed=0, **TRAIN_WORLD)
        batch = to_device(objectness_worker(images, masks, 700)(), device)
        trainer.flat.grad.zero_()
        trainer.loss(batch)["total"].backward()
        grad = trainer.flat.grad.clone()
        reduced = dist.all_reduce_mean_(trainer.flat.grad)
        sync(device)
        equal = torch.equal(reduced, grad)
        loss = float(trainer.train_step(batch)["total"])
        gathered = dist.all_gather_objects({"rank": dist.process_index()})
        row = {"backend": torch.distributed.get_backend(), "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
               "world_size": torch.distributed.get_world_size(), "flat_grad_elements": grad.numel(),
               "all_reduce_mean_equal_bits": equal, "step_loss": loss, "all_gather_objects": gathered}
    finally:
        dist.shutdown()
    del trainer, grad
    torch.cuda.empty_cache()
    if not (equal and gathered == [{"rank": 0}] and loss == loss):
        fail(f"one-rank NCCL group: {row}")
    return row


def dist_references(device, inputs, center_thres):
    """One rank on the whole global batches (the reference of the two-rank
    runs): the objectness trainer's f32 losses, first gradient and final
    parameters; the classifier's f32 step (loss, gradient, running
    statistics); the CAD's f32 step (its decisions recorded); the stage-2
    CLIs' files."""
    import torch

    from unmore_tpu_torch.cli import object_reasoning, object_scoring, train_net
    from unmore_tpu_torch.train.objectness import to_device

    ref, t0 = {}, time.perf_counter()
    trainer = dist_objectness_trainer(device)
    losses = []
    for i, host in enumerate(inputs["objectness"]):
        losses.append(float(trainer.train_step(to_device(host, device))["total"]))
        if i == 0:
            grad1 = trainer.flat.grad.cpu().clone()
    ref["objectness"] = {"losses": losses, "grad1": grad1, "params": trainer.flat.data.cpu().clone()}
    del trainer
    trainer = dist_classifier_trainer(device)
    loss = float(trainer.train_step(to_device(inputs["classifier"], device))["loss"])
    ref["classifier"] = {"loss": loss, "grad": trainer.flat.grad.cpu().clone(),
                         "grad64": dist_classifier_grad64(device, inputs["classifier"], trainer.flat.names),
                         "stats": {k: v.cpu().clone() for k, v in trainer.stats.items()}}
    del trainer
    torch.cuda.empty_cache()
    det_cfg, solver, _ = dist_cad_setup()
    trainer = train_net.make_trainer(det_cfg, solver, device, "float32")
    made = {}
    with decisions(record=made):
        out = trainer.train_step(to_device(inputs["cad"], device))
    ref["cad"] = {"losses": {k: float(v) for k, v in out.items()}, "params": trainer.flat.data.cpu().clone(),
                  "stats": trainer.stats.cpu().clone(), "decisions": _tree(made, lambda t: t.cpu())}
    del trainer, made
    torch.cuda.empty_cache()
    ref["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    disc, score = dist_stage2_argv("one", center_thres, True, device)
    with stage2_in(DIST_FOLDER):
        object_reasoning.main(disc)
        object_scoring.main(score)
    ref["stage2_s"] = time.perf_counter() - t0
    return ref


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def dist_rank_stage1(device, inputs, ref, row_fn):
    """(a) The objectness trainer on its rows: f32 steps against the one-rank
    run (first gradient, losses, parameters), then bf16 steps timed, fed by
    the host's stream through prefetch threads."""
    import statistics

    import torch

    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.objectness import to_device

    trainer = dist_objectness_trainer(device)
    initial = trainer.flat.data.clone()
    losses = []
    for i, host in enumerate(inputs["objectness"]):
        losses.append(float(trainer.train_step(to_device(dist.local_rows(host), device))["total"]))
        if i == 0:
            g, g_ref = trainer.flat.grad.cpu(), ref["grad1"]
            grad_rel_l2 = rel_l2(g, g_ref)
    p, p_ref = trainer.flat.data.cpu(), ref["params"]
    moved, moved_ref = p - initial.cpu(), p_ref - initial.cpu()
    lr = trainer.cfg.optim.learning_rate
    f32 = {"steps": DIST_F32_STEPS, "losses": losses, "losses_one_rank": ref["losses"],
           "first_loss_rel_diff": _rel(losses[0], ref["losses"][0]),
           "max_rel_loss_diff": max(_rel(a, b) for a, b in zip(losses, ref["losses"])),
           "first_grad_rel_l2": grad_rel_l2, "params_max_abs_diff": float((p - p_ref).abs().max()),
           "params_update_rel_l2": rel_l2(moved, moved_ref),
           "params_share_differing_by_1e-7": float(((p - p_ref).abs() > 1e-7).float().mean()),
           "params_checksum": float(p.double().sum()),
           "tolerance": {"first_loss_rel_diff": 1e-6, "first_grad_rel_l2": 1e-4,
                         "params_max_abs_diff": 2.01 * DIST_F32_STEPS * lr,
                         "why": "an Adam step moves a weight by at most ~1.004 lr in its first three steps, "
                                "either way where its gradient is within rounding of zero; after the first "
                                "step the recipe's rate throws the loss up by orders of magnitude and two runs "
                                "drift apart, so the later losses are reported, not bounded"}}
    tol = f32["tolerance"]
    ok = all(f32[k] <= tol[k] for k in tol if k != "why")
    del p, p_ref, moved, moved_ref, initial, g, g_ref

    trainer.bf16 = True
    images, masks = shape_world(seed=0, **TRAIN_WORLD)
    prefetch = PrefetchIterator(worker_fns=[row_fn(objectness_worker(images, masks, 100 + w))
                                            for w in range(TRAIN_WORKERS)])
    seconds = []
    try:
        peak_bytes(device, reset=True)
        for _ in range(DIST_BF16_STEPS):
            host = next(prefetch)
            t0 = time.perf_counter()
            out = trainer.train_step(to_device(host, device))
            sync(device)
            seconds.append(time.perf_counter() - t0)
        if float(out["total"]) != float(out["total"]):
            fail("two-rank bf16 objectness step: non-finite loss")
    finally:
        prefetch.close()
    del trainer
    torch.cuda.empty_cache()
    return ok, {"f32": f32, "bf16": {"steps": DIST_BF16_STEPS, "rows_per_rank": TRAIN_BATCH // DIST_RANKS,
                                      "step_ms": [s * 1e3 for s in seconds],
                                      "step_ms_median_from_3": statistics.median(seconds[2:]) * 1e3,
                                      "starved_fraction": prefetch.starved_fraction,
                                      "max_memory_allocated_bytes": peak_bytes(device)}}


def dist_classifier_grad64(device, batch, names):
    """The classifier's gradient on the whole batch in float64, at the
    trainer's initial weights, flat in ``names``' order."""
    import torch

    from unmore_tpu_torch.train.classifier import bce_loss
    from unmore_tpu_torch.train.objectness import decode_wire_batch, to_device

    model = dist_classifier_trainer(device).model.double()
    b = decode_wire_batch(to_device(batch, device))
    bce_loss(model(b["image"].double())[:, 0], b["label"].double()).backward()
    params = dict(model.named_parameters())
    return torch.cat([params[n].grad.reshape(-1) for n in names]).cpu()


def dist_rank_classifier(device, inputs, ref):
    """(b) The classifier's f32 step on its rows: loss, flat gradient and
    BatchNorm running statistics (global-batch statistics) against one rank.
    BatchNorm at random initialisation makes the f32 gradient ill-posed, so
    the gradient is held against the float64 one, as close as one rank's."""
    import torch

    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.objectness import to_device

    trainer = dist_classifier_trainer(device)
    loss = float(trainer.train_step(to_device(dist.local_rows(inputs["classifier"]), device))["loss"])
    g = trainer.flat.grad.cpu()
    diffs = {k: float((v.cpu() - ref["stats"][k]).abs().max()) for k, v in trainer.stats.items()}
    scale = max(float(v.abs().max()) for v in ref["stats"].values())
    one_rank_vs_f64 = rel_l2(ref["grad"], ref["grad64"])
    row = {"loss": loss, "loss_one_rank": ref["loss"], "loss_rel_diff": _rel(loss, ref["loss"]),
           "grad_rel_l2_vs_one_rank": rel_l2(g, ref["grad"]), "grad_rel_l2_vs_f64": rel_l2(g, ref["grad64"]),
           "one_rank_grad_rel_l2_vs_f64": one_rank_vs_f64,
           "running_stats_max_abs_diff": max(diffs.values()), "running_stats_max_abs": scale,
           "tolerance": {"loss_rel_diff": 1e-5, "grad_rel_l2_vs_f64": 2 * one_rank_vs_f64 + 1e-6,
                         "running_stats_max_abs_diff": 1e-5 * max(scale, 1.0)}}
    del trainer
    torch.cuda.empty_cache()
    return all(row[k] <= v for k, v in row["tolerance"].items()), row


def dist_rank_cad(device, inputs, ref, row_fn):
    """(c) The CAD at full width on its 8 rows: one f32 step with the global
    batch's draws and the one-rank run's decisions replayed (losses,
    parameters, BatchNorm statistics), then bf16 steps timed, fed by the
    host's stream through prefetch threads."""
    import statistics

    import torch

    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.data.prefetch import PrefetchIterator
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.train.objectness import to_device

    det_cfg, solver, dataset = dist_cad_setup()
    trainer = train_net.make_trainer(det_cfg, solver, device, "float32")
    b, r = solver["ims_per_batch"] // DIST_RANKS, dist.process_index()
    mine = _tree(ref["decisions"], lambda t: t[r * b:(r + 1) * b])
    with decisions(replay=mine, device=device):
        out = trainer.train_step(to_device(dist.local_rows(inputs["cad"]), device))
    losses = {k: float(v) for k, v in out.items()}
    f32 = {"losses": losses, "losses_one_rank": ref["losses"],
           "max_rel_loss_diff": max(_rel(losses[k], ref["losses"][k]) for k in losses),
           "params_max_abs_diff": float((trainer.flat.data.cpu() - ref["params"]).abs().max()),
           "stats_max_abs_diff": float((trainer.stats.cpu() - ref["stats"]).abs().max()),
           "stats_max_abs": float(ref["stats"].abs().max()), "params_checksum": float(trainer.flat.data.double().sum()),
           "tolerance": {"max_rel_loss_diff": 1e-4, "params_max_abs_diff": 1e-6, "stats_max_abs_diff": 1e-4}}
    ok = all(f32[k] <= f32["tolerance"][k] for k in ("max_rel_loss_diff", "params_max_abs_diff",
                                                      "stats_max_abs_diff"))
    trainer.bf16 = True
    prefetch = PrefetchIterator(worker_fns=train_net.batch_workers(dataset, det_cfg, solver, CAD_TRAIN_WORKERS))
    seconds = []
    try:
        peak_bytes(device, reset=True)
        for _ in range(DIST_CAD_BF16_STEPS):
            host = next(prefetch)
            host.pop("n_gt_dropped", None)
            t0 = time.perf_counter()
            out = trainer.train_step(to_device(host, device))
            sync(device)
            seconds.append(time.perf_counter() - t0)
        if float(out["total"]) != float(out["total"]):
            fail("two-rank bf16 CAD step: non-finite loss")
    finally:
        prefetch.close()
    del trainer
    torch.cuda.empty_cache()
    return ok, {"f32": f32, "bf16": {"steps": DIST_CAD_BF16_STEPS, "rows_per_rank": b,
                                      "step_ms": [s * 1e3 for s in seconds],
                                      "step_ms_median_from_2": statistics.median(seconds[1:]) * 1e3,
                                      "data_starved": prefetch.starved_fraction,
                                      "max_memory_allocated_bytes": peak_bytes(device)}}


def dist_rank_stage2(device, center_thres):
    """(d) Discovery and (e) scoring through the CLIs' entry on this rank's
    shard; every decode launch is recorded and held against the plain
    version afterwards."""
    import torch

    from unmore_tpu_torch.cli import object_reasoning, object_scoring
    from unmore_tpu_torch.ops.fields import center_singularity_scores
    from unmore_tpu_torch.reasoning import engine
    from unmore_tpu_torch.utils import tracing

    calls, real = [], engine.fused_center_decode

    def record(sdf, center, *args, **kwargs):  # the engine takes its decode when the CLI builds it
        out = real(sdf, center, *args, **kwargs)
        calls.append((sdf.clone(), center.clone(), [t.clone() for t in out]))
        return out

    engine.fused_center_decode = record
    disc, score = dist_stage2_argv("two", center_thres, False, device)
    start = tracing.counter(DECODE_LAUNCHES)
    try:
        with stage2_in(DIST_FOLDER):
            t0 = time.perf_counter()
            object_reasoning.main(disc)
            discovery_s = time.perf_counter() - t0
            launches = tracing.counter(DECODE_LAUNCHES) - start
            t0 = time.perf_counter()
            object_scoring.main(score)
            scoring_s = time.perf_counter() - t0
    finally:
        engine.fused_center_decode = real
    errors = []
    for sdf, center, got in calls:
        want = center_singularity_scores(sdf, center)
        pos = want[0] > 1e-4
        if not (torch.equal(got[2], want[2]) and torch.equal(got[1][pos], want[1][pos])):
            fail("the decode kernel's union or argmax differs from the plain version on a rank")
        errors.append(float((got[0] - want[0]).abs().max()))
    ok = launches > 0 and len(calls) == launches and all(e == 0.0 for e in errors)
    del calls
    torch.cuda.empty_cache()
    return ok, {"discovery_s": discovery_s, "scoring_s": scoring_s, "decode_launches": launches,
                "decode_max_abs_err": max(errors, default=None)}


def dist_rank(folder, device):
    """One of the phase's two ranks on the one card (gloo on CUDA tensors)."""
    import datetime

    import torch

    from unmore_tpu_torch.parallel import distributed as dist

    dist.initialize(backend="gloo", timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    folder = Path(folder)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)
    ref = torch.load(folder / "ref.pt", weights_only=False)
    t0 = time.perf_counter()

    def rows(make_batch):
        return lambda: dist.local_rows(make_batch())

    out, ok = {"rank": dist.process_index()}, {}
    parts = (("stage1", "stage1_dpt_large", lambda: dist_rank_stage1(device, inputs, ref["objectness"], rows)),
             ("classifier", "classifier_resnet50", lambda: dist_rank_classifier(device, inputs, ref["classifier"])),
             ("cad", "cad", lambda: dist_rank_cad(device, inputs, ref["cad"], rows)),
             ("stage2", "stage2", lambda: dist_rank_stage2(device, inputs["center_thres"])))
    for check, key, run in parts:
        ok[check], out[key] = run()
        print(f"dist rank {out['rank']}: {check} {'ok' if ok[check] else 'FAILED'}", flush=True)
    out["checks"], out["rank_s"] = ok, time.perf_counter() - t0
    out["max_memory_allocated_bytes"] = peak_bytes(device)
    (folder / f"rank{dist.process_index()}.json").write_text(json.dumps(out))


def phase_dist(device, center_thres):
    """Phase 10: data parallelism. A one-rank NCCL group; then two ranks on
    the one card over gloo (spawned through ``parallel/mesh.py``) against one
    rank on the same global batches: stage 1 (DPT-Large, the recipe's batch
    20, 10 a rank), the classifier, the CAD (batch 16, 8 a rank), discovery
    and scoring through the CLIs."""
    import shutil

    import torch

    from unmore_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    nccl = dist_nccl_one_rank(device)
    shutil.rmtree(DIST_FOLDER, ignore_errors=True)
    DIST_FOLDER.mkdir(parents=True)
    inputs = dict(dist_inputs(), center_thres=center_thres)
    torch.save(inputs, DIST_FOLDER / "inputs.pt")
    ref = dist_references(device, inputs, center_thres)
    torch.save({k: v for k, v in ref.items() if k not in ("train_s", "stage2_s")}, DIST_FOLDER / "ref.pt")
    one_rank_s = {"train_s": ref["train_s"], "stage2_s": ref["stage2_s"]}
    del ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = mesh.launch(dist_rank, (str(DIST_FOLDER), str(device)), DIST_RANKS, timeout=DIST_JOIN_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"a rank of phase dist exited with code {rc}")
    ranks = [json.loads((DIST_FOLDER / f"rank{r}.json").read_text()) for r in range(DIST_RANKS)]
    problems = [f"rank {r['rank']}: {k}" for r in ranks for k, v in r["checks"].items() if not v]
    for key in ("stage1_dpt_large", "cad"):
        sums = {r[key]["f32"]["params_checksum"] for r in ranks}
        if len(sums) != 1:
            problems.append(f"{key}: the ranks' parameters differ ({sums})")
    out = DIST_FOLDER / "results_reasoning"
    one = json.loads((out / "one" / "discovery_results.json").read_text())
    two = json.loads((out / "two" / "discovery_results.json").read_text())
    if two != one:
        problems.append("merged discovery_results.json differs from the one-rank run")

    def key(a):
        return a["image_id"], tuple(a["bbox"])

    s_one = sorted(json.loads((out / "one" / "object_discovery_with_scores.json").read_text()), key=key)
    s_two = sorted(json.loads((out / "two" / "object_discovery_with_scores.json").read_text()), key=key)
    if s_two != s_one:
        problems.append("merged object_discovery_with_scores.json differs from the one-rank run")
    partials = sorted(p.name for p in (out / "two").iterdir() if p.suffix == ".jsonl")
    if partials != ["partial_results_p0.jsonl", "partial_results_p1.jsonl", "scoring_partial_p0.jsonl",
                    "scoring_partial_p1.jsonl"]:
        problems.append(f"partial files {partials}")
    launches = {f"rank{r['rank']}": r["stage2"]["decode_launches"] for r in ranks}
    emit({"phase": "dist", "note": "two ranks sharing one card over gloo: times of two processes on one card, "
                                   "not a scaling figure",
          "nccl_one_rank": nccl, "ranks": DIST_RANKS, "backend_two_ranks": "gloo (CUDA tensors)",
          "images": [list(im.shape[:2]) for im in dist_images()], "boxes": sum(len(v) for v in one.values()),
          "annotations": len(s_one), "discovery_equal": two == one, "scoring_equal": s_two == s_one,
          "partial_files": partials, "decode_launches_per_rank": launches, "one_rank_s": one_rank_s,
          "ranks_s": ranks_s, "per_rank": ranks, "checks_failed": problems,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail(f"phase dist: {problems}")
    shutil.rmtree(DIST_FOLDER)
    return launches


# ------------------------------------------------------------------ phase 11
CHAIN_FOLDER = Path("build") / "smoke_chain"
# the chain's knobs: a world of 6 scenes at 320^2 (2 dense) and 60 single-shape
# images; both trainers at the recipe's batch 20 for 200 steps with one
# checkpoint, supervised; discovery in two segments of 3 scenes at phase 3's
# canvas, image batch and lattices, every other stage-2 knob the CLI's default;
# the CAD's YAML at batch 8 for 30 steps, one checkpoint, evaluated at the end;
# the A/Bs on the 2 dense scenes, one image group, the truncated lattice half of 512
CHAIN_ARGS = ("--scenes", "6", "--size", "320", "--dense_frac", "0.34", "--dense_objects", "16", "--stage1_n", "60",
              "--s1_iters", "200", "--save_every", "200", "--exist_iters", "200", "--exist_save", "200",
              "--train_restarts", "1", "--seg", "3", "--image_batch", "2",
              "--canvas", str(MAIN_PATH_CUTS["canvas_size"]), "--max_proposals", str(MAIN_PATH_CUTS["max_proposals"]),
              "--max_splits", str(MAIN_PATH_CUTS["max_splits"]), "--max_active", str(MAIN_PATH_CUTS["max_active"]),
              "--cad_batch", "8", "--cad_iters", "30", "--cad_step", "20", "--cad_ckpt_period", "30",
              "--cad_eval_period", "30", "--ab_end", "2", "--ab_max_active", "256")
CHAIN_TIMEOUT_S = 900  # the chain's processes are killed, and the smoke fails, after this
# of the 6 scenes: stage 1 trained from flax's init finds boxes on all 6 (and
# on 8 of 8 in the 8-scene world); one scene of margin. From the earlier
# torch.Generator init it was 3 of 8.
CHAIN_MIN_SCENES_WITH_BOXES = 5
PACK_CROPS, PACK_TIMED_CROPS = 8, 256


def run_chain(work):
    """``python -m unmore_tpu_torch.scripts.scale_chain`` at :data:`CHAIN_ARGS`
    in its own process group, stopped at :data:`CHAIN_TIMEOUT_S`: SIGTERM
    (each CLI's supervisor then kills its child's session), SIGKILL to what
    is left 60 s later. Returns (exit code or None, seconds)."""
    import os
    import signal

    work.mkdir(parents=True)
    t0 = time.perf_counter()
    with open(work / "chain.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "unmore_tpu_torch.scripts.scale_chain", "--work", str(work),
                                 *CHAIN_ARGS], stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=CHAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
            os.killpg(proc.pid, signal.SIGTERM)
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=60)
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return rc, time.perf_counter() - t0


def chain_knobs(work):
    """The chain's parsed knobs (``scale_chain.Chain``) at :data:`CHAIN_ARGS`."""
    from unmore_tpu_torch.scripts import scale_chain

    return scale_chain.Chain(scale_chain.parse_args(["--work", str(work), *CHAIN_ARGS]))


def chain_contracts(work):
    """The files ``tests/test_scale_chain.py`` holds the JAX chain to: the
    missing or malformed ones."""
    a = chain_knobs(work).a
    world, disc = Path(a.synth), work / "results_reasoning" / a.run
    problems = [str(p) for p in (world / "coco" / "instances.json", world / "imagenet_training.json",
                                 disc / "discovery_results.json", work / "discovery_stats_r5.json",
                                 disc / "object_discovery_with_scores.json", work / "ap_score_pseudo.json",
                                 disc / "merged_with_imagenet" / "COCO_merged_IN_training_format.json",
                                 Path(a.cad_out) / f"model_{a.cad_iters:07d}.ckpt") if not p.is_file()]
    if problems:
        return problems
    if not isinstance(json.loads((disc / "discovery_results.json").read_text()), dict):
        problems.append("discovery_results.json is not a mapping")
    stats = json.loads((work / "discovery_stats_r5.json").read_text())["all"]
    if stats.get("images") != a.disc_scenes or not stats.get("seed_boxes_total"):
        problems.append(f"discovery stats {stats}")
    timings = (work / "scale_timings.txt").read_text()
    problems += [f"no {stage} start/done stamps" for stage in ("world", "stage1", "existence", "scoring", "cad")
                 if f"{stage} start" not in timings or f"{stage} done" not in timings]
    return problems


def chain_rerun(work, kernel_counters):
    """The first segment's discovery again, in this process, through the
    CLI's entry on the chain's two checkpoints: decode launches counted and
    each held against the plain version afterwards; the boxes against the
    chain's for those scenes."""
    from unmore_tpu_torch.cli import object_reasoning

    chain = chain_knobs(work)
    end = min(chain.a.seg, chain.a.disc_scenes)
    t0 = time.perf_counter()
    with record_decode(kernel_counters) as (calls, start), contextlib.chdir(work):
        object_reasoning.main(chain.discovery_argv(0, end) + ["--run_name", "rerun"])
    seconds = time.perf_counter() - t0
    launches = launch_counts(kernel_counters, since=start)
    errors = decode_errors(calls)  # outside the counted run
    n_calls = len(calls)
    del calls[:]
    ours = json.loads((work / "results_reasoning" / f"rerun_0_{end}" / "discovery_results.json").read_text())
    theirs = json.loads((work / "results_reasoning" / f"{chain.a.run}_0_{end}" / "discovery_results.json").read_text())
    return {"launches": launches, "recorded_calls": n_calls, "decode_max_abs_err": max(errors, default=None),
            "all_exact": bool(errors) and all(e == 0.0 for e in errors), "boxes_equal": ours == theirs,
            "images_with_boxes": len(ours), "scenes_with_boxes": sorted(ours), "seconds": seconds}


def launch_counts(kernel_counters, since=None):
    """Each kernel's launches as the port's tracer counts them
    (``kernel_counters``: kernel name -> its counter), less ``since``."""
    from unmore_tpu_torch.utils import tracing

    now = {name: tracing.counter(c) for name, c in kernel_counters.items()}
    return now if since is None else {name: n - since[name] for name, n in now.items()}


def record_decode(kernel_counters):
    """A context in which every decode call of an engine built inside it is
    kept (inputs and outputs): yields the list of calls and the kernels'
    counts at its start."""
    from unmore_tpu_torch.reasoning import engine

    calls, real = [], engine.fused_center_decode

    def record(sdf, center, *args, **kwargs):  # an engine takes its decode when it is built
        out = real(sdf, center, *args, **kwargs)
        calls.append((sdf.clone(), center.clone(), [t.clone() for t in out]))
        return out

    @contextlib.contextmanager
    def recording():
        engine.fused_center_decode = record
        try:
            yield calls, launch_counts(kernel_counters)
        finally:
            engine.fused_center_decode = real

    return recording()


def decode_errors(calls):
    """Each recorded decode call against the plain version on its inputs
    (outside any counted run): the max abs errors of the scores; fails on a
    union or argmax that differs."""
    import torch

    from unmore_tpu_torch.ops.fields import center_singularity_scores

    errors = []
    for sdf, center, got in calls:
        want = center_singularity_scores(sdf, center)
        pos = want[0] > 1e-4
        if not (torch.equal(got[2], want[2]) and torch.equal(got[1][pos], want[1][pos])):
            fail("the decode kernel's union or argmax differs from the plain version on the chain's discovery")
        errors.append(float((got[0] - want[0]).abs().max()))
    return errors


def ab_rerun(work, kernel_counters):
    """The sticky A/B's ``reference_rounds`` leg again, in this process,
    through the script's entry on the chain's two checkpoints: decode
    launches counted and each held against the plain version afterwards;
    the leg's crops, annotations and AP figures against the chain's."""
    from unmore_tpu_torch.scripts import sticky_ab

    chain = chain_knobs(work)
    out = work / "sticky_ab_rerun.json"
    t0 = time.perf_counter()
    with record_decode(kernel_counters) as (calls, start):
        sticky_ab.main(chain.ab_argv() + ["--modes", "reference_rounds", "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = launch_counts(kernel_counters, since=start)
    errors = decode_errors(calls)
    n_calls = len(calls)
    del calls[:]
    keys = ("boundary_crops", "n_annotations", *sticky_ab.AP_KEYS)
    ours = json.loads(out.read_text())["reference_rounds"]
    theirs = json.loads((work / "sticky_ab_results.json").read_text())["reference_rounds"]
    return {"launches": launches, "recorded_calls": n_calls, "decode_max_abs_err": max(errors, default=None),
            "all_exact": bool(errors) and all(e == 0.0 for e in errors),
            "leg_equal": all(ours[k] == theirs[k] for k in keys), "leg": {k: ours[k] for k in keys},
            "discovery_wall_s": ours["discovery_wall_s"], "seconds": seconds}


def ab_figures(report):
    """The A/B sections of the chain's report, as the phase prints them."""
    ma, sticky = report.get("max_active_ab") or {}, report.get("sticky_ab_dense") or {}
    legs = {}
    for name, leg in (("main", ma.get("main")), ("truncated", ma.get("truncated")),
                      ("sticky", sticky.get("sticky")), ("reference_rounds", sticky.get("reference_rounds"))):
        if leg:
            legs[name] = {k: leg.get(k) for k in ("bbox_AP", "bbox_AP50", "segm_AP", "segm_AP50", "n_annotations",
                                                  "boundary_crops", "discovery_wall_s", "active_overflow",
                                                  "max_active") if k in leg}
    return {"legs": legs, "delta_main_minus_truncated": ma.get("delta_main_minus_truncated"),
            "sticky_delta": sticky.get("delta"), "sticky_ab_stale": report.get("sticky_ab_stale")}


def ab_problems(report):
    problems = []
    failed = [s for s in report.get("failed_steps", []) if s.endswith("_ab")]
    if failed:
        problems.append(f"failed A/B steps {failed}")
    ma = report.get("max_active_ab") or {}
    if not (ma.get("main") and ma.get("truncated")):
        problems.append("the report has no max_active_ab with both legs")
    sticky = report.get("sticky_ab_dense")
    if sticky is None:
        problems.append(f"sticky_ab_dense is None: {report.get('sticky_ab_stale', {}).get('reason')}")
    elif not sticky["delta"]["boundary_crop_ratio"] >= 1:
        problems.append(f"sticky boundary_crop_ratio {sticky['delta']['boundary_crop_ratio']} < 1")
    return problems


def vit_pack_check(device):
    """DPT-Large (seeded random weights) with two crops a packed ViT sequence
    against one: the f32 forward on :data:`PACK_CROPS` crops (max abs
    difference, bound 1e-4) and the bf16 forward's ms on a
    :data:`PACK_TIMED_CROPS`-crop chunk, each way, in one call."""
    import torch

    from unmore_tpu_torch.cli.common import build_objectness, init_random_variables

    model = build_objectness(DptLarge, "float32", device)
    init_random_variables(model, seed=0)
    crops = torch.rand(PACK_CROPS, 128, 128, 3, generator=torch.Generator().manual_seed(0)).to(device)
    outs = {}
    with torch.inference_mode():
        for pack in (1, 2):
            model.backbone.vit_pack = pack
            outs[pack] = model(crops)
    diff = max(float((outs[2][k] - outs[1][k]).abs().max()) for k in outs[1])
    model.to(torch.bfloat16)
    chunk = torch.rand(PACK_TIMED_CROPS, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(device)
    ms = {}
    for pack in (1, 2, 2, 1):  # in turns
        model.backbone.vit_pack = pack

        def forward():
            with torch.inference_mode():
                model(chunk)

        ms.setdefault(f"pack{pack}", []).append(time_ms(forward, iters=5, warmup=2))
    del model
    torch.cuda.empty_cache()
    return {"f32_max_abs_diff": diff, "bound": 1e-4, "bf16_chunk_ms": ms, "chunk_crops": PACK_TIMED_CROPS}


def phase_chain(device, kernel_counters):
    import shutil

    import torch

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shutil.rmtree(CHAIN_FOLDER, ignore_errors=True)
    rc, chain_s = run_chain(CHAIN_FOLDER)
    failed = CHAIN_FOLDER / "failed_steps.txt"
    if rc != 0 or failed.exists():
        steps = failed.read_text().split() if failed.exists() else []
        for step in steps or ["chain"]:
            log = CHAIN_FOLDER / (f"{step}.log" if steps else "chain.log")
            print(f"--- {log}:\n" + (log.read_text()[-4000:] if log.exists() else "(none)"), flush=True)
        fail(f"phase chain: the chain exited {rc} after {chain_s:.1f} s, failed steps {steps}")
    row = chain_checks(CHAIN_FOLDER, device, kernel_counters)
    emit({"phase": "chain", "chain_s": chain_s, **row, "phase_s": time.perf_counter() - t_phase})
    if row["checks_failed"]:
        fail(f"phase chain: {row['checks_failed']}")
    shutil.rmtree(CHAIN_FOLDER)
    return {"chain": row["rerun"]["launches"]["fused_center_decode"],
            "sticky_ab": row["ab_rerun"]["launches"]["fused_center_decode"]}


def chain_checks(work, device, kernel_counters):
    """Phase chain's checks and figures on the chain run in ``work``."""
    a = chain_knobs(work).a
    problems = chain_contracts(work)
    report = json.loads((work / "scale_report.json").read_text())
    found = json.loads((work / "results_reasoning" / a.run / "discovery_results.json").read_text())
    if len(found) < CHAIN_MIN_SCENES_WITH_BOXES:
        problems.append(f"discovery found boxes on {len(found)} of {a.disc_scenes} scenes")
    problems += ab_problems(report)
    rerun = chain_rerun(work, kernel_counters)
    ab = ab_rerun(work, kernel_counters)
    for what, run in (("discovery", rerun), ("sticky A/B", ab)):
        n = run["launches"]["fused_center_decode"]
        if not n or run["recorded_calls"] != n:
            problems.append(f"{what}: decode launches {run['launches']} against {run['recorded_calls']} recorded calls")
        if not run["all_exact"]:
            problems.append(f"{what}: a decode launch differs from the plain version by {run['decode_max_abs_err']}")
    if not rerun["boxes_equal"]:
        problems.append("the in-process discovery's boxes differ from the chain's discovery_results.json")
    if not ab["leg_equal"]:
        problems.append(f"the in-process reference_rounds leg {ab['leg']} differs from the chain's")
    pack = vit_pack_check(device)
    if not pack["f32_max_abs_diff"] <= pack["bound"]:
        problems.append(f"vit_pack 2 differs from 1 by {pack['f32_max_abs_diff']}")
    gt = json.loads((Path(a.synth) / "coco" / "instances.json").read_text())
    ap = report.get("pseudo_label_ap", {})
    return {"stage_wall_s": report["stage_wall_s"],
            "objects_per_scene": [sum(x["image_id"] == im["id"] for x in gt["annotations"]) for im in gt["images"]],
            "scenes_with_boxes": len(found), "boxes": sum(len(v) for v in found.values()),
            "discovery_images_per_sec": report.get("discovery", {}).get("images_per_sec"),
            "discovery": report.get("discovery", {}).get("all"), "scoring": report.get("scoring"),
            "pseudo_label_ap": {t: {k: ap.get(t, {}).get(k) for k in ("AP", "AP50")} for t in ("bbox", "segm")},
            "cad_train": report.get("cad_train"), "cad_final_eval": report.get("cad_final_eval"),
            "supervisor_events": report.get("supervisor_events"), "ab": ab_figures(report), "rerun": rerun,
            "ab_rerun": ab, "vit_pack": pack, "checks_failed": problems}


# ------------------------------------------------------------------ phase 12
PARITY_FOLDER = Path("build") / "smoke_parity"
PARITY_TOL = 1e-3
PARITY_TAPS = tuple(f"layer{n}_rn" for n in range(1, 5)) + tuple(f"refinenet{n}" for n in range(1, 5))


def parity_fixture(folder):
    """DPT-Large (tanh, bg-sdf) and the ResNet-50 classifier with seeded
    random weights, saved as reference ``.ckpt`` files, and the dump of two
    128^2 crops through their f32 forward on the CPU with hooks at the
    reference's taps, in the dump's NCHW layout. Returns the objectness
    state_dict."""
    import numpy as np
    import torch

    from unmore_tpu_torch.cli.common import build_classifier, build_objectness, init_random_variables

    objectness = build_objectness(DptLarge, "float32", "cpu")
    classifier = build_classifier("float32", "cpu")
    init_random_variables(objectness, classifier, seed=12)
    crops = np.random.RandomState(12).rand(2, 128, 128, 3).astype(np.float32)
    taps, hooks = {}, []
    for name in PARITY_TAPS:
        def keep(_module, _inputs, out, name=name):
            taps[name] = out.numpy()

        hooks.append(getattr(objectness.backbone.scratch, name).register_forward_hook(keep))
    with torch.no_grad():
        out = objectness(torch.from_numpy(crops))
        existence = classifier(torch.from_numpy(crops)).numpy()
    for h in hooks:
        h.remove()
    folder.mkdir(parents=True)
    np.savez(folder / "ref.npz", input=crops.transpose(0, 3, 1, 2),
             center_fields=out["center_fields"].numpy().transpose(0, 3, 1, 2),
             sdf_maps=out["sdf_maps"].numpy()[:, None], existence=existence, **taps)
    torch.save({"model_state_dict": objectness.state_dict()}, folder / "objectness.ckpt")
    torch.save({"model_state_dict": classifier.state_dict()}, folder / "classifier.ckpt")
    return objectness.state_dict()


def run_check_parity(folder, objectness_ckpt):
    """``python -m unmore_tpu_torch.scripts.check_parity`` on the card: (exit
    code, stdout, max abs difference by tap)."""
    out = subprocess.run([sys.executable, "-m", "unmore_tpu_torch.scripts.check_parity", "--npz",
                          str(folder / "ref.npz"), "--objectness_ckpt", str(objectness_ckpt), "--classifier_ckpt",
                          str(folder / "classifier.ckpt"), "--tol", str(PARITY_TOL)],
                         capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
    diffs = {m.group(1): float(m.group(2)) for m in re.finditer(r"^\s*(\w+)\s+max\|d\|=(\S+)", out.stdout, re.M)}
    return out.returncode, out.stdout + out.stderr[-3000:], diffs


def phase_parity():
    import shutil

    import torch

    t_phase = time.perf_counter()
    shutil.rmtree(PARITY_FOLDER, ignore_errors=True)
    sd = parity_fixture(PARITY_FOLDER)
    rc, log, diffs = run_check_parity(PARITY_FOLDER, PARITY_FOLDER / "objectness.ckpt")
    key = next(k for k in sd if k.endswith("weight") and "scratch" in k)
    torch.save({"model_state_dict": {**sd, key: sd[key] + 0.05}}, PARITY_FOLDER / "perturbed.ckpt")
    del sd
    rc_bad, log_bad, diffs_bad = run_check_parity(PARITY_FOLDER, PARITY_FOLDER / "perturbed.ckpt")
    problems = []
    if rc != 0 or "PARITY OK" not in log:
        problems.append(f"matching weights: exit {rc}\n{log[-3000:]}")
    if set(diffs) != {"center_fields", "sdf_maps", "existence", *PARITY_TAPS}:
        problems.append(f"compared {sorted(diffs)}")
    if rc_bad != 1 or "PARITY FAIL" not in log_bad:
        problems.append(f"perturbed {key}: exit {rc_bad}\n{log_bad[-3000:]}")
    emit({"phase": "parity", "tol": PARITY_TOL, "max_abs_diff": diffs, "exit": rc, "perturbed": key,
          "perturbed_exit": rc_bad, "perturbed_max_abs_diff": diffs_bad, "checks_failed": problems,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail(f"phase parity: {problems}")
    shutil.rmtree(PARITY_FOLDER)


# ------------------------------------------------------------------ phase 13
INIT_ULP = 2  # card against CPU, each element of a random leaf (the tests' bound against JAX)


def init_pair(name, build, init, device):
    """Build the models of ``build(device)`` in f32 on the card and on the
    CPU and draw both with ``init``: each side's wall seconds, and every
    state leaf of the card's models held against the CPU's."""
    import numpy as np
    import torch

    walls = {}
    states = {}
    for side, where, draws in (("card", device, 2), ("cpu", torch.device("cpu"), 1)):  # the 2nd draw is warm
        models = build(where)
        for _ in range(draws):
            if where.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            init(*models)
            if where.type == "cuda":
                torch.cuda.synchronize()
            walls.setdefault(side, []).append(time.perf_counter() - t0)
        states[side] = {f"{i}.{k}": v for i, m in enumerate(models) for k, v in m.state_dict().items()}
        del models
    card, cpu = states["card"], states["cpu"]
    n, equal, worst, constant, random_leaves = 0, 0, 0, 0, 0
    for key, want in cpu.items():
        got = card[key].cpu()
        if not want.is_floating_point():
            if not torch.equal(got, want):
                fail(f"init {name}: {key} differs between the card and the CPU")
            continue
        if torch.equal(got.view(torch.int32), want.view(torch.int32)):
            ulp = np.zeros(want.numel(), np.int64)
        else:  # float32 units in the last place, over signed zero too
            w = want.numpy().view(np.int32).astype(np.int64)
            g = got.numpy().view(np.int32).astype(np.int64)
            w, g = (np.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (w, g))
            ulp = np.abs(w - g)
        flat = want.reshape(-1)
        if bool((flat == flat[0]).all()) and float(flat[0]) in (0.0, 1.0):  # a zero or one leaf: exact
            constant += 1
            if ulp.any():
                fail(f"init {name}: the constant leaf {key} differs between the card and the CPU")
        else:
            random_leaves += 1
        n += ulp.size
        equal += int((ulp == 0).sum())
        worst = max(worst, int(ulp.max(initial=0)))
    if worst > INIT_ULP:
        fail(f"init {name}: card and CPU draws differ by {worst} ulp (bound {INIT_ULP})")
    return {"models": name, "card_wall_s": walls["card"], "cpu_wall_s": walls["cpu"][0],
            "cpu_threads": torch.get_num_threads(), "elements": n, "random_leaves": random_leaves,
            "constant_leaves": constant, "max_ulp": worst, "bit_equal_share": equal / n}


def phase_init(device):
    """flax's seeded init (``models/flax_init.py``) of the stage-2 models,
    of ``dpt_hybrid`` and of the CAD, drawn on the card (twice: cold, then
    warm) and on the CPU from seed 0."""
    from unmore_tpu_torch.cli import train_net
    from unmore_tpu_torch.cli.common import build_classifier, build_objectness, init_random_variables
    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN
    from unmore_tpu_torch.train.optim import init_like_flax

    t0 = time.perf_counter()
    args = train_net.parse_args(["--config-file", CAD_CONFIG, "--eval-only"])
    det_cfg = train_net.build_from_config(args)[0]
    rows = [
        init_pair("dpt_large+resnet50", lambda d: (build_objectness(DptLarge, "float32", d),
                                                   build_classifier("float32", d)),
                  lambda *m: init_random_variables(*m, seed=0), device),
        init_pair("dpt_hybrid", lambda d: (build_objectness(DptHybrid, "float32", d),),
                  lambda m: init_like_flax(m, 0), device),
        init_pair("cad", lambda d: (CascadeMaskRCNN(det_cfg).to(d),), lambda m: init_like_flax(m, 0), device),
    ]
    emit({"phase": "init", "seed": 0, "ulp_bound": INIT_ULP, "rows": rows, "phase_s": time.perf_counter() - t0})


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA card only")
    try:
        from unmore_tpu_torch.ops import cuda_build
    except ImportError as exc:
        fail(f"the port is not importable from here ({exc}); run from the repository root")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # f32 references mean f32: no TF32 in cuDNN convolutions or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD["nvidia_smi"] = smi
    t0 = time.perf_counter()
    log = cuda_build.build([*KERNEL_SOURCES, *HOST_SOURCES])
    emit({"phase": "build", "nvidia_smi": smi, "build_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines() if "Used" in ln or "spill" in ln]
                    for k, v in log.items()}})

    kernel_rows = phase_kernel(device)
    counters = {"fused_center_decode": DECODE_LAUNCHES}
    main_path = phase_main_path(device, counters)
    launches, chunk_row = main_path["launches"], main_path["chunk_row"]
    phase_scoring(device, main_path)
    bf16 = phase_bf16(device, main_path["objectness"], main_path["images"])
    del main_path["objectness"], main_path["fns"]
    torch.cuda.empty_cache()
    phase_train(device)
    phase_cad(device, smi)
    phase_cad_train(device, smi)
    hybrid_launches = phase_hybrid(device, counters, main_path["results"], bf16)
    dist_launches = phase_dist(device, main_path["cuts"]["center_score_max_thres"])
    chain_launches = phase_chain(device, counters)
    phase_parity()
    phase_init(device)

    main_row = kernel_rows["random_256"]
    emit({"kernels": [{
        "name": "fused_center_decode", "route": "cuda", "source": KERNEL_SOURCES["decode"],
        "replaces": replaces_of(KERNEL_SOURCES["decode"]),
        "launches": launches["fused_center_decode"] + hybrid_launches["fused_center_decode"]
        + sum(dist_launches.values()) + sum(chain_launches.values()),
        "launches_by_path": {"dpt_large": launches["fused_center_decode"],
                             "dpt_hybrid": hybrid_launches["fused_center_decode"],
                             **{f"dist_{k}": v for k, v in dist_launches.items()}, **chain_launches},
        "max_abs_err": max(r["max_abs_err"] for r in (*kernel_rows.values(), chunk_row)),
        "ms": main_row["ms"], "device_ms": main_row["device_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"], "library_ms": None,
        "main_path_chunk": {k: chunk_row[k] for k in ("shape", "ms", "device_ms", "bound_ms")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
