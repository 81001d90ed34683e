"""Box transforms, matching and sampling for the detector (port of
``detector/box_ops.py``).

detectron2 conventions, so that converted weights see the same boxes:
Box2BoxTransform deltas (dx, dy, dw, dh) with per-stage weights and
``scale_clamp = log(1000/16)``, the xyxy IoU matrix, smooth-L1, the
thresholded Matcher and the fg/bg subsampler. The matcher and the sampler
take a leading batch axis, where the JAX package ``vmap``s one image.

Division by the delta weights goes through a tensor on the boxes' device:
CUDA divides by a Python scalar as a multiply by its reciprocal, one ulp off
the CPU (and the JAX package) for 10, 20 and 30; a divide by a device
tensor is a true division on every device.
"""

from __future__ import annotations

import math

import torch

SCALE_CLAMP = math.log(1000.0 / 16)


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] for xyxy boxes [..., N, 4] and [..., M, 4]
    (zero for empty boxes)."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype, device=inter.device))


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or a tuple) as a tensor of ``like``'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def encode_deltas(src: torch.Tensor, target: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(dx, dy, dw, dh) taking src boxes to target boxes (both xyxy)."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    eps = 1e-7
    return torch.stack(
        [
            wx * (tcx - scx) / sw.clamp(min=eps),
            wy * (tcy - scy) / sh.clamp(min=eps),
            ww * torch.log(tw.clamp(min=eps) / sw.clamp(min=eps)),
            wh * torch.log(th.clamp(min=eps) / sh.clamp(min=eps)),
        ],
        dim=-1,
    )


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to xyxy boxes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    d = deltas / _const(weights, deltas)
    dw = d[..., 2].clamp(max=SCALE_CLAMP)
    dh = d[..., 3].clamp(max=SCALE_CLAMP)
    ncx = d[..., 0] * w + cx
    ncy = d[..., 1] * h + cy
    nw = torch.exp(dw) * w
    nh = torch.exp(dh) * h
    return torch.stack([ncx - 0.5 * nw, ncy - 0.5 * nh, ncx + 0.5 * nw, ncy + 0.5 * nh], dim=-1)


def clip_boxes(boxes: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """Clip xyxy boxes [..., N, 4] to [0, w] x [0, h]; ``hw`` is [2] or one
    (h, w) per leading index of the boxes ([..., 2])."""
    h, w = hw[..., 0], hw[..., 1]
    while h.dim() < boxes.dim() - 1:
        h, w = h.unsqueeze(-1), w.unsqueeze(-1)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.stack(
        [
            torch.minimum(torch.maximum(boxes[..., 0], zero), w),
            torch.minimum(torch.maximum(boxes[..., 1], zero), h),
            torch.minimum(torch.maximum(boxes[..., 2], zero), w),
            torch.minimum(torch.maximum(boxes[..., 3], zero), h),
        ],
        dim=-1,
    )


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    diff = (pred - target).abs()
    if beta <= 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff**2 / _const(beta, diff), diff - 0.5 * beta)


def match_proposals(iou: torch.Tensor, thresholds: tuple, labels: tuple, allow_low_quality: bool = False):
    """detectron2 Matcher of a batch: iou [B, G, P] -> (matched_idx [B, P]
    int64, match_labels [B, P] int64; 1 fg, 0 bg, -1 ignore). Thresholds and
    labels are e.g. ((0.3, 0.7), (0, -1, 1)) for the RPN, ((0.5,), (0, 1))
    for the ROI heads. A column with no GT overlap (padding GTs have IoU 0)
    matches bg; the first GT of the largest IoU wins. ``allow_low_quality``
    forces each GT's best-overlapping proposals (every tie) to fg."""
    B, G, P = iou.shape
    dev = iou.device
    if G:
        vals, idx = iou.max(dim=1)
    else:
        vals, idx = iou.new_zeros((B, P)), torch.zeros((B, P), dtype=torch.int64, device=dev)
    bounds = (float("-inf"),) + tuple(thresholds) + (float("inf"),)
    match_labels = torch.full((B, P), labels[0], dtype=torch.int64, device=dev)
    for lo, hi, lab in zip(bounds[:-1], bounds[1:], labels):
        # thresholds as float32 tensors, as the JAX package compares them
        sel = (vals >= _const(lo, vals)) & (vals < _const(hi, vals))
        match_labels = torch.where(sel, torch.full_like(match_labels, lab), match_labels)
    if allow_low_quality and G:
        best_per_gt = iou.amax(dim=2, keepdim=True)  # [B, G, 1]
        forced = ((iou == best_per_gt) & (best_per_gt > 0)).any(dim=1)
        match_labels = torch.where(forced, torch.ones_like(match_labels), match_labels)
    return idx, match_labels


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """The rank of each entry of ``key`` [B, P] along P in a stable
    ascending sort (``argsort(argsort(key))``, with one sort)."""
    order = torch.argsort(key, dim=1, stable=True)
    ranks = torch.empty_like(order)
    return ranks.scatter_(1, order, torch.arange(key.shape[1], device=key.device).expand_as(order))


def subsample_labels(match_labels: torch.Tensor, num_samples: int, positive_fraction: float, uniform: torch.Tensor):
    """Random fg/bg subsampling of a batch (detectron2 ``subsample_labels``
    with exact count caps): match_labels [B, P], ``uniform`` [B, P] draws in
    [0, 1). Positives are ranked by their draw and the first
    min(#pos, num_samples * positive_fraction) kept; negatives fill the rest
    of ``num_samples`` likewise. Ties (the 2.0 of every other entry) break by
    index, as the JAX package's stable sort does. Returns (sampled [B, P]
    float32, sampled fg [B, P] bool)."""
    pos = match_labels == 1
    neg = match_labels == 0
    two = _const(2.0, uniform)
    n_pos = pos.sum(dim=1, keepdim=True).clamp(max=int(num_samples * positive_fraction))
    pos_sampled = pos & (_ranks(torch.where(pos, uniform, two)) < n_pos)
    neg_sampled = neg & (_ranks(torch.where(neg, uniform, two)) < num_samples - n_pos)
    return (pos_sampled | neg_sampled).float(), pos_sampled
