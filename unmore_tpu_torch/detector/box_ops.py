"""Box transforms for the detector (port of ``detector/box_ops.py``, the
inference half).

detectron2 conventions, so that converted weights see the same boxes:
Box2BoxTransform deltas (dx, dy, dw, dh) with per-stage weights and
``scale_clamp = log(1000/16)``, and the xyxy IoU matrix.

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
    """IoU matrix [N, M] for xyxy boxes (zero for empty boxes)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype, device=inter.device))


def _divisor(weights, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(weights, dtype=like.dtype, device=like.device)


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
    d = deltas / _divisor(weights, deltas)
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
