"""Greedy NMS over a fixed lattice with a validity mask (port of ``ops/nms.py``).

Frontier-confirmation rounds, each decided over the [N, N] threat matrix:
SUPPRESS every undecided box that a kept box overlaps beyond the threshold;
KEEP every undecided box whose possible suppressors (earlier rank, overlap
beyond the threshold) are all suppressed. The top undecided box is always
decided, so the loop ends, and each decision equals the sequential greedy
outcome. Ties in score break by input index (stable sort); padding slots
are never kept and never suppress.

Inputs with a leading axis ([L, N, 4]) run L independent NMS problems in
the same rounds, one threat matrix per row, until every row is decided:
each round costs one host sync, so the detector's levels and images share
them. ``nms_mask.rounds`` counts the rounds run, as the kernels count
their launches.
"""

from __future__ import annotations

import torch


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] of xyxy boxes [..., N, 4] and [..., M, 4]."""
    ax1, ay1, ax2, ay2 = (boxes_a[..., i : i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (boxes_b[..., None, :, i] for i in range(4))
    ix1 = torch.maximum(ax1, bx1)
    iy1 = torch.maximum(ay1, by1)
    ix2 = torch.minimum(ax2, bx2)
    iy2 = torch.minimum(ay2, by2)
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros((), device=inter.device))


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS; returns a bool keep-mask aligned with the input order.

    boxes [N, 4] xyxy; scores [N]; valid [N] bool; or [L, N, 4], [L, N],
    [L, N] for L problems at once (the same keep-masks as L calls).
    """
    if boxes.dim() == 2:
        return nms_mask(boxes[None], scores[None], valid[None], iou_threshold)[0]
    L, n = boxes.shape[:2]
    dev = boxes.device
    key = torch.where(valid, -scores.float(), torch.full((), float("inf"), device=dev))
    order = torch.argsort(key, dim=1, stable=True)
    sorted_boxes = torch.gather(boxes.float(), 1, order[..., None].expand(L, n, 4))
    sorted_valid = torch.gather(valid, 1, order)
    rank = torch.arange(n, device=dev)
    earlier = rank[:, None] < rank[None, :]  # j earlier than i
    # threat[l, j, i]: earlier valid box j can suppress i
    threat = (pairwise_iou(sorted_boxes, sorted_boxes) > iou_threshold) & earlier & sorted_valid[..., None]
    kept = torch.zeros((L, n), dtype=torch.bool, device=dev)
    suppressed = torch.zeros_like(kept)
    while True:
        undecided = sorted_valid & ~kept & ~suppressed
        nms_mask.rounds += 1
        if not bool(undecided.any()):
            break
        by_kept = (threat & kept[..., None]).any(dim=1)
        live_threat = (threat & ~suppressed[..., None]).any(dim=1)
        suppressed = suppressed | (undecided & by_kept)
        kept = kept | (undecided & ~by_kept & ~live_threat)
    out = torch.zeros((L, n), dtype=torch.bool, device=dev)
    out.scatter_(1, order, kept)
    return out


nms_mask.rounds = 0
