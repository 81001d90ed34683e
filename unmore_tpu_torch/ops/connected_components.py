"""Connected-component labelling of a batch of masks (port of
``ops/connected_components.py``).

8-connected min-label propagation with pointer jumping, run on the whole
``[B, H, W]`` batch at once. A mask whose labels stopped changing is a fixed
point of a round, so running more rounds for the rest of the batch leaves
it as it is, and ``max_iters`` still caps the rounds each mask gets: the
labels equal those of labelling each mask on its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unmore_tpu_torch.utils import tracing

BIG = 2**30


def _min_pool_8(labels: torch.Tensor) -> torch.Tensor:
    """Min over the 3x3 neighbourhood, edge-padded with BIG. labels [B, H, W]."""
    h, w = labels.shape[-2:]
    padded = F.pad(labels, (1, 1, 1, 1), value=BIG)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, padded[:, dy : dy + h, dx : dx + w])
    return out


def label_components(masks: torch.Tensor, max_iters: int = 1024) -> torch.Tensor:
    """masks [B, H, W] (0/1) -> int32 labels: background holds BIG, each
    component holds the smallest linear index of its pixels."""
    B, h, w = masks.shape
    fg = masks > 0
    idx = torch.arange(h * w, dtype=torch.int32, device=masks.device).reshape(1, h, w)
    big = torch.full((), BIG, dtype=torch.int32, device=masks.device)
    labels = torch.where(fg, idx, big)
    for _ in range(max_iters):
        prop = torch.where(fg, _min_pool_8(labels), big)
        # pointer jumping: hop to the label's label to collapse chains fast
        flat = prop.reshape(B, h * w)
        hop = torch.gather(flat, 1, flat.clamp(0, h * w - 1).long()).reshape(B, h, w)
        new = torch.minimum(prop, torch.where(prop < BIG, hop, big))
        changed = tracing.read("cc.changed", bool, (new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def component_boxes(labels: torch.Tensor, max_components: int = 16):
    """Per-component tight boxes of a batch of label maps.

    labels [B, H, W] from :func:`label_components`. Returns (boxes [B, C, 4]
    xyxy f32 with x2/y2 exclusive, valid [B, C] bool, count [B] int32),
    components in ascending label order. Beyond ``max_components`` the
    largest-label components are dropped; as in the JAX package, ``count``
    counts the emitted components only, so it never exceeds C.
    """
    B, h, w = labels.shape
    dev = labels.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    big_f = torch.full((), 1e9, device=dev)
    remaining = labels
    boxes, valid = [], []
    for _ in range(max_components):
        cur = remaining.reshape(B, -1).amin(dim=1)
        found = cur < BIG
        sel = remaining == cur[:, None, None]
        x1 = torch.where(sel, xx, big_f).amin(dim=(1, 2))
        y1 = torch.where(sel, yy, big_f).amin(dim=(1, 2))
        x2 = torch.where(sel, xx, -big_f).amax(dim=(1, 2)) + 1.0
        y2 = torch.where(sel, yy, -big_f).amax(dim=(1, 2)) + 1.0
        box = torch.stack([x1, y1, x2, y2], dim=-1)
        boxes.append(torch.where(found[:, None], box, torch.zeros_like(box)))
        valid.append(found)
        remaining = torch.where(sel, torch.full((), BIG, dtype=labels.dtype, device=dev), remaining)
    valid_t = torch.stack(valid, dim=1)
    return torch.stack(boxes, dim=1), valid_t, valid_t.sum(dim=1, dtype=torch.int32)
