"""Region Proposal Network: head, losses and fixed-shape proposal generation
(port of ``detector/rpn.py``).

detectron2 RPN semantics at the CAD settings (pre-NMS top-k 2000 per level
in training and 1000 at test, NMS 0.65, post-NMS top 4000 / 1000) on static
shapes, for a batch at once: per level a fixed top-k, decode, clip and NMS;
then the top ``post_nms_topk`` of the kept boxes over all levels, padding
slots scoring -inf. :func:`rpn_losses` labels and samples every anchor of
every image, and normalizes each image's losses by its own sample count.

Two details are the JAX package's: the head's outputs are flattened in NHWC
order ([B, H*W*A], anchor fastest), the order of ``anchors.grid_anchors``;
and every top-k is a stable descending sort, so that equal scores (frequent
in bf16) take the lower index first, as ``jax.lax.top_k`` does. The NMS of
every (image, level) pair runs as one batched :func:`nms_mask` call.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.detector.box_ops import (
    clip_boxes, decode_deltas, encode_deltas, match_proposals, pairwise_iou_xyxy, smooth_l1, subsample_labels,
)
from unmore_tpu_torch.ops.nms import nms_mask


def stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    equal values by ascending index (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class RPNHead(nn.Module):
    """Shared 3x3 conv + per-anchor objectness and 4 deltas."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, conv_dim: int = 256):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, conv_dim, 3, padding=1)
        self.objectness_logits = nn.Conv2d(conv_dim, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(conv_dim, num_anchors * 4, 1)

    def forward(self, feats: dict) -> dict:
        """{level: [B, C, H, W]} -> {level: {"objectness": [B, H*W*A] f32,
        "deltas": [B, H*W*A, 4] f32}}."""
        out = {}
        for name, x in feats.items():
            t = F.relu(self.conv(x))
            B = t.shape[0]
            out[name] = {
                "objectness": self.objectness_logits(t).permute(0, 2, 3, 1).reshape(B, -1).float(),
                "deltas": self.anchor_deltas(t).permute(0, 2, 3, 1).reshape(B, -1, 4).float(),
            }
        return out


@torch.no_grad()
def rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """Anchor labels of a batch (IoU 0.3 / 0.7, every GT's best anchors
    forced fg): (matched GT index [B, A], labels [B, A]). An image with no
    valid GT has every anchor bg. The [G, A] IoU matrix is made one image at
    a time: at 1024^2 a batch's would take tens of GB."""
    idx, labels = zip(*(match_proposals(pairwise_iou_xyxy(gt_boxes[b], anchors)[None] * gt_valid[b, None, :, None],
                                        (0.3, 0.7), (0, -1, 1), allow_low_quality=True)
                        for b in range(gt_boxes.shape[0])))
    labels = torch.cat(labels)
    return torch.cat(idx), torch.where(gt_valid.any(dim=1, keepdim=True), labels, torch.zeros_like(labels))


def rpn_losses(anchors: torch.Tensor, objectness: torch.Tensor, deltas: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, uniform: torch.Tensor, batch_size_per_image: int = 256,
               positive_fraction: float = 0.5) -> dict:
    """Per-image RPN losses of a batch, each [B]: BCE over the sampled
    anchors and L1 (beta 0) over the sampled fg anchors, both divided by the
    image's sample count. anchors [A, 4]; objectness [B, A]; deltas [B, A, 4];
    gt_boxes [B, G, 4] with gt_valid [B, G]; ``uniform`` [B, A] the
    sampler's draws."""
    with torch.no_grad():
        matched_idx, labels = rpn_targets(anchors, gt_boxes, gt_valid)
        sampled, fg_sampled = subsample_labels(labels, batch_size_per_image, positive_fraction, uniform)
        num_sampled = sampled.sum(dim=1).clamp(min=1.0)
        labels01 = (labels == 1).float()
        matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
        target = encode_deltas(anchors, matched_gt)
    bce = objectness.clamp(min=0) - objectness * labels01 + torch.log1p(torch.exp(-objectness.abs()))
    l1 = smooth_l1(deltas, target).sum(dim=-1)
    return {"loss_rpn_cls": (bce * sampled).sum(dim=1) / num_sampled,
            "loss_rpn_loc": (l1 * fg_sampled).sum(dim=1) / num_sampled}


def generate_proposals(level_anchors, level_objectness, level_deltas, image_hw: torch.Tensor,
                       pre_nms_topk: int, post_nms_topk: int, nms_thresh: float = 0.65, min_size: float = 0.0):
    """Proposals of a batch, fixed shapes.

    level_anchors: per level [A_l, 4]; level_objectness [B, A_l]; level_deltas
    [B, A_l, 4]; image_hw [B, 2]. Returns (boxes [B, P, 4], scores [B, P],
    valid [B, P]) with P = min(post_nms_topk, sum of the per-level k).
    """
    all_boxes, all_scores, all_valid = [], [], []
    for anchors, obj, dels in zip(level_anchors, level_objectness, level_deltas):
        k = min(pre_nms_topk, obj.shape[1])
        scores, idx = stable_topk(obj, k)
        boxes = decode_deltas(torch.gather(dels, 1, idx[..., None].expand(-1, -1, 4)), anchors[idx])
        boxes = clip_boxes(boxes, image_hw)
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_valid.append((w > min_size) & (h > min_size) & torch.isfinite(scores))
    # one NMS over every (image, level) pair, each level padded to the
    # largest k with slots that are never kept and never suppress
    B, K = all_boxes[0].shape[0], max(b.shape[1] for b in all_boxes)

    def padded(xs, fill):
        out = xs[0].new_full((B, len(xs), K) + tuple(xs[0].shape[2:]), fill)
        for i, x in enumerate(xs):
            out[:, i, : x.shape[1]] = x
        return out

    keep = nms_mask(padded(all_boxes, 0.0).reshape(-1, K, 4), padded(all_scores, 0.0).reshape(-1, K),
                    padded(all_valid, False).reshape(-1, K), iou_threshold=nms_thresh).reshape(B, -1, K)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    keep = torch.cat([keep[:, i, : b.shape[1]] for i, b in enumerate(all_boxes)], dim=1)
    masked = torch.where(keep, scores, torch.full((), float("-inf"), device=scores.device))
    top_scores, top_idx = stable_topk(masked, min(post_nms_topk, boxes.shape[1]))
    out_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    out_valid = torch.isfinite(top_scores)
    return out_boxes, torch.where(out_valid, top_scores, torch.zeros((), device=scores.device)), out_valid
