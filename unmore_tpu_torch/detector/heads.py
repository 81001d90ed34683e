"""Cascade box heads, the mask head and the CAD loss stack (port of
``detector/heads.py``).

The box head flattens its pooled [N, 7, 7, C] features in HWC order, the
JAX package's, so ``fc1`` holds the flax kernel transposed; a detectron2
``fc1`` (CHW order) is permuted once by
:func:`~unmore_tpu_torch.detector.convert.d2_to_state_dict`. The deconv is
``ConvTranspose2d``, which flax's ``ConvTranspose(transpose_kernel=True)``
reproduces. Both heads return float32.

The losses are the reference's, as masked fixed-shape functions of a batch
([B, P] lattices), each returning one value per image [B]: soft-target
cross-entropy (``cad/modeling/roi_heads/fast_rcnn.py:365-382``), DropLoss
weights (``custom_cascade_rcnn.py:196-231``), score-weighted box regression
(``box_regression.py:14-78``) and the score-weighted mask BCE
(``roi_heads.py:1043-1044``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.detector.box_ops import encode_deltas, match_proposals, pairwise_iou_xyxy, smooth_l1, \
    subsample_labels

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)


class BoxHead(nn.Module):
    """2-FC head + class scores (K+1) + class-agnostic box deltas."""

    def __init__(self, in_channels: int = 256, pooled: int = 7, num_classes: int = 1, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(pooled * pooled * in_channels, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, 4)

    def forward(self, pooled: torch.Tensor):  # [N, 7, 7, C]
        x = pooled.reshape(pooled.shape[0], -1).to(self.fc1.weight.dtype)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """4x conv3x3(256) + x2 deconv + 1x1 -> per-class mask logits."""

    def __init__(self, in_channels: int = 256, num_classes: int = 1, conv_dim: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}", nn.Conv2d(in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:  # [N, 14, 14, C] -> [N, 28, 28, K] f32
        x = pooled.permute(0, 3, 1, 2).to(self.deconv.weight.dtype)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).permute(0, 2, 3, 1).float()


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, ...] at idx [B, P] -> [B, P, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:]))


# ------------------------------------------------------------------ matching
def match_and_label(proposals, prop_valid, gt_boxes, gt_scores, gt_valid, iou_thresh: float) -> dict:
    """Cascade-stage matching, no sampling: dict(matched_idx [B, P], fg [B, P]
    bool, gt_score [B, P], gt_box [B, P, 4]); bg and invalid proposals have
    fg False."""
    iou = pairwise_iou_xyxy(gt_boxes, proposals) * gt_valid[..., None]
    matched_idx, labels = match_proposals(iou, (iou_thresh,), (0, 1))
    fg = (labels == 1) & prop_valid & gt_valid.any(dim=1, keepdim=True)
    return {"matched_idx": matched_idx, "fg": fg, "gt_score": gather_rows(gt_scores, matched_idx),
            "gt_box": gather_rows(gt_boxes, matched_idx)}


def sample_stage0(proposals, prop_valid, gt_boxes, gt_scores, gt_valid, uniform, num_samples: int = 512,
                  positive_fraction: float = 0.25, iou_thresh: float = 0.5) -> dict:
    """Stage-0 label-and-sample (detectron2 ``label_and_sample_proposals``):
    the GT boxes appended to the proposals, matched at ``iou_thresh``,
    subsampled with ``uniform`` [B, P + G] to at most ``num_samples`` with at
    most ``positive_fraction`` fg, and compacted (stable, sampled first) into
    a [B, num_samples] lattice: dict(boxes, valid, fg, matched_idx, gt_score,
    gt_box)."""
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([prop_valid, gt_valid], dim=1)
    iou = pairwise_iou_xyxy(gt_boxes, all_boxes) * gt_valid[..., None]
    matched_idx, labels = match_proposals(iou, (iou_thresh,), (0, 1))
    ignore = torch.full_like(labels, -1)
    labels = torch.where(all_valid, labels, ignore)
    labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels,
                         torch.where(all_valid, torch.zeros_like(labels), ignore))
    sampled, fg = subsample_labels(labels, num_samples, positive_fraction, uniform)
    order = torch.argsort((sampled == 0).to(torch.uint8), dim=1, stable=True)[:, :num_samples]
    out = {"boxes": gather_rows(all_boxes, order), "valid": torch.gather(sampled, 1, order) > 0,
           "fg": torch.gather(fg, 1, order), "matched_idx": torch.gather(matched_idx, 1, order)}
    out["gt_score"] = gather_rows(gt_scores, out["matched_idx"])
    out["gt_box"] = gather_rows(gt_boxes, out["matched_idx"])
    return out


# -------------------------------------------------------------------- losses
def _per_image_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=1).float().clamp(min=1.0)


def softmax_ce_soft_targets(scores, fg, gt_score, weights, valid) -> torch.Tensor:
    """CE of scores [B, P, 2] (class 0 fg, class 1 bg) against the soft
    targets [fg_prob, 1 - fg_prob] (fg_prob the matched pseudo-label score on
    fg proposals, else 0), weighted by ``weights`` [B, P] (DropLoss), over the
    valid proposals; [B]."""
    fg_prob = torch.where(fg, gt_score, torch.zeros_like(gt_score))
    targets = torch.stack([fg_prob, 1.0 - fg_prob], dim=-1)
    ce = -(targets * torch.log_softmax(scores, dim=-1)).sum(dim=-1)
    return (ce * (weights * valid)).sum(dim=1) / _per_image_count(valid)


def soft_box_reg_loss(proposals, deltas, fg, gt_box, gt_score, valid, stage_weights) -> torch.Tensor:
    """Score-weighted L1 of the fg proposals' deltas, over the count of
    valid proposals; [B]."""
    target = encode_deltas(proposals, gt_box, weights=stage_weights)
    l1 = smooth_l1(deltas, target).sum(dim=-1)
    return (l1 * (fg.float() * gt_score)).sum(dim=1) / _per_image_count(valid)


def droploss_weights(pred_boxes, gt_boxes, gt_valid, is_single_object, iou_thresh: float = 0.01) -> torch.Tensor:
    """[B, P] weights: 1 where the predicted box overlaps some GT by more
    than ``iou_thresh``, else 0; 1 everywhere on single-object (ImageNet)
    images."""
    iou_max = (pairwise_iou_xyxy(gt_boxes, pred_boxes) * gt_valid[..., None]).amax(dim=1)
    w = (iou_max > torch.tensor(iou_thresh, dtype=iou_max.dtype, device=iou_max.device)).float()
    return torch.where(is_single_object[:, None] > 0, torch.ones_like(w), w)


def mask_loss_weighted(mask_logits, target_masks, fg, gt_score) -> torch.Tensor:
    """BCE with logits per fg instance (logits and targets [B, N, M, M]),
    weighted by its pseudo-label score, over the fg count; [B]."""
    x, y = mask_logits, target_masks
    bce = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    per_inst = bce.mean(dim=(2, 3))
    return (per_inst * (fg.float() * gt_score)).sum(dim=1) / _per_image_count(fg)


def crop_gt_mask_to_proposals(gt_roi_masks, gt_boxes, matched_idx, proposals, out_size: int = 28) -> torch.Tensor:
    """Mask targets [B, P, S, S]: each matched GT's box-frame mask
    (gt_roi_masks [B, G, R, R], float) resampled bilinearly over the
    proposal box; zero outside the GT's box frame."""
    R = gt_roi_masks.shape[-1]
    masks = gather_rows(gt_roi_masks, matched_idx)  # [B, P, R, R]
    boxes_g = gather_rows(gt_boxes, matched_idx)  # [B, P, 4]
    grid = torch.from_numpy((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) / np.float32(out_size))
    grid = grid.to(proposals.device)
    px = proposals[..., 0:1] + grid * (proposals[..., 2:3] - proposals[..., 0:1])  # [B, P, S]
    py = proposals[..., 1:2] + grid * (proposals[..., 3:4] - proposals[..., 1:2])
    gw = (boxes_g[..., 2:3] - boxes_g[..., 0:1]).clamp(min=1e-6)
    gh = (boxes_g[..., 3:4] - boxes_g[..., 1:2]).clamp(min=1e-6)
    ux = (px - boxes_g[..., 0:1]) / gw * R - 0.5
    uy = (py - boxes_g[..., 1:2]) / gh * R - 0.5
    x0, y0 = torch.floor(ux), torch.floor(uy)
    wx, wy = ux - x0, uy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    out = None
    for dy, wyv in ((0, 1 - wy), (1, wy)):
        for dx, wxv in ((0, 1 - wx), (1, wx)):
            xi, yi = x0 + dx, y0 + dy
            inb_x, inb_y = (xi >= 0) & (xi < R), (yi >= 0) & (yi < R)
            xc, yc = xi.clamp(0, R - 1), yi.clamp(0, R - 1)
            rows = torch.gather(masks, 2, yc[..., None].expand(-1, -1, -1, R))  # [B, P, S, R]
            vals = torch.gather(rows, 3, xc[:, :, None, :].expand(-1, -1, out_size, -1))  # [B, P, S, S]
            w = (wyv * inb_y)[..., :, None] * (wxv * inb_x)[..., None, :]
            term = vals * w
            out = term if out is None else out + term
    return out
