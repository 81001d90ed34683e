"""Cascade Mask R-CNN, the CAD class-agnostic detector (port of
``detector/cascade_rcnn.py``).

R50-FPN trunk, RPN, three cascade box heads and the mask head, with the JAX
package's fixed shapes per image: a post-NMS proposal lattice (4000 in
training, 1000 at test), a 512-proposal sample per cascade stage in
training, and the top ``detections_per_image`` (100) detections. Where the
JAX package ``vmap``s one image's pipeline, this port runs the batch at
once: one RoIAlign gather per stage over every image's boxes, one batched
NMS over every (image, level) pair, one over every image at the end. The
training losses are still normalized per image and then averaged over the
batch, as the JAX package's ``vmap`` and mean do.

Module names follow the JAX package's parameter tree (``backbone``,
``rpn``, ``box_head0..2``, ``mask_head``); see ``detector/convert.py``.
Images arrive as uint8 NHWC canvases and are normalized on the device
(``/255``, then the ImageNet mean and std), in float32, then cast to the
model's dtype. Divisions by constants go through device tensors: on CUDA a
Python scalar divides as a multiply by its reciprocal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn as nn

from unmore_tpu_torch.detector import anchors as anchor_lib
from unmore_tpu_torch.detector.box_ops import clip_boxes, decode_deltas
from unmore_tpu_torch.detector.fpn import LEVELS, ResNetFPN
from unmore_tpu_torch.detector.heads import (
    CASCADE_IOUS, CASCADE_WEIGHTS, BoxHead, MaskHead, crop_gt_mask_to_proposals, droploss_weights, gather_rows,
    mask_loss_weighted, match_and_label, sample_stage0, soft_box_reg_loss, softmax_ce_soft_targets,
)
from unmore_tpu_torch.detector.roi_align import ROI_LEVELS, RoIFeatures
from unmore_tpu_torch.detector.rpn import RPNHead, generate_proposals, rpn_losses, stable_topk
from unmore_tpu_torch.ops.nms import nms_mask
from unmore_tpu_torch.utils import prng

PIXEL_MEAN = np.array([123.675, 116.280, 103.530], np.float32) / 255.0
PIXEL_STD = np.array([58.395, 57.120, 57.375], np.float32) / 255.0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """The JAX package's ``DetectorConfig`` (without its mesh and precision
    fields). ``use_soft_targets`` is read from the YAML and, as in the JAX
    package, consulted nowhere: the soft targets are always on."""

    num_classes: int = 1
    image_size: int = 1024  # square train/test canvas
    max_gt: int = 128
    gt_mask_res: int = 128  # box-frame GT mask resolution
    # RPN
    rpn_pre_nms_topk_train: int = 2000
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_train: int = 4000
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.65
    rpn_batch_per_image: int = 256
    # cascade
    stage_samples: int = 512
    positive_fraction: float = 0.25
    use_droploss: bool = True
    droploss_iou_thresh: float = 0.01
    use_soft_targets: bool = True
    mask_on: bool = True
    # test
    test_score_thresh: float = 0.0
    test_nms_thresh: float = 0.5
    detections_per_image: int = 100
    # model
    pooler_sampling: Any = 2  # per-bin samples; "adaptive" = d2's sampling_ratio 0
    remat_backbone: bool = True  # checkpoint the trunk's bottlenecks in training
    dtype: Any = torch.float32
    stage_blocks: tuple = (3, 4, 6, 3)


class CascadeMaskRCNN(nn.Module):
    """Parameter container; the pipeline lives in the functions below."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN(out_channels=256, stage_blocks=cfg.stage_blocks, remat=cfg.remat_backbone)
        self.rpn = RPNHead(num_anchors=3)
        for k in range(3):
            setattr(self, f"box_head{k}", BoxHead(num_classes=cfg.num_classes))
        self.mask_head = MaskHead(num_classes=cfg.num_classes)

    @property
    def box_heads(self):
        return [getattr(self, f"box_head{k}") for k in range(3)]

    def forward(self, images: torch.Tensor):
        """Backbone + RPN head on normalized NCHW images."""
        feats = self.backbone(images)
        return feats, self.rpn(feats)


def _const(value, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value), dtype=dtype).to(device)


def _mask_targets_float(gt_masks: torch.Tensor) -> torch.Tensor:
    """uint8 (0-255) soft mask targets -> [0, 1] float32; float passes."""
    if gt_masks.dtype == torch.uint8:
        return gt_masks.float() / _const(255.0, gt_masks.device)
    return gt_masks


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (or [0, 1] float) NHWC canvases -> normalized float32 NCHW."""
    dev = images.device
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / _const(255.0, dev)
    x = (x - _const(PIXEL_MEAN, dev)) / _const(PIXEL_STD, dev)
    return x.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=8)
def level_anchors(image_size: int, device: torch.device) -> tuple:
    """Per-level anchors [A_l, 4] of the square canvas, on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in anchor_lib.fpn_anchors(image_size))


def no_stage(name):
    return contextlib.nullcontext()


def _cascade(model, feats: RoIFeatures, boxes, image_hw, sampling):
    """The three box heads; returns (final boxes [B, P, 4], mean class
    probabilities [B, P, K+1])."""
    B, P = boxes.shape[:2]
    probs = None
    for k, head in enumerate(model.box_heads):
        pooled = feats.pool(boxes, 7, sampling)
        scores, deltas = head(pooled.reshape(B * P, *pooled.shape[2:]))
        p = torch.softmax(scores, dim=-1).reshape(B, P, -1)
        probs = p if probs is None else probs + p
        boxes = clip_boxes(decode_deltas(deltas.reshape(B, P, 4), boxes, weights=CASCADE_WEIGHTS[k]), image_hw)
    return boxes, probs / _const(3.0, probs.device)


def _masks(model, feats: RoIFeatures, boxes, sampling):
    B, D = boxes.shape[:2]
    pooled = feats.pool(boxes, 14, sampling)
    logits = model.mask_head(pooled.reshape(B * D, *pooled.shape[2:]))[..., 0]
    return torch.sigmoid(logits).reshape(B, D, *logits.shape[1:])


def backbone_features(model, images):
    """uint8 canvases -> (FPN features {P2..P6: NCHW}, :class:`RoIFeatures` of P2..P5)."""
    x = normalize(images).to(next(model.parameters()).dtype)
    feats = model.backbone(x)
    return feats, RoIFeatures({n: feats[n].permute(0, 2, 3, 1) for n in ROI_LEVELS})


@torch.inference_mode()
def detector_forward_inference(model: CascadeMaskRCNN, cfg: DetectorConfig, images: torch.Tensor,
                               image_hw: torch.Tensor, stage=no_stage) -> dict:
    """uint8 canvases [B, S, S, 3] and their content sizes image_hw [B, 2]
    (float32, on the model's device) -> dict(boxes [B, D, 4], scores [B, D],
    valid [B, D], masks [B, D, 28, 28] sigmoid probabilities in the box
    frame). ``stage(name)`` is a context manager around each part
    ("backbone", "rpn", "cascade", "mask"), for timing."""
    with stage("backbone"):
        feats, roi = backbone_features(model, images)
    with stage("rpn"):
        rpn_out = model.rpn(feats)
        proposals, _, p_valid = generate_proposals(
            level_anchors(cfg.image_size, images.device),
            [rpn_out[n]["objectness"] for n in LEVELS], [rpn_out[n]["deltas"] for n in LEVELS], image_hw,
            cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test, cfg.rpn_nms_thresh,
        )
    with stage("cascade"):
        boxes, probs = _cascade(model, roi, proposals, image_hw, cfg.pooler_sampling)
        fg_scores = probs[..., 0]  # single foreground class
        valid = p_valid & (fg_scores > cfg.test_score_thresh)
        keep = nms_mask(boxes, fg_scores, valid, iou_threshold=cfg.test_nms_thresh)
        masked = torch.where(keep, fg_scores, torch.full((), float("-inf"), device=fg_scores.device))
        top_scores, top_idx = stable_topk(masked, cfg.detections_per_image)
        det_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        det_valid = torch.isfinite(top_scores)
        out = {"boxes": det_boxes, "scores": torch.where(det_valid, top_scores, torch.zeros((), device=boxes.device)),
               "valid": det_valid}
    if cfg.mask_on:
        with stage("mask"):
            out["masks"] = _masks(model, roi, det_boxes, cfg.pooler_sampling)
    return out


@torch.inference_mode()
def detector_forward_with_boxes(model: CascadeMaskRCNN, cfg: DetectorConfig, images: torch.Tensor,
                                image_hw: torch.Tensor, boxes: torch.Tensor, boxes_valid: torch.Tensor) -> dict:
    """External-proposal inference: skip the RPN and run the cascade and the
    mask head on caller-given boxes [B, P, 4] (valid [B, P])."""
    _, roi = backbone_features(model, images)
    boxes_k, probs = _cascade(model, roi, boxes, image_hw, cfg.pooler_sampling)
    out = {"boxes": boxes_k, "scores": torch.where(boxes_valid, probs[..., 0], torch.zeros((), device=boxes.device)),
           "valid": boxes_valid}
    if cfg.mask_on:
        out["masks"] = _masks(model, roi, boxes_k, cfg.pooler_sampling)
    return out


def train_proposal_count(cfg: DetectorConfig) -> int:
    """The RPN's post-NMS lattice in training (before the GTs are appended)."""
    k = sum(min(cfg.rpn_pre_nms_topk_train, len(a)) for a in anchor_lib.fpn_anchors(cfg.image_size))
    return min(cfg.rpn_post_nms_topk_train, k)


def uniform_draws(cfg: DetectorConfig, step_key, batch_size: int, device, start: int = 0,
                  stop: int | None = None) -> dict:
    """The training forward's random draws in [0, 1) for images ``[start,
    stop)`` (default: all) of a global batch of ``batch_size``: "rpn"
    [images, anchors] for the anchor sampler, "stage0" [images, proposals +
    max_gt] for the stage-0 sampler. The JAX package's: image ``b`` takes
    rows ``2b`` and ``2b + 1`` of ``jax.random.split(step_key, 2 *
    batch_size)`` and draws ``jax.random.uniform`` under each; the rows are
    computed on ``device``."""
    stop = batch_size if stop is None else stop
    keys = prng.split(step_key, 2 * batch_size, 2 * start, 2 * stop, device=device).view(-1, 2, 2)
    n_anchors = sum(len(a) for a in anchor_lib.fpn_anchors(cfg.image_size))
    return {"rpn": prng.uniform(keys[:, 0], n_anchors),
            "stage0": prng.uniform(keys[:, 1], train_proposal_count(cfg) + cfg.max_gt)}


def detector_forward_train(model: CascadeMaskRCNN, cfg: DetectorConfig, batch: dict, uniform: dict) -> dict:
    """The training losses of a batch, each averaged over the images (the
    model in train mode; its BatchNorms update their running statistics).

    batch: images [B, S, S, 3] uint8 (or [0, 1] float); image_hw [B, 2];
    gt_boxes [B, G, 4]; gt_scores [B, G]; gt_valid [B, G]; gt_masks
    [B, G, R, R] uint8 (or [0, 1] float); is_single_object [B]. ``uniform``:
    :func:`uniform_draws`. No gradient reaches the proposals, the sampled
    and cascaded boxes, the DropLoss weights, the matched scores or the mask
    targets."""
    images, hw = batch["images"], batch["image_hw"]
    gt_boxes, gt_scores, gt_valid = batch["gt_boxes"], batch["gt_scores"], batch["gt_valid"]
    dev, B = images.device, images.shape[0]
    feats = model.backbone(normalize(images).to(next(model.parameters()).dtype))
    rpn_out = model.rpn(feats)
    anchors_l = level_anchors(cfg.image_size, dev)
    obj_l = [rpn_out[n]["objectness"] for n in LEVELS]
    del_l = [rpn_out[n]["deltas"] for n in LEVELS]
    losses = rpn_losses(torch.cat(anchors_l), torch.cat(obj_l, dim=1), torch.cat(del_l, dim=1), gt_boxes, gt_valid,
                        uniform["rpn"], batch_size_per_image=cfg.rpn_batch_per_image)
    with torch.no_grad():
        proposals, _, p_valid = generate_proposals(
            anchors_l, [o.detach() for o in obj_l], [d.detach() for d in del_l], hw,
            cfg.rpn_pre_nms_topk_train, cfg.rpn_post_nms_topk_train, cfg.rpn_nms_thresh)
        s0 = sample_stage0(proposals, p_valid, gt_boxes, gt_scores, gt_valid, uniform["stage0"],
                           num_samples=cfg.stage_samples, positive_fraction=cfg.positive_fraction,
                           iou_thresh=CASCADE_IOUS[0])
    roi = RoIFeatures({n: feats[n].permute(0, 2, 3, 1) for n in ROI_LEVELS})
    boxes_k, valid_k, match = s0["boxes"], s0["valid"], s0
    for k, head in enumerate(model.box_heads):
        if k > 0:
            with torch.no_grad():
                match = match_and_label(boxes_k, valid_k, gt_boxes, gt_scores, gt_valid, CASCADE_IOUS[k])
        N = boxes_k.shape[1]
        pooled = roi.pool(boxes_k, 7, cfg.pooler_sampling)
        scores, deltas = head(pooled.reshape(B * N, *pooled.shape[2:]))
        scores, deltas = scores.reshape(B, N, -1), deltas.reshape(B, N, 4)
        with torch.no_grad():
            pred_boxes = clip_boxes(decode_deltas(deltas, boxes_k, weights=CASCADE_WEIGHTS[k]), hw)
            w = (droploss_weights(pred_boxes, gt_boxes, gt_valid, batch["is_single_object"], cfg.droploss_iou_thresh)
                 if cfg.use_droploss else torch.ones_like(valid_k, dtype=torch.float32))
        losses[f"loss_cls_stage{k}"] = softmax_ce_soft_targets(scores, match["fg"], match["gt_score"], w, valid_k)
        losses[f"loss_box_reg_stage{k}"] = soft_box_reg_loss(boxes_k, deltas, match["fg"], match["gt_box"],
                                                             match["gt_score"], valid_k, CASCADE_WEIGHTS[k])
        boxes_k = pred_boxes
    if cfg.mask_on:
        # the mask head trains on the fg stage-0 proposals only, compacted to
        # the sampler's fg cap (detectron2's select_foreground_proposals)
        cap = max(int(cfg.stage_samples * cfg.positive_fraction), 1)
        order = torch.argsort((~s0["fg"]).to(torch.uint8), dim=1, stable=True)[:, :cap]
        mb = gather_rows(s0["boxes"], order)
        fg, matched, score = (torch.gather(s0[k2], 1, order) for k2 in ("fg", "matched_idx", "gt_score"))
        pooled = roi.pool(mb, 14, cfg.pooler_sampling)
        logits = model.mask_head(pooled.reshape(-1, *pooled.shape[2:]))[..., 0]
        logits = logits.reshape(B, mb.shape[1], *logits.shape[1:])
        with torch.no_grad():
            targets = crop_gt_mask_to_proposals(_mask_targets_float(batch["gt_masks"]), gt_boxes, matched, mb,
                                                out_size=logits.shape[-1])
        losses["loss_mask"] = mask_loss_weighted(logits, targets, fg, score)
    return {k: losses[k].mean() for k in sorted(losses)}
