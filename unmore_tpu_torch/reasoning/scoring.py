"""Object scoring, stage 2: discovered boxes -> scored COCO annotations.

Port of the JAX package's ``reasoning/scoring.py`` on one device. The work
splits as there: everything per crop (both model forwards, the score
reductions, the union mask) runs on the device over one shared lattice of
up to ``image_batch`` images, and the per-image full-resolution work (tight
boxes, areas and RLE of the pasted masks) runs on the host in the library
``csrc/paste.cpp`` (:mod:`unmore_tpu_torch.ops.paste`), where variable
image sizes are natural.

Per proposal:
  existence score = classifier output (0 on padding slots)
  center score    = max ||center field||
  boundary score  = max SDF
  union mask      = (||center|| > .5) | (sigmoid(sdf) > .5), pasted back at
                    the box; its tight box and area come from the paste
  NMS on the tight boxes, scored by the boundary score, one pass over the
  lattice with the images kept apart by a coordinate offset
  area score      = (area / max kept area of the image) ** 0.25
  final score     = existence * center * boundary * area score

Over several cards the scoring CLI runs one engine a rank, each on its
strided shard of the images (:mod:`unmore_tpu_torch.parallel`), where the
JAX package shards image groups over the chips of one process.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from unmore_tpu_torch import resolve_device
from unmore_tpu_torch.ops.image import crop_and_resize
from unmore_tpu_torch.ops.nms import nms_mask
from unmore_tpu_torch.ops.paste import paste_rle, paste_stats


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    crop_size: int = 128
    canvas_size: int = 640
    image_batch: int = 4  # images per shared lattice
    slot_multiple: int = 128  # lattice sizes round up to this
    crop_chunk: int = 128  # model microbatch
    nms_iou: float = 0.5


class ObjectScoringEngine:
    """``objectness_fn(crops, compute_center)`` -> dict of ``sdf_maps``
    [N, S, S] and ``center_fields`` [N, S, S, 2]; ``classifier_fn(crops)``
    -> [N] existence scores (``cli.common.make_apply_fns``)."""

    def __init__(self, objectness_fn, classifier_fn, config: ScoringConfig = ScoringConfig(), device=None):
        self.cfg = config
        self._objectness = objectness_fn
        self._classifier = classifier_fn
        self.device = resolve_device(device)
        self.last_timings: dict = {}  # device_s / host_s of the last score_batch

    @property
    def image_slots(self) -> int:
        """Images accepted per :meth:`score_batch` call."""
        return self.cfg.image_batch

    def _device_scores(self, canvases, boxes, idx, valid):
        """canvases [B, S, S, 3] float in [0, 1] or uint8; boxes [K, 4] and
        idx [K] on a shared lattice. Model chunks are padded with zero crops
        to ``crop_chunk``; the pads run the models and are dropped."""
        c = self.cfg
        if canvases.dtype == torch.uint8:
            # a 0-d tensor on the device: CUDA divides by a Python scalar as
            # a multiply by its reciprocal, one ulp off the true quotient
            canvases = canvases.float() / torch.tensor(255.0, device=canvases.device)
        crops = crop_and_resize(canvases, boxes, out_size=c.crop_size, chunk=64, image_idx=idx)
        n = crops.shape[0]
        pad = (-n) % c.crop_chunk
        if pad:
            crops = torch.cat([crops, crops.new_zeros((pad,) + crops.shape[1:])])
        sdf, center, exist = [], [], []
        for x in crops.split(c.crop_chunk):
            fields = self._objectness(x, True)
            sdf.append(fields["sdf_maps"].float())
            center.append(fields["center_fields"].float())
            exist.append(self._classifier(x).float().reshape(-1))
        sdf, center, exist = torch.cat(sdf)[:n], torch.cat(center)[:n], torch.cat(exist)[:n]
        center_norm = torch.sqrt((center * center).sum(-1))
        # the crop-space union of the two field masks: pasting it has
        # exactly the support of pasting both masks and taking their union,
        # since the bilinear weights are nonnegative and shared
        union = (center_norm > 0.5) | (torch.sigmoid(sdf) > 0.5)
        return {
            "existence": torch.where(valid, exist, torch.zeros((), device=exist.device)),
            "center_score": center_norm.amax(dim=(1, 2)),
            "boundary_score": sdf.amax(dim=(1, 2)),
            "union_mask": union.to(torch.uint8),
        }

    def score_image(self, image: np.ndarray, boxes: np.ndarray, image_id) -> list[dict]:
        """image [H, W, 3] in [0, 1] or uint8; boxes [N, 4] xyxy. Returns COCO anns."""
        return self.score_batch([image], [boxes], [image_id])[0]

    @torch.inference_mode()
    def score_batch(self, images: list, boxes_list: list, image_ids: list) -> list[list]:
        """Score up to ``image_slots`` images in one device pass.

        images: [H_i, W_i, 3] float32 arrays in [0, 1] or uint8 arrays;
        boxes_list: [N_i, 4] xyxy per image. Returns one COCO-annotation
        list per image.
        """
        c = self.cfg
        if len(images) > c.image_batch:
            raise ValueError(f"{len(images)} images exceed image_slots {c.image_batch}")
        n_img = len(images)
        if sum(len(b) for b in boxes_list) == 0:
            return [[] for _ in range(n_img)]

        # the lattice: every image's boxes, rounded up to slot_multiple
        total = sum(len(b) for b in boxes_list)
        K = -(-max(total, 1) // c.slot_multiple) * c.slot_multiple
        use_u8 = all(im.dtype == np.uint8 for im in images)
        canvases = np.zeros((n_img, c.canvas_size, c.canvas_size, 3), np.uint8 if use_u8 else np.float32)
        lat_boxes = np.zeros((K, 4), np.float32)
        lat_idx = np.zeros((K,), np.int64)
        lat_valid = np.zeros((K,), bool)
        rows = []  # per image: (lattice row start, number of boxes)
        cur = 0
        for g, (image, boxes) in enumerate(zip(images, boxes_list)):
            h, w = image.shape[:2]
            if h > c.canvas_size or w > c.canvas_size:
                raise ValueError(f"image {h}x{w} exceeds canvas {c.canvas_size}")
            if image.dtype == np.uint8 and not use_u8:
                image = image.astype(np.float32) / 255.0  # mixed-dtype input
            canvases[g, :h, :w] = image
            n = len(boxes)
            lat_boxes[cur : cur + n] = boxes
            lat_idx[cur : cur + n] = g
            lat_valid[cur : cur + n] = True
            rows.append((cur, n))
            cur += n

        dev = self.device
        t0 = time.perf_counter()
        out = self._device_scores(
            torch.from_numpy(canvases).to(dev), torch.from_numpy(lat_boxes).to(dev),
            torch.from_numpy(lat_idx).to(dev), torch.from_numpy(lat_valid).to(dev),
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_device = time.perf_counter() - t0
        t0 = time.perf_counter()

        # host: tight boxes and areas of the pasted union masks, per image
        all_tight = np.zeros((K, 4), np.float32)
        all_areas = np.zeros((K,), np.int64)
        union_masks = out["union_mask"]  # [K, s, s] uint8
        for g in range(n_img):
            cur, n = rows[g]
            if not n:
                continue
            h, w = images[g].shape[:2]
            tight, areas = paste_stats(union_masks[cur : cur + n], np.asarray(boxes_list[g], np.float32), h, w)
            all_tight[cur : cur + n] = tight
            all_areas[cur : cur + n] = areas

        # one NMS over the whole lattice: per-image coordinate offsets keep
        # boxes of different images from overlapping
        goff = lat_idx.astype(np.float32)[:, None] * (2.0 * c.canvas_size)
        keep = nms_mask(
            torch.from_numpy(all_tight + goff).to(dev), torch.from_numpy(out["boundary_score"]).to(dev),
            torch.from_numpy(lat_valid).to(dev), iou_threshold=c.nms_iou,
        ).cpu().numpy()

        results = []
        for g in range(n_img):
            cur, n = rows[g]
            keep_local = [j for j in range(n) if keep[cur + j]]
            if not keep_local:
                results.append([])
                continue
            h, w = images[g].shape[:2]
            areas = all_areas[[cur + j for j in keep_local]].astype(np.float64)
            max_area = max(areas.max(), 1.0)
            anns = []
            for j, area in zip(keep_local, areas):
                i = cur + j
                area_score = float((area / max_area) ** 0.25)
                existence = float(out["existence"][i])
                center_s = float(out["center_score"][i])
                boundary_s = float(out["boundary_score"][i])
                x1, y1, x2, y2 = all_tight[i]
                anns.append({
                    "image_id": image_ids[g],
                    "category_id": 1,
                    "score": existence * center_s * boundary_s * area_score,
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "segmentation": paste_rle(union_masks[i], boxes_list[g][j], h, w),
                    "existence_score": existence,
                    "center_score": center_s,
                    "boundary_score": boundary_s,
                    "area_score": area_score,
                })
            results.append(anns)
        self.last_timings = {"device_s": t_device, "host_s": time.perf_counter() - t0}
        return results
