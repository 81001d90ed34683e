"""Batched object discovery engine, stage 2 (port of ``reasoning/engine.py``).

The same program as the JAX engine, run eagerly on one device:

* proposals live in fixed ``[K, 4]`` lattices with validity masks and a
  per-box image index; one lattice spans ``image_batch`` images;
* every model phase first compacts live boxes to the front with a stable
  sort, then runs the model on full ``crop_chunk`` chunks while they fit
  and on ``crop_chunk_tail`` chunks for the rest (the live count is read
  on the host once per phase and once per boundary round);
* the center phase decodes each chunk with the fused CUDA kernel
  (:func:`~unmore_tpu_torch.ops.decode.fused_center_decode`), splits failing
  boxes four ways at the singularity and, with ``analyze_cc``, adds the
  enlarged boxes of the union mask's connected components;
* overflow of the split and active lattices sheds the lowest existence
  scores (``_rank_keep``) and is counted, never silently truncated;
* the boundary evolution runs at most ``n_round`` rounds of the SDF head
  only; converged boxes freeze (``sticky_convergence``) unless the
  reference-rounds mode re-predicts them every round;
* a per-image NMS by coordinate offset picks the final boxes.
* the tracer (:mod:`unmore_tpu_torch.utils.tracing`) spans the group
  (``engine.discover_batch``), its phases, each boundary round, each model
  call and each device-to-host read it makes (``sync.<site>``, counted in
  ``host_syncs``).

Results follow the JAX engine's compaction order, because the final NMS
(all scores equal) breaks ties in that order. Over several cards the
discovery CLI runs one engine a rank, each on its strided shard of the
images (:mod:`unmore_tpu_torch.parallel`), where the JAX engine shards
image groups over the chips of one process with ``shard_map``. Not ported:
the segmented boundary evolution (a TPU-watchdog workaround).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from unmore_tpu_torch import resolve_device
from unmore_tpu_torch.ops.connected_components import component_boxes, label_components
from unmore_tpu_torch.ops.decode import fused_center_decode
from unmore_tpu_torch.ops.fields import center_singularity_scores
from unmore_tpu_torch.ops.image import crop_and_resize, image_gradients
from unmore_tpu_torch.ops.nms import nms_mask
from unmore_tpu_torch.reasoning.proposals import seed_proposals
from unmore_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class ReasoningConfig:
    # geometry
    crop_size: int = 128
    canvas_size: int = 640
    image_batch: int = 1  # images per discovery batch (shared lattice)
    max_proposals: int = 2048  # per-image seed lattice
    max_splits: int = 2048  # per-image split/CC lattice after compaction
    max_active: int = 1024  # per-image boundary-phase lattice
    # model microbatching: full crop_chunk batches while they fit, then
    # crop_chunk_tail batches for the live remainder
    crop_chunk: int = 256
    crop_chunk_tail: int = 32
    exist_chunk: int = 1024  # classifier microbatch (capped, see exist_tile)
    gather_chunk: int = 32  # crop-gather chunk
    # thresholds (reference object_reasoning.py defaults)
    class_score_thres: float = 0.1
    center_score_max_thres: float = 0.009
    analyze_cc: bool = True
    cc_max_components: int = 8
    cc_enlarge_ratio: float = 1.5
    max_sdf_thres: float = 0.5
    max_shrink_threshold: float = 16.0
    delta_ratio: float = 0.5
    n_round: int = 50
    proposal_area_thres: float = 50.0
    nms_iou: float = 0.5
    # True: converged boxes freeze and stop costing model FLOPs; False:
    # reference semantics, every surviving box is re-predicted each round
    sticky_convergence: bool = True
    # fused CUDA decode kernel for the center phase. None = the kernel for
    # CUDA tensors (CPU tensors run its plain version); False = always the
    # plain version
    use_decode_kernel: bool | None = None

    def __post_init__(self):
        tail = min(self.crop_chunk_tail, self.crop_chunk)
        if self.crop_chunk % tail:
            raise ValueError("crop_chunk must be a multiple of crop_chunk_tail")
        if self.exist_chunk < self.crop_chunk:
            warnings.warn(
                f"exist_chunk={self.exist_chunk} < crop_chunk={self.crop_chunk}: "
                f"the effective existence microbatch (exist_tile) is floored "
                f"to crop_chunk, so {self.exist_tile}-crop classifier calls "
                f"will run",
                stacklevel=2,
            )
        if self.exist_tile % tail:
            raise ValueError(
                f"effective exist_tile {self.exist_tile} (from exist_chunk="
                f"{self.exist_chunk}) must be a multiple of crop_chunk_tail"
            )
        if self.exist_tile > self.crop_chunk and self.exist_tile % self.crop_chunk:
            raise ValueError(
                f"effective exist_tile {self.exist_tile} (from exist_chunk="
                f"{self.exist_chunk}) must be a multiple of crop_chunk"
            )
        for field in ("max_proposals", "max_splits", "max_active"):
            if (getattr(self, field) * self.image_batch) % self.crop_chunk:
                raise ValueError(f"{field} * image_batch must be a multiple of crop_chunk")
            if (getattr(self, field) * self.image_batch) % self.exist_tile:
                raise ValueError(
                    f"{field} * image_batch must be a multiple of the "
                    f"effective exist_tile {self.exist_tile} (from "
                    f"exist_chunk={self.exist_chunk})"
                )

    @property
    def tail(self) -> int:
        return min(self.crop_chunk_tail, self.crop_chunk)

    @property
    def exist_tile(self) -> int:
        """exist_chunk capped to the smallest lattice it must divide."""
        smallest = min(self.max_proposals, self.max_splits, self.max_active) * self.image_batch
        return max(min(self.exist_chunk, smallest), self.crop_chunk)


def _compact(boxes, valid, out_slots: int, extras=()):
    """Stable-gather valid rows to the front of a fixed-size lattice.

    Returns (boxes [out_slots, 4], valid [out_slots], extras, n_valid,
    n_overflow); counts are 0-d tensors.
    """
    order = torch.argsort((~valid).to(torch.int32), stable=True)[:out_slots]
    n_valid = valid.sum(dtype=torch.int32)
    overflow = (n_valid - out_slots).clamp(min=0)
    return boxes[order], valid[order], tuple(a[order] for a in extras), n_valid, overflow


def _rank_keep(valid, scores, out_slots: int):
    """Keep the ``out_slots`` highest-scoring valid rows; equal scores keep
    lattice order, and without overflow ``keep == valid``. Returns
    ``(keep, overflow)``."""
    key = torch.where(valid, scores.float(), torch.full((), -float("inf"), device=scores.device))
    perm = torch.argsort(-key, stable=True)  # desc score; ties keep lattice order
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(perm.shape[0], device=perm.device)
    n_valid = valid.sum(dtype=torch.int32)
    return valid & (rank < out_slots), (n_valid - out_slots).clamp(min=0)


def _segment_count(mask, idx, num_segments: int):
    """Per-image count of set ``mask`` rows (``segment_sum`` of the mask)."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=mask.device)
    return out.index_add_(0, idx.long(), mask.long())


def _to_numpy(t):
    return t.cpu().numpy()


def _live_prefix_map(chunk_fn, boxes, idx, n_live: int, chunk: int, tail: int, out_init: dict):
    """Run chunk_fn over the live prefix in two chunk tiers.

    boxes [K, 4] with live rows first; K is a multiple of ``chunk`` and
    ``tail``. Full ``chunk`` batches run while they fit in ``n_live``,
    then ``tail`` batches for the rest. ``chunk_fn(boxes_c, idx_c)``
    returns a dict of [c, ...] tensors written into ``out_init`` in place.
    """
    def run(off, size):
        ys = chunk_fn(boxes[off : off + size], idx[off : off + size])
        for k, y in ys.items():
            out_init[k][off : off + size] = y.to(out_init[k].dtype)
        return off + size

    off = 0
    while off + chunk <= n_live:
        off = run(off, chunk)
    while off < n_live:
        off = run(off, tail)
    return out_init


class ObjectDiscoveryEngine:
    """Batched center-boundary reasoning over a stack of padded canvases.

    objectness_fn: (crops [B, S, S, 3] f32, compute_center: bool) ->
        dict(sdf_maps [B, S, S] and, if requested, center_fields [B, S, S, 2])
    classifier_fn: (crops [B, S, S, 3] f32) -> scores [B]
    device: where the lattices live; None means ``cuda`` (raises without a
        card; pass ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, objectness_fn, classifier_fn, config: ReasoningConfig = ReasoningConfig(),
                 device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self._objectness = objectness_fn
        self._classifier = classifier_fn
        self._decode = center_singularity_scores if config.use_decode_kernel is False else fused_center_decode

    @property
    def image_slots(self) -> int:
        """Images accepted per :meth:`discover_batch` call."""
        return self.cfg.image_batch

    def _crops(self, canvases, bc, ic):
        c = self.cfg
        return crop_and_resize(canvases, bc, out_size=c.crop_size, chunk=c.gather_chunk, image_idx=ic)

    def _batched_nms(self, boxes, scores, valid, idx):
        """Per-image NMS on a shared lattice: offsetting each image's boxes
        by a disjoint coordinate range zeroes cross-image IoU."""
        off = (idx.float() * (2.0 * self.cfg.canvas_size))[:, None]
        return nms_mask(boxes + off, scores, valid, iou_threshold=self.cfg.nms_iou)

    # ------------------------------------------------------------ existence
    def _existence_phase(self, canvases, boxes, idx, valid):
        """Existence scores per box; returns (boxes, idx, valid, scores) in
        compacted order."""
        c = self.cfg
        K = boxes.shape[0]
        boxes, valid, (idx,), n_live, _ = _compact(boxes, valid, K, extras=(idx,))

        def chunk_fn(bc, ic):
            crops = self._crops(canvases, bc, ic)
            with tracing.span("models.classifier"):
                scores = self._classifier(crops)
            return {"s": scores.reshape(-1)}

        # the cheap classifier's remainder runs in crop_chunk-sized calls
        tail = min(c.crop_chunk, c.exist_tile) if c.exist_tile > c.crop_chunk else c.tail
        out = {"s": torch.zeros(K, dtype=torch.float32, device=boxes.device)}
        n_live = tracing.read("existence.n_live", int, n_live)
        scores = _live_prefix_map(chunk_fn, boxes, idx, n_live, c.exist_tile, tail, out)["s"]
        return boxes, idx, valid, torch.where(valid, scores, torch.zeros((), device=boxes.device))

    # --------------------------------------------------------------- center
    def _center_phase(self, canvases, hw, boxes, idx, valid, analyze_cc: bool, extras=()):
        """Singularity check + 4-way split + CC analysis.

        hw: [B, 2] per-image (h, w) float. extras: [K, ...] tensors carried
        through the compaction, returned re-aligned under ``extras``.
        """
        c = self.cfg
        S = c.crop_size
        K = boxes.shape[0]
        dev = boxes.device
        boxes, valid, ex, n_live, _ = _compact(boxes, valid, K, extras=(idx,) + tuple(extras))
        idx, extras = ex[0], ex[1:]

        def chunk_fn(bc, ic):
            crops = self._crops(canvases, bc, ic)
            with tracing.span("models.objectness"):
                out = self._objectness(crops, True)
            sing, argmax_yx, union = self._decode(
                out["sdf_maps"].float().contiguous(), out["center_fields"].float().contiguous()
            )
            res = {"sing": sing, "argmax_yx": argmax_yx}
            if analyze_cc:
                labels = label_components(union, max_iters=256)
                res["cc_boxes"], res["cc_valid"], res["cc_counts"] = component_boxes(
                    labels, max_components=c.cc_max_components
                )
            return res

        out_init = {
            "sing": torch.zeros(K, dtype=torch.float32, device=dev),
            "argmax_yx": torch.zeros(K, 2, dtype=torch.int32, device=dev),
        }
        if analyze_cc:
            C = c.cc_max_components
            out_init.update(
                cc_boxes=torch.zeros(K, C, 4, dtype=torch.float32, device=dev),
                cc_valid=torch.zeros(K, C, dtype=torch.bool, device=dev),
                cc_counts=torch.zeros(K, dtype=torch.int32, device=dev),
            )
        n_live = tracing.read("center.n_live", int, n_live)
        outs = _live_prefix_map(chunk_fn, boxes, idx, n_live, c.crop_chunk, c.tail, out_init)

        fail = valid & (outs["sing"] > c.center_score_max_thres)
        passed = valid & ~fail
        h = hw[idx, 0]
        w = hw[idx, 1]

        # 4-way split at the singularity argmax
        x1, y1, x2, y2 = boxes.unbind(1)
        yr = outs["argmax_yx"][:, 0].float() / S
        xr = outs["argmax_yx"][:, 1].float() / S
        xm = x1 + (x2 - x1) * xr
        ym = y1 + (y2 - y1) * yr
        splits = torch.stack(
            [
                torch.stack([x1, y1, xm, y2], -1),
                torch.stack([xm, y1, x2, y2], -1),
                torch.stack([x1, y1, x2, ym], -1),
                torch.stack([x1, ym, x2, y2], -1),
            ],
            dim=1,
        )  # [K, 4, 4]
        result = {
            "boxes": boxes,
            "idx": idx,
            "passed": passed,
            "split_boxes": splits.reshape(-1, 4),
            "split_valid": fail.repeat_interleave(4),
            "split_idx": idx.repeat_interleave(4),
            "singularity_scores": outs["sing"],
            "extras": extras,
        }

        if analyze_cc:
            # multi-component masks contribute enlarged per-component boxes;
            # crop coords map to image coords through the proposal box
            C = c.cc_max_components
            multi = passed & (outs["cc_counts"] > 1)
            cc = outs["cc_boxes"]
            sx = ((x2 - x1) / S)[:, None]
            sy = ((y2 - y1) / S)[:, None]
            bx1 = x1[:, None] + cc[..., 0] * sx
            by1 = y1[:, None] + cc[..., 1] * sy
            bx2 = x1[:, None] + cc[..., 2] * sx
            by2 = y1[:, None] + cc[..., 3] * sy
            # enlarge around the center, truncate to ints, clip to the image
            cx, cy = (bx1 + bx2) / 2, (by1 + by2) / 2
            nw = (bx2 - bx1) * c.cc_enlarge_ratio
            nh = (by2 - by1) * c.cc_enlarge_ratio
            ex1 = torch.floor((cx - nw / 2).clamp(min=0.0))
            ey1 = torch.floor((cy - nh / 2).clamp(min=0.0))
            ex2 = torch.floor(torch.minimum(cx + nw / 2, w[:, None]))
            ey2 = torch.floor(torch.minimum(cy + nh / 2, h[:, None]))
            result["cc_boxes"] = torch.stack([ex1, ey1, ex2, ey2], dim=-1).reshape(-1, 4)
            result["cc_valid"] = (outs["cc_valid"] & multi[:, None]).reshape(-1)
            result["cc_idx"] = idx.repeat_interleave(C)
            result["cc_overflow"] = torch.where(
                passed, (outs["cc_counts"] - C).clamp(min=0), torch.zeros((), dtype=torch.int32, device=dev)
            ).sum()
        return result

    # ------------------------------------------------------------- boundary
    def _boundary_chunk_stats(self, canvases, bc, ic):
        """Per-chunk SDF stats: max value + edge deltas, reduced to per-box
        scalars inside the chunk."""
        crops = self._crops(canvases, bc, ic)
        with tracing.span("models.objectness"):
            out = self._objectness(crops, False)
        sdf = out["sdf_maps"].float()
        max_sdf = sdf.amax(dim=(1, 2))
        dy, dx = image_gradients(sdf)
        grad_norm = torch.sqrt(dy**2 + dx**2)[:, :-1, :-1]
        sdf_m = sdf[:, :-1, :-1]
        soft_fg = torch.sigmoid(sdf_m)
        soft_bg = 1.0 - soft_fg
        avg_fg = (soft_fg * grad_norm).sum(dim=(1, 2)) / (soft_fg.sum(dim=(1, 2)) + 1e-8)
        avg_bg = (soft_bg * grad_norm).sum(dim=(1, 2)) / (soft_bg.sum(dim=(1, 2)) + 1e-8)
        step = (1.0 / (avg_fg + 1e-10))[:, None, None] * soft_fg + (1.0 / (avg_bg + 1e-10))[:, None, None] * soft_bg
        movement = step * sdf_m
        return {
            "max_sdf": max_sdf,
            "d_x1": -movement[:, :, 0].amax(dim=1),
            "d_y1": -movement[:, 0, :].amax(dim=1),
            "d_x2": movement[:, :, -1].amax(dim=1),
            "d_y2": movement[:, -1, :].amax(dim=1),
        }

    def _boundary_phase(self, canvases, hw, boxes, idx, valid):
        """Iterative boundary-driven box evolution.

        Returns (boxes, idx, labels, rounds, active_trace). labels: -1
        dropped, 0 still active (ran out of rounds), 1 converged.
        active_trace lists the live count entering each round.
        """
        c = self.cfg
        S = c.crop_size
        K = boxes.shape[0]
        dev = boxes.device
        zero = torch.zeros((), device=dev)
        labels = torch.where(valid, 0, -1).to(torch.int8)
        rnd, trace = 0, []
        while rnd < c.n_round:
            live = (labels == 0) if c.sticky_convergence else (labels >= 0)
            if not tracing.read("boundary.any_live", bool, live.any()):
                break
            with tracing.span("engine.boundary.round"):
                if not c.sticky_convergence:
                    # reference semantics: every surviving label resets to 0
                    labels = torch.where(labels == 1, 0, labels).to(torch.int8)
                x1, y1, x2, y2 = boxes.unbind(1)
                # the area filter applies to every surviving proposal each round
                area = (x2 - x1) * (y2 - y1)
                labels = torch.where((labels >= 0) & (area <= c.proposal_area_thres), -1, labels).to(torch.int8)

                # live-prefix compaction: only active boxes cost model FLOPs
                active = labels == 0
                order = torch.argsort((~active).to(torch.int32), stable=True)
                boxes, idx, labels = boxes[order], idx[order], labels[order]
                n_active = tracing.read("boundary.n_active", int, active.sum())
                trace.append(n_active)
                x1, y1, x2, y2 = boxes.unbind(1)
                active = labels == 0
                h = hw[idx, 0]
                w = hw[idx, 1]

                out_init = {k: torch.zeros(K, dtype=torch.float32, device=dev)
                            for k in ("max_sdf", "d_x1", "d_y1", "d_x2", "d_y2")}
                stats = _live_prefix_map(
                    lambda bc, ic: self._boundary_chunk_stats(canvases, bc, ic),
                    boxes, idx, n_active, c.crop_chunk, c.tail, out_init,
                )
                labels = torch.where(active & (stats["max_sdf"] <= c.max_sdf_thres), -1, labels).to(torch.int8)
                active = labels == 0

                on_edge = torch.stack(
                    [torch.floor(x1) == 0, torch.floor(y1) == 0, torch.ceil(x2) == w, torch.ceil(y2) == h], dim=1
                )
                signed = torch.stack([-stats["d_x1"], -stats["d_y1"], stats["d_x2"], stats["d_y2"]], dim=1)
                signed = torch.where((signed > 0) & on_edge, zero, signed)
                max_exp = signed.amax(dim=1)
                max_shr = signed.amin(dim=1)
                converged = (max_exp <= 0) & (max_shr >= -c.max_shrink_threshold)
                labels = torch.where(active & converged, 1, labels).to(torch.int8)

                # overshoot by delta_ratio
                d_x1 = stats["d_x1"] - stats["d_x1"].abs() * c.delta_ratio
                d_y1 = stats["d_y1"] - stats["d_y1"].abs() * c.delta_ratio
                d_x2 = stats["d_x2"] + stats["d_x2"].abs() * c.delta_ratio
                d_y2 = stats["d_y2"] + stats["d_y2"].abs() * c.delta_ratio

                still_active = labels == 0
                xr = (x2 - x1) / S
                yr = (y2 - y1) / S
                new = torch.stack(
                    [
                        torch.minimum((x1 + d_x1 * xr).clamp(min=0.0), w),
                        torch.minimum((y1 + d_y1 * yr).clamp(min=0.0), h),
                        torch.minimum((x2 + d_x2 * xr).clamp(min=0.0), w),
                        torch.minimum((y2 + d_y2 * yr).clamp(min=0.0), h),
                    ],
                    dim=1,
                )
                boxes = torch.where(still_active[:, None], new, boxes)
            rnd += 1
        return boxes, idx, labels, rnd, trace

    # ----------------------------------------------------------- full image
    def _core_pre(self, canvases, hw, boxes, idx, valid):
        """Existence -> center/split/CC -> recheck -> active compaction
        (everything before the boundary evolution). canvases are [0, 1]
        float. Returns (act_boxes, act_idx, act_valid, stats)."""
        c = self.cfg
        B = c.image_batch

        with tracing.span("engine.existence"):
            boxes, idx, valid, scores = self._existence_phase(canvases, boxes, idx, valid)
        valid = valid & (scores >= c.class_score_thres)
        n_exist = _segment_count(valid, idx, B)
        n_center_in = valid.sum()

        # existence scores ride along so the boundary-lattice shed is score-ranked
        with tracing.span("engine.center"):
            center_out = self._center_phase(canvases, hw, boxes, idx, valid, c.analyze_cc, extras=(scores,))
        boxes, idx, passed = center_out["boxes"], center_out["idx"], center_out["passed"]
        (scores,) = center_out["extras"]
        split_boxes = center_out["split_boxes"]
        split_valid = center_out["split_valid"]
        split_idx = center_out["split_idx"]
        # split rows are parent-major: the parent's existence score is the shed key
        split_scores = scores.repeat_interleave(4)
        cc_overflow = torch.zeros((), dtype=torch.int64, device=boxes.device)
        if c.analyze_cc:
            split_boxes = torch.cat([split_boxes, center_out["cc_boxes"]], dim=0)
            split_valid = torch.cat([split_valid, center_out["cc_valid"]], dim=0)
            split_idx = torch.cat([split_idx, center_out["cc_idx"]], dim=0)
            split_scores = torch.cat([split_scores, scores.repeat_interleave(c.cc_max_components)], dim=0)
            cc_overflow = center_out["cc_overflow"]
        # demand counted BEFORE shedding
        n_split = split_valid.sum()
        keep_split, split_overflow = _rank_keep(split_valid, split_scores, c.max_splits * B)
        split_boxes, split_valid, (split_idx,), _, _ = _compact(
            split_boxes, keep_split, c.max_splits * B, extras=(split_idx,)
        )

        # re-check split proposals: existence then singularity
        with tracing.span("engine.recheck_existence"):
            split_boxes, split_idx, split_valid, s_scores = self._existence_phase(
                canvases, split_boxes, split_idx, split_valid
            )
        split_valid = split_valid & (s_scores >= c.class_score_thres)
        n_recheck = split_valid.sum()
        with tracing.span("engine.recheck_center"):
            recheck = self._center_phase(
                canvases, hw, split_boxes, split_idx, split_valid, analyze_cc=False, extras=(s_scores,)
            )
        split_boxes, split_idx, split_passed = recheck["boxes"], recheck["idx"], recheck["passed"]
        (s_scores,) = recheck["extras"]

        all_boxes = torch.cat([boxes, split_boxes], dim=0)
        all_idx = torch.cat([idx, split_idx], dim=0)
        all_valid = torch.cat([passed, split_passed], dim=0)
        all_scores = torch.cat([scores, s_scores], dim=0)
        n_act = all_valid.sum()
        keep, act_overflow = _rank_keep(all_valid, all_scores, c.max_active * B)
        act_boxes, act_valid, (act_idx,), _, _ = _compact(all_boxes, keep, c.max_active * B, extras=(all_idx,))
        stats = {
            "n_exist": n_exist,
            "n_center_in": n_center_in,
            "n_split": n_split,
            "split_overflow": split_overflow,
            "cc_overflow": cc_overflow,
            "n_recheck_center_in": n_recheck,
            "n_boundary_in": n_act,
            "active_overflow": act_overflow,
        }
        return act_boxes, act_idx, act_valid, stats

    def discover(self, image: np.ndarray) -> dict:
        """Full discovery on one image [H, W, 3] (float in [0, 1] or uint8)."""
        return self.discover_batch([image])[0]

    @torch.inference_mode()
    def discover_batch(self, images: list) -> list:
        """Discovery on up to ``image_batch`` images at once.

        images: list of [H_i, W_i, 3] float32 arrays in [0, 1] or uint8
        arrays (the wire format: canvases travel as bytes and are decoded
        on the device). Returns one dict per image: ``boxes`` (after NMS),
        ``converged_boxes`` and ``stats``. While the tracer records
        (:mod:`unmore_tpu_torch.utils.tracing`: after ``enable()``, or under
        a running torch profiler) every image's ``stats`` also holds
        ``trace``, the group's span totals and counter deltas; otherwise
        ``stats`` holds the JAX engine's keys alone.
        """
        with tracing.group("engine.discover_batch", self.device) as trace:
            results = self._discover_batch(images)
        if trace:
            for r in results:
                r["stats"]["trace"] = trace
        return results

    def _discover_batch(self, images: list) -> list:
        c = self.cfg
        B = c.image_batch
        if len(images) > B:
            raise ValueError(f"{len(images)} images exceed image_slots {B}")
        use_u8 = len(images) > 0 and all(im.dtype == np.uint8 for im in images)
        canvases = np.zeros((B, c.canvas_size, c.canvas_size, 3), np.uint8 if use_u8 else np.float32)
        hw = np.ones((B, 2), np.float32)
        K = c.max_proposals * B
        boxes_np = np.zeros((K, 4), np.float32)
        idx_np = np.zeros((K,), np.int64)
        valid_np = np.zeros((K,), bool)
        seed_counts = []
        for g, image in enumerate(images):
            h, w = image.shape[:2]
            if h > c.canvas_size or w > c.canvas_size:
                raise ValueError(f"image {h}x{w} exceeds canvas {c.canvas_size}")
            if image.dtype == np.uint8 and not use_u8:
                image = image.astype(np.float32) / 255.0  # mixed-dtype input
            canvases[g, :h, :w] = image
            hw[g] = (h, w)
            seeds = seed_proposals(h, w).astype(np.float32)
            cursor = sum(seed_counts)
            seed_counts.append(len(seeds))
            if cursor + len(seeds) > K:
                raise ValueError(f"seed total exceeds the proposal lattice {K}")
            boxes_np[cursor : cursor + len(seeds)] = seeds
            idx_np[cursor : cursor + len(seeds)] = g
            valid_np[cursor : cursor + len(seeds)] = True

        dev = self.device
        canv = torch.from_numpy(canvases).to(dev)
        canv = canv.float() / 255.0 if use_u8 else canv
        hw_t = torch.from_numpy(hw).to(dev)
        act_boxes, act_idx, act_valid, stats = self._core_pre(
            canv, hw_t, torch.from_numpy(boxes_np).to(dev), torch.from_numpy(idx_np).to(dev),
            torch.from_numpy(valid_np).to(dev),
        )
        with tracing.span("engine.boundary"):
            final_boxes, final_idx, labels, rounds, trace = self._boundary_phase(
                canv, hw_t, act_boxes, act_idx, act_valid
            )
        with tracing.span("engine.nms_readback"):
            keep = labels == 1
            # NMS (scores all 1 -> index-order tie-break)
            nms_keep = self._batched_nms(final_boxes, torch.ones(final_boxes.shape[0], device=dev), keep, final_idx)
            n_converged = tracing.read("readback.n_converged", torch.Tensor.tolist, _segment_count(keep, final_idx, B))
            n_final = tracing.read("readback.n_final", torch.Tensor.tolist, _segment_count(nms_keep, final_idx, B))
            n_exist = tracing.read("readback.n_exist", torch.Tensor.tolist, stats["n_exist"])
            scalars = {k: tracing.read("readback." + k, int, v) for k, v in stats.items() if k != "n_exist"}
            fb = tracing.read("readback.boxes", _to_numpy, final_boxes)
            fidx = tracing.read("readback.idx", _to_numpy, final_idx)
            keep_np = tracing.read("readback.converged", _to_numpy, keep)
            nms_np = tracing.read("readback.kept", _to_numpy, nms_keep)

        results = []
        for g in range(len(images)):
            mine = fidx == g
            s = {
                "n_seed": seed_counts[g],
                "n_exist": n_exist[g],
                "n_center_in": scalars["n_center_in"],
                "n_split": scalars["n_split"],
                "split_overflow": scalars["split_overflow"],
                "n_recheck_center_in": scalars["n_recheck_center_in"],
                "n_boundary_in": scalars["n_boundary_in"],
                "active_overflow": scalars["active_overflow"],
                "boundary_rounds": rounds,
                "boundary_active_trace": list(trace),
                "n_converged": n_converged[g],
                "n_final": n_final[g],
            }
            if c.analyze_cc:
                s["cc_overflow"] = scalars["cc_overflow"]
            results.append(
                {"boxes": fb[nms_np & mine], "converged_boxes": fb[keep_np & mine], "stats": s}
            )
        return results
