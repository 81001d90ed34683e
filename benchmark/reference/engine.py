"""Stage-2 discovery, plain, following the system step by step.

The algorithm of the reference ``object_reasoning.py`` as the system batches
it (shared lattices of ``image_batch`` images, live-prefix model chunks,
sticky convergence), written with the frozen plain ops of
:mod:`benchmark.reference.ops`. Only the models are not run here: every
model call takes the next output that the system's own model produced for
that call in the timed window (``Replay``), so that the reference follows
the system's bf16 trajectory, where its own float32 models would take other
hard decisions at the thresholds. The crops of each call are the
reference's own; the reference's float32 models are run on a sample of
those crops and held against the system's outputs there
(:func:`benchmark.check.discovery_gaps`). Same model outputs, same algorithm:
the same boxes, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ops


class ReplayMismatch(Exception):
    """The reference asked for a model call that the system did not make."""


class Replay:
    """The system's model outputs in call order. ``on_call(kind, index,
    crops, recorded)`` sees each call (for the model check) before its
    output is handed back."""

    def __init__(self, calls, on_call=None):
        self.calls, self.pos, self.on_call = calls, 0, on_call

    def next(self, kind, crops):
        if self.pos >= len(self.calls):
            raise ReplayMismatch(f"call {self.pos} ({kind}, {len(crops)} crops) was never made by the system")
        got_kind, out = self.calls[self.pos]
        out = {k: v.to(crops.device) for k, v in out.items()}  # kept on the host while the window ran
        n = len(next(iter(out.values())))
        if got_kind != kind or n != len(crops):
            raise ReplayMismatch(f"call {self.pos}: the reference runs {kind} on {len(crops)} crops, "
                                 f"the system ran {got_kind} on {n}")
        if self.on_call is not None:
            self.on_call(kind, self.pos, crops, out)
        self.pos += 1
        return out


def _compact(boxes, valid, out_slots, extras=()):
    order = torch.argsort((~valid).to(torch.int32), stable=True)[:out_slots]
    n_valid = valid.sum(dtype=torch.int32)
    return boxes[order], valid[order], tuple(a[order] for a in extras), n_valid


def _rank_keep(valid, scores, out_slots):
    key = torch.where(valid, scores.float(), torch.full((), -float("inf"), device=scores.device))
    perm = torch.argsort(-key, stable=True)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(perm.shape[0], device=perm.device)
    return valid & (rank < out_slots)


def _segment_count(mask, idx, n):
    return torch.zeros(n, dtype=torch.int64, device=mask.device).index_add_(0, idx.long(), mask.long())


def _live_prefix_map(chunk_fn, boxes, idx, n_live, chunk, tail, out_init):
    def run(off, size):
        for k, y in chunk_fn(boxes[off : off + size], idx[off : off + size]).items():
            out_init[k][off : off + size] = y.to(out_init[k].dtype)
        return off + size

    off = 0
    while off + chunk <= n_live:
        off = run(off, chunk)
    while off < n_live:
        off = run(off, tail)
    return out_init


class Discovery:
    """``discover(images)`` -> per-image final boxes, with model outputs from ``replay``."""

    def __init__(self, cfg: dict, replay: Replay, device):
        self.c, self.replay, self.device = cfg, replay, device
        self.tail = min(cfg["crop_chunk_tail"], cfg["crop_chunk"])
        smallest = min(cfg["max_proposals"], cfg["max_splits"], cfg["max_active"]) * cfg["image_batch"]
        self.exist_tile = max(min(cfg.get("exist_chunk", 1024), smallest), cfg["crop_chunk"])

    def _crops(self, canvases, bc, ic):
        return ops.crop_and_resize(canvases, bc, self.c["crop_size"], self.c.get("gather_chunk", 32), ic)

    def _existence(self, canvases, boxes, idx, valid):
        c = self.c
        K = boxes.shape[0]
        boxes, valid, (idx,), n_live = _compact(boxes, valid, K, extras=(idx,))

        def chunk_fn(bc, ic):
            return {"s": self.replay.next("exist", self._crops(canvases, bc, ic))["scores"].reshape(-1)}

        tail = min(c["crop_chunk"], self.exist_tile) if self.exist_tile > c["crop_chunk"] else self.tail
        out = {"s": torch.zeros(K, dtype=torch.float32, device=boxes.device)}
        scores = _live_prefix_map(chunk_fn, boxes, idx, int(n_live), self.exist_tile, tail, out)["s"]
        return boxes, idx, valid, torch.where(valid, scores, torch.zeros((), device=boxes.device))

    def _center(self, canvases, hw, boxes, idx, valid, analyze_cc, extras=()):
        c = self.c
        S, K, dev = c["crop_size"], boxes.shape[0], boxes.device
        boxes, valid, ex, n_live = _compact(boxes, valid, K, extras=(idx,) + tuple(extras))
        idx, extras = ex[0], ex[1:]
        C = c.get("cc_max_components", 8)

        def chunk_fn(bc, ic):
            out = self.replay.next("center", self._crops(canvases, bc, ic))
            sing, argmax_yx, union = ops.decode(out["sdf_maps"].float().contiguous(),
                                                out["center_fields"].float().contiguous())
            res = {"sing": sing, "argmax_yx": argmax_yx}
            if analyze_cc:
                labels = ops.label_components(union, max_iters=256)
                res["cc_boxes"], res["cc_valid"], res["cc_counts"] = ops.component_boxes(labels, C)
            return res

        out_init = {"sing": torch.zeros(K, dtype=torch.float32, device=dev),
                    "argmax_yx": torch.zeros(K, 2, dtype=torch.int32, device=dev)}
        if analyze_cc:
            out_init.update(cc_boxes=torch.zeros(K, C, 4, dtype=torch.float32, device=dev),
                            cc_valid=torch.zeros(K, C, dtype=torch.bool, device=dev),
                            cc_counts=torch.zeros(K, dtype=torch.int32, device=dev))
        outs = _live_prefix_map(chunk_fn, boxes, idx, int(n_live), c["crop_chunk"], self.tail, out_init)

        fail = valid & (outs["sing"] > c["center_score_max_thres"])
        passed = valid & ~fail
        h, w = hw[idx, 0], hw[idx, 1]
        x1, y1, x2, y2 = boxes.unbind(1)
        yr = outs["argmax_yx"][:, 0].float() / S
        xr = outs["argmax_yx"][:, 1].float() / S
        xm = x1 + (x2 - x1) * xr
        ym = y1 + (y2 - y1) * yr
        splits = torch.stack([torch.stack([x1, y1, xm, y2], -1), torch.stack([xm, y1, x2, y2], -1),
                              torch.stack([x1, y1, x2, ym], -1), torch.stack([x1, ym, x2, y2], -1)], dim=1)
        result = {"boxes": boxes, "idx": idx, "passed": passed, "split_boxes": splits.reshape(-1, 4),
                  "split_valid": fail.repeat_interleave(4), "split_idx": idx.repeat_interleave(4), "extras": extras}
        if analyze_cc:
            multi = passed & (outs["cc_counts"] > 1)
            cc = outs["cc_boxes"]
            sx = ((x2 - x1) / S)[:, None]
            sy = ((y2 - y1) / S)[:, None]
            bx1 = x1[:, None] + cc[..., 0] * sx
            by1 = y1[:, None] + cc[..., 1] * sy
            bx2 = x1[:, None] + cc[..., 2] * sx
            by2 = y1[:, None] + cc[..., 3] * sy
            cx, cy = (bx1 + bx2) / 2, (by1 + by2) / 2
            ratio = c.get("cc_enlarge_ratio", 1.5)
            nw, nh = (bx2 - bx1) * ratio, (by2 - by1) * ratio
            ex1 = torch.floor((cx - nw / 2).clamp(min=0.0))
            ey1 = torch.floor((cy - nh / 2).clamp(min=0.0))
            ex2 = torch.floor(torch.minimum(cx + nw / 2, w[:, None]))
            ey2 = torch.floor(torch.minimum(cy + nh / 2, h[:, None]))
            result["cc_boxes"] = torch.stack([ex1, ey1, ex2, ey2], dim=-1).reshape(-1, 4)
            result["cc_valid"] = (outs["cc_valid"] & multi[:, None]).reshape(-1)
            result["cc_idx"] = idx.repeat_interleave(C)
        return result

    def _boundary_stats(self, canvases, bc, ic):
        sdf = self.replay.next("boundary", self._crops(canvases, bc, ic))["sdf_maps"].float()
        max_sdf = sdf.amax(dim=(1, 2))
        dy, dx = ops.image_gradients(sdf)
        grad_norm = torch.sqrt(dy**2 + dx**2)[:, :-1, :-1]
        sdf_m = sdf[:, :-1, :-1]
        soft_fg = torch.sigmoid(sdf_m)
        soft_bg = 1.0 - soft_fg
        avg_fg = (soft_fg * grad_norm).sum(dim=(1, 2)) / (soft_fg.sum(dim=(1, 2)) + 1e-8)
        avg_bg = (soft_bg * grad_norm).sum(dim=(1, 2)) / (soft_bg.sum(dim=(1, 2)) + 1e-8)
        step = (1.0 / (avg_fg + 1e-10))[:, None, None] * soft_fg + (1.0 / (avg_bg + 1e-10))[:, None, None] * soft_bg
        movement = step * sdf_m
        return {"max_sdf": max_sdf, "d_x1": -movement[:, :, 0].amax(dim=1), "d_y1": -movement[:, 0, :].amax(dim=1),
                "d_x2": movement[:, :, -1].amax(dim=1), "d_y2": movement[:, -1, :].amax(dim=1)}

    def _boundary(self, canvases, hw, boxes, idx, valid):
        c = self.c
        S, K, dev = c["crop_size"], boxes.shape[0], boxes.device
        sticky = c.get("sticky_convergence", True)
        zero = torch.zeros((), device=dev)
        labels = torch.where(valid, 0, -1).to(torch.int8)
        rnd = 0
        delta = c.get("delta_ratio", 0.5)
        while rnd < c["n_round"]:
            live = (labels == 0) if sticky else (labels >= 0)
            if not bool(live.any()):
                break
            if not sticky:
                labels = torch.where(labels == 1, 0, labels).to(torch.int8)
            x1, y1, x2, y2 = boxes.unbind(1)
            area = (x2 - x1) * (y2 - y1)
            labels = torch.where((labels >= 0) & (area <= c.get("proposal_area_thres", 50.0)), -1, labels).to(torch.int8)
            active = labels == 0
            order = torch.argsort((~active).to(torch.int32), stable=True)
            boxes, idx, labels = boxes[order], idx[order], labels[order]
            n_active = int(active.sum())
            x1, y1, x2, y2 = boxes.unbind(1)
            active = labels == 0
            h, w = hw[idx, 0], hw[idx, 1]
            out_init = {k: torch.zeros(K, dtype=torch.float32, device=dev)
                        for k in ("max_sdf", "d_x1", "d_y1", "d_x2", "d_y2")}
            st = _live_prefix_map(lambda bc, ic: self._boundary_stats(canvases, bc, ic),
                                  boxes, idx, n_active, c["crop_chunk"], self.tail, out_init)
            labels = torch.where(active & (st["max_sdf"] <= c.get("max_sdf_thres", 0.5)), -1, labels).to(torch.int8)
            active = labels == 0
            on_edge = torch.stack([torch.floor(x1) == 0, torch.floor(y1) == 0, torch.ceil(x2) == w,
                                   torch.ceil(y2) == h], dim=1)
            signed = torch.stack([-st["d_x1"], -st["d_y1"], st["d_x2"], st["d_y2"]], dim=1)
            signed = torch.where((signed > 0) & on_edge, zero, signed)
            converged = (signed.amax(dim=1) <= 0) & (signed.amin(dim=1) >= -c.get("max_shrink_threshold", 16.0))
            labels = torch.where(active & converged, 1, labels).to(torch.int8)
            d_x1 = st["d_x1"] - st["d_x1"].abs() * delta
            d_y1 = st["d_y1"] - st["d_y1"].abs() * delta
            d_x2 = st["d_x2"] + st["d_x2"].abs() * delta
            d_y2 = st["d_y2"] + st["d_y2"].abs() * delta
            still = labels == 0
            xr, yr = (x2 - x1) / S, (y2 - y1) / S
            new = torch.stack([torch.minimum((x1 + d_x1 * xr).clamp(min=0.0), w),
                               torch.minimum((y1 + d_y1 * yr).clamp(min=0.0), h),
                               torch.minimum((x2 + d_x2 * xr).clamp(min=0.0), w),
                               torch.minimum((y2 + d_y2 * yr).clamp(min=0.0), h)], dim=1)
            boxes = torch.where(still[:, None], new, boxes)
            rnd += 1
        return boxes, idx, labels

    def discover(self, images):
        """Final boxes of each uint8 image of one group."""
        c = self.c
        B = c["image_batch"]
        canvases = np.zeros((B, c["canvas_size"], c["canvas_size"], 3), np.uint8)
        hw = np.ones((B, 2), np.float32)
        K = c["max_proposals"] * B
        boxes_np = np.zeros((K, 4), np.float32)
        idx_np = np.zeros((K,), np.int64)
        valid_np = np.zeros((K,), bool)
        cursor = 0
        for g, image in enumerate(images):
            h, w = image.shape[:2]
            canvases[g, :h, :w] = image
            hw[g] = (h, w)
            seeds = ops.seed_proposals(h, w).astype(np.float32)
            boxes_np[cursor : cursor + len(seeds)] = seeds
            idx_np[cursor : cursor + len(seeds)] = g
            valid_np[cursor : cursor + len(seeds)] = True
            cursor += len(seeds)
        dev = self.device
        canv = torch.from_numpy(canvases).to(dev).float() / 255.0
        hw_t = torch.from_numpy(hw).to(dev)
        boxes, idx, valid = (torch.from_numpy(a).to(dev) for a in (boxes_np, idx_np, valid_np))
        cc = c.get("analyze_cc", True)
        Cn = c.get("cc_max_components", 8)

        boxes, idx, valid, scores = self._existence(canv, boxes, idx, valid)
        valid = valid & (scores >= c["class_score_thres"])
        center = self._center(canv, hw_t, boxes, idx, valid, cc, extras=(scores,))
        boxes, idx, passed = center["boxes"], center["idx"], center["passed"]
        (scores,) = center["extras"]
        split_boxes, split_valid, split_idx = center["split_boxes"], center["split_valid"], center["split_idx"]
        split_scores = scores.repeat_interleave(4)
        if cc:
            split_boxes = torch.cat([split_boxes, center["cc_boxes"]], dim=0)
            split_valid = torch.cat([split_valid, center["cc_valid"]], dim=0)
            split_idx = torch.cat([split_idx, center["cc_idx"]], dim=0)
            split_scores = torch.cat([split_scores, scores.repeat_interleave(Cn)], dim=0)
        keep = _rank_keep(split_valid, split_scores, c["max_splits"] * B)
        split_boxes, split_valid, (split_idx,), _ = _compact(split_boxes, keep, c["max_splits"] * B, extras=(split_idx,))
        split_boxes, split_idx, split_valid, s_scores = self._existence(canv, split_boxes, split_idx, split_valid)
        split_valid = split_valid & (s_scores >= c["class_score_thres"])
        recheck = self._center(canv, hw_t, split_boxes, split_idx, split_valid, False, extras=(s_scores,))
        (s_scores,) = recheck["extras"]
        all_boxes = torch.cat([boxes, recheck["boxes"]], dim=0)
        all_idx = torch.cat([idx, recheck["idx"]], dim=0)
        all_valid = torch.cat([passed, recheck["passed"]], dim=0)
        all_scores = torch.cat([scores, s_scores], dim=0)
        keep = _rank_keep(all_valid, all_scores, c["max_active"] * B)
        act_boxes, act_valid, (act_idx,), _ = _compact(all_boxes, keep, c["max_active"] * B, extras=(all_idx,))

        final, fidx, labels = self._boundary(canv, hw_t, act_boxes, act_idx, act_valid)
        keep = labels == 1
        off = (fidx.float() * (2.0 * c["canvas_size"]))[:, None]
        nms_keep = ops.nms_mask(final + off, torch.ones(final.shape[0], device=dev), keep, c.get("nms_iou", 0.5))
        fb, fi, kept = final.cpu().numpy(), fidx.cpu().numpy(), nms_keep.cpu().numpy()
        return [fb[kept & (fi == g)] for g in range(len(images))]
