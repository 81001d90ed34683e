"""ROIAlign over FPN levels as gathers (port of ``detector/roi_align.py``).

detectron2 ROIAlignV2 semantics (aligned=True): half-pixel continuous
coordinates, the mean of each bin's sample points, zero outside the map.
Each box pools from its canonical FPN level,
level = floor(4 + log2(sqrt(area)/224 + 1e-8)) clamped to [2, 5]:

* a fixed ``sampling`` count per bin (2x2, the detector's default): one
  4-corner gather from one flat buffer of every image's P2..P5 rows;
* ``"adaptive"``: d2's ``sampling_ratio=0`` (ceil(roi / out_size) samples
  per bin and axis, up to 4), by pooling every (ry, rx) variant of every
  level and selecting per box, as the JAX package does.

Samples accumulate in the feature dtype; the bin mean is taken in float32,
so the output is float32 [N, out, out, C] (bins row-major, channels last:
the HWC order the box head flattens). Plain torch, as the JAX version is
plain XLA. Constant grids are made on the host in float32, and divisions by
non-powers of two go through device tensors (CUDA divides by a Python
scalar as a multiply by its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

FPN_STRIDES = {"P2": 4, "P3": 8, "P4": 16, "P5": 32}
ROI_LEVELS = tuple(FPN_STRIDES)


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as a true division on every device."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def _grid(n: int, device) -> torch.Tensor:
    """(arange(n) + 0.5) / n in float32."""
    return torch.from_numpy((np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)).to(device)


def _sample_grid(boxes: torch.Tensor, stride: torch.Tensor, out_size: int, sy: int, sx: int):
    """aligned=True sample coordinates over each box in feature coordinates:
    (ys, xs), each [N, Sy*Sx]. ``stride`` is a tensor broadcastable to [N]."""
    N = boxes.shape[0]
    Sy, Sx = out_size * sy, out_size * sx
    x1 = boxes[:, 0] / stride - 0.5
    y1 = boxes[:, 1] / stride - 0.5
    bw = (boxes[:, 2] / stride - 0.5 - x1).clamp(min=1e-6)
    bh = (boxes[:, 3] / stride - 0.5 - y1).clamp(min=1e-6)
    ys = y1[:, None] + _grid(Sy, boxes.device)[None, :] * bh[:, None]  # [N, Sy]
    xs = x1[:, None] + _grid(Sx, boxes.device)[None, :] * bw[:, None]  # [N, Sx]
    ys_g = ys[:, :, None].expand(N, Sy, Sx).reshape(N, Sy * Sx)
    xs_g = xs[:, None, :].expand(N, Sy, Sx).reshape(N, Sy * Sx)
    return ys_g, xs_g


def _bin_average(vals: torch.Tensor, out_size: int, sy: int, sx: int) -> torch.Tensor:
    """Per-bin mean of [N, Sy*Sx, C] samples -> float32 [N, out, out, C]."""
    N, C = vals.shape[0], vals.shape[-1]
    weight = float(np.float32(1.0 / (sy * sx)))
    v = vals.reshape(N, out_size, sy, out_size, sx, C).float() * weight
    return v.sum(dim=(2, 4))


def _corners(gather, ys: torch.Tensor, xs: torch.Tensor, H, W, dtype):
    """Bilinear sampling by four corner gathers; ``gather(yc, xc)`` returns
    [N, S, C] rows for clamped integer coordinates. Corners outside [0, H) x
    [0, W) (int64 tensors broadcastable to [N, S]) count zero. Accumulates
    in ``dtype``."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    out = None
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi = y0i + dy
            xi = x0i + dx
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yc = torch.minimum(yi.clamp(min=0), H - 1)
            xc = torch.minimum(xi.clamp(min=0), W - 1)
            term = gather(yc, xc) * ((wy * wx) * inb)[..., None].to(dtype)
            out = term if out is None else out + term
    return out


def roi_align_level(feat: torch.Tensor, boxes: torch.Tensor, stride: int, out_size: int, sampling: int = 2,
                    sampling_x: int | None = None) -> torch.Tensor:
    """feat [H, W, C] (one level, one image); boxes [N, 4] xyxy in image
    coordinates -> float32 [N, out, out, C]; ``sampling`` / ``sampling_x``
    are the samples per bin along y / x."""
    sy = sampling
    sx = sampling if sampling_x is None else sampling_x
    H, W, C = feat.shape
    st = torch.tensor(float(stride), dtype=boxes.dtype, device=boxes.device)
    ys, xs = _sample_grid(boxes, st, out_size, sy, sx)
    flat = feat.reshape(H * W, C)
    N, S = ys.shape

    def gather(yc, xc):
        return flat.index_select(0, (yc * W + xc).reshape(-1)).view(N, S, C)

    Ht, Wt = (torch.tensor(v, dtype=torch.int64, device=feat.device) for v in (H, W))
    return _bin_average(_corners(gather, ys, xs, Ht, Wt, feat.dtype), out_size, sy, sx)


def roi_align_level_adaptive(feat: torch.Tensor, boxes: torch.Tensor, stride: int, out_size: int,
                             max_ratio: int = 4) -> torch.Tensor:
    """d2's ``sampling_ratio=0``: ceil(roi_h / stride / out) samples per bin
    along y (likewise x), clamped to [1, max_ratio], by pooling every variant
    and selecting per box."""
    y_ratio = torch.ceil(_div(_div((boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6), stride), out_size))
    x_ratio = torch.ceil(_div(_div((boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6), stride), out_size))
    y_ratio = y_ratio.clamp(1, max_ratio).to(torch.int64)
    x_ratio = x_ratio.clamp(1, max_ratio).to(torch.int64)
    out = None
    for ry in range(1, max_ratio + 1):
        for rx in range(1, max_ratio + 1):
            pooled = roi_align_level(feat, boxes, stride, out_size, ry, rx)
            sel = ((y_ratio == ry) & (x_ratio == rx))[:, None, None, None]
            out = pooled * sel if out is None else out + pooled * sel
    return out


def assign_levels(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5) -> torch.Tensor:
    """Canonical FPN level per box (int64 in [k_min, k_max])."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(_div(torch.sqrt(area.clamp(min=1e-6)), 224.0) + 1e-8))
    return lvl.clamp(k_min, k_max).to(torch.int64)


class RoIFeatures:
    """P2..P5 of a batch, channels last ({name: [B, H_l, W_l, C]}), with
    every image's levels in one flat [B * sum(H_l * W_l), C] buffer, made
    once and pooled from by every stage."""

    def __init__(self, features: dict):
        self.levels = {n: features[n] for n in ROI_LEVELS}
        first = self.levels["P2"]
        self.batch, C = first.shape[0], first.shape[-1]
        dev = first.device
        shapes = [tuple(self.levels[n].shape[1:3]) for n in ROI_LEVELS]
        sizes = [h * w for h, w in shapes]
        self.per_image = sum(sizes)
        self.flat = torch.cat([self.levels[n].reshape(self.batch, -1, C) for n in ROI_LEVELS], dim=1)
        self.flat = self.flat.reshape(self.batch * self.per_image, C)
        self.offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]), dtype=torch.int64, device=dev)
        self.Hs = torch.tensor([h for h, _ in shapes], dtype=torch.int64, device=dev)
        self.Ws = torch.tensor([w for _, w in shapes], dtype=torch.int64, device=dev)
        self.strides = torch.tensor([4.0, 8.0, 16.0, 32.0], dtype=torch.float32, device=dev)

    def pool(self, boxes: torch.Tensor, out_size: int, sampling: int | str = 2) -> torch.Tensor:
        """boxes [B, N, 4] xyxy, box n of image b pooled from image b's
        maps -> float32 [B, N, out_size, out_size, C]."""
        B, N = boxes.shape[:2]
        if sampling == "adaptive":
            out = []
            for b in range(B):
                bx = boxes[b]
                levels = assign_levels(bx)
                pooled_b = None
                for name, stride in FPN_STRIDES.items():
                    pooled = roi_align_level_adaptive(self.levels[name][b], bx, stride, out_size, 4)
                    sel = (levels == int(name[1]))[:, None, None, None]
                    pooled_b = pooled * sel if pooled_b is None else pooled_b + pooled * sel
                out.append(pooled_b)
            return torch.stack(out)

        dev, C = boxes.device, self.flat.shape[-1]
        bx = boxes.reshape(B * N, 4)
        lvl = assign_levels(bx) - 2  # [B*N] in [0, 3]
        H_b, W_b = self.Hs[lvl][:, None], self.Ws[lvl][:, None]
        base = (torch.arange(B, device=dev).repeat_interleave(N) * self.per_image + self.offsets[lvl])[:, None]
        ys, xs = _sample_grid(bx, self.strides[lvl], out_size, sampling, sampling)
        S = ys.shape[1]

        def gather(yc, xc):
            return self.flat.index_select(0, (base + yc * W_b + xc).reshape(-1)).view(B * N, S, C)

        vals = _corners(gather, ys, xs, H_b, W_b, self.flat.dtype)
        return _bin_average(vals, out_size, sampling, sampling).view(B, N, out_size, out_size, C)
