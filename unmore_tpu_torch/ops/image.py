"""Image resampling primitives (port of the JAX package's ``ops/image.py``).

Same conventions as the reference:

* ``align_corners=False`` is ``F.interpolate``'s half-pixel convention, used
  for every image/crop resize; ``align_corners=True`` is the DPT fusion-block
  upsampling.
* Bilinear resize is two dense matmuls with the same f32 weight matrices as
  the JAX package (built in float64 on the host, stored as f32). The matmuls
  run in f32 whatever the input dtype; the caller casts back.
* ``crop_and_resize`` floors/ceils each box to integer bounds and resizes
  the crop to a square with half-pixel bilinear taps, gathering from a
  ``[B, H, W, C]`` canvas stack by a per-box image index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_weight_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] interpolation matrix (two taps per row)."""
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    w = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    w[rows, lo] += (1.0 - frac).astype(np.float32)
    w[rows, hi] += frac.astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=64)
def _weights(in_size, out_size, align_corners, device: torch.device) -> torch.Tensor:
    """The weight matrix on ``device``, uploaded once: a copy from pageable
    host memory waits for the device's stream on every call. Made outside
    inference mode whatever the caller's mode, so that a matrix first cached
    by an inference pass can be saved for a training backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_bilinear_weight_matrix(in_size, out_size, align_corners).copy()).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize over the trailing (H, W, C) dims of ``x`` (NHWC).

    Returns [..., out_h, out_w, C] in float32 (the JAX package's
    ``promote_types(x.dtype, float32)``).
    """
    return resize_bilinear_nchw(x.movedim(-1, -3), out_hw, align_corners).movedim(-3, -1)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """:func:`resize_bilinear` over the trailing (H, W) dims (NCHW models).

    Rows are resized before columns, as in the NHWC version. Returns f32.
    """
    h, w = x.shape[-2], x.shape[-1]
    wy = _weights(h, out_hw[0], align_corners, x.device)
    wx = _weights(w, out_hw[1], align_corners, x.device)
    y = torch.matmul(wy, x.float())  # [..., out_h, W]
    return torch.matmul(y, wx.t())  # [..., out_h, out_w]


def image_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences as torchmetrics' ``image_gradients``.

    x: [..., H, W]. Returns (dy, dx); the last row of dy and the last
    column of dx are zero.
    """
    dy = torch.zeros_like(x)
    dx = torch.zeros_like(x)
    dy[..., :-1, :] = x[..., 1:, :] - x[..., :-1, :]
    dx[..., :, :-1] = x[..., :, 1:] - x[..., :, :-1]
    return dy, dx


def _crop_sample_coords(lo: torch.Tensor, hi: torch.Tensor, out_size: int, limit: int):
    """Half-pixel sample positions for resizing crop [lo, hi) to out_size.

    lo/hi: [P] float tensors holding the integer crop bounds. Returns
    (i0, i1, frac), each [P, out_size], clamped inside crop and image.
    """
    size = torch.clamp(hi - lo, min=1.0)
    j = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    src = (j + 0.5) * (size[:, None] / out_size) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), size[:, None] - 1.0)
    i0f = torch.floor(src)
    frac = src - i0f
    i0 = i0f.to(torch.int64) + lo[:, None].to(torch.int64)
    i1 = torch.minimum(i0 + 1, (hi[:, None] - 1.0).to(torch.int64))
    return i0.clamp(0, limit - 1), i1.clamp(0, limit - 1), frac


def crop_and_resize(
    image: torch.Tensor,
    boxes: torch.Tensor,
    out_size: int = 128,
    chunk: int = 64,
    image_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Crop ``boxes`` from ``image`` and bilinearly resize each to a square.

    image: [H, W, C] float, or [B, H, W, C] with ``image_idx`` [P] selecting
    each box's source image. boxes: [P, 4] float xyxy. Returns [P, S, S, C]
    float32. Boxes are processed ``chunk`` at a time to bound the
    [chunk, S, S, C] gather.
    """
    if image.ndim == 4:
        if image_idx is None:
            raise ValueError("image_idx required for batched images")
        idx = image_idx.to(torch.int64).clamp(0, image.shape[0] - 1)
    else:
        image = image[None]
        idx = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    _, H, W, C = image.shape
    S = out_size
    boxes = boxes.float()
    iy0, iy1, fy = _crop_sample_coords(torch.floor(boxes[:, 1]), torch.ceil(boxes[:, 3]), S, H)
    ix0, ix1, fx = _crop_sample_coords(torch.floor(boxes[:, 0]), torch.ceil(boxes[:, 2]), S, W)
    out = torch.empty((boxes.shape[0], S, S, C), dtype=torch.float32, device=image.device)
    for s in range(0, boxes.shape[0], chunk):
        e = s + chunk
        b = idx[s:e, None, None]
        y0, y1 = iy0[s:e, :, None], iy1[s:e, :, None]
        x0, x1 = ix0[s:e, None, :], ix1[s:e, None, :]
        wy = fy[s:e, :, None, None]
        # rows first, then columns: the JAX package's arithmetic order
        c0 = image[b, y0, x0].float()
        c0 = c0 + (image[b, y1, x0].float() - c0) * wy
        c1 = image[b, y0, x1].float()
        c1 = c1 + (image[b, y1, x1].float() - c1) * wy
        out[s:e] = c0 + (c1 - c0) * fx[s:e, None, :, None]
    return out


def paste_mask_into_canvas(mask: np.ndarray, box: np.ndarray, canvas_hw: tuple[int, int]) -> np.ndarray:
    """Host-side paste-back of a crop-space mask into a full-image canvas.

    The [s, s] float mask is bilinearly resized (half-pixel taps) to the
    integer box extent and written at (y1:y2, x1:x2); everything outside
    stays zero. The plain version of the host library ``csrc/paste.cpp``.
    """
    Hc, Wc = canvas_hw
    x1, y1 = int(np.floor(box[0])), int(np.floor(box[1]))
    x2, y2 = int(np.ceil(box[2])), int(np.ceil(box[3]))
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, Wc), min(y2, Hc)
    canvas = np.zeros((Hc, Wc), dtype=np.float32)
    bh, bw = y2 - y1, x2 - x1
    if bh <= 0 or bw <= 0:
        return canvas
    wy = _bilinear_weight_matrix(mask.shape[0], bh, align_corners=False)
    wx = _bilinear_weight_matrix(mask.shape[1], bw, align_corners=False)
    canvas[y1:y2, x1:x2] = wy @ mask.astype(np.float32) @ wx.T
    return canvas
