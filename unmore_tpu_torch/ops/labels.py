"""Stage-1 label synthesis on the host: OpenCV's distance transform and
resizes without OpenCV.

The functions run ``csrc/labels.cpp``, built by
:mod:`~unmore_tpu_torch.ops.cuda_build` with ``g++`` at first use and bound
here with ``ctypes`` (which releases the interpreter lock during a call, as
OpenCV's functions do, so the stage-1 prefetch threads synthesize labels
beside the thread that launches the training kernels). A failed build
raises; there is no silent fallback.

* :func:`distance_transform` is ``cv2.distanceTransform(mask, DIST_L2, 3)``:
  the two-pass 3x3 chamfer (edge step 0.955, diagonal step 1.3693, float32
  running sums, pixels outside the image counted as foreground). OpenCV
  (through Intel IPP) keeps some of its running sums more exactly than
  sequential float32 additions: on a few percent of pixels the two differ,
  by up to ~2.6e-6 of the largest distance.
* :func:`resize_linear` is ``cv2.resize(x, (w, h), INTER_LINEAR)`` of a
  float32 [H, W] or [H, W, C] array (within 2e-7 of OpenCV);
  :func:`resize_linear_u8` is INTER_LINEAR of uint8, which OpenCV computes
  in fixed point (the detector's eval images; equal to OpenCV);
  :func:`resize_nearest` is INTER_NEAREST of a uint8 [H, W] array (equal).

Each has a plain numpy version (``*_plain``) with the same float32
operations in the same order, so that it gives the library's bits; only the
tests use them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from unmore_tpu_torch.ops.cuda_build import load_library

EDGE = np.float32(0.955)
DIAG = np.float32(1.3693)
FAR = np.float32(np.finfo(np.float32).max)

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = load_library("labels")
    lib.chamfer_distance_3x3.restype = None
    lib.chamfer_distance_3x3.argtypes = [_ptr, _i64, _i64, _ptr]
    lib.resize_linear_f32.restype = None
    lib.resize_linear_f32.argtypes = [_ptr, _i64, _i64, _i64, _i64, _ptr, _i64, _i64]
    lib.resize_linear_u8.restype = None
    lib.resize_linear_u8.argtypes = [_ptr, _i64, _i64, _i64, _i64, _ptr, _i64, _i64]
    lib.resize_nearest_u8.restype = None
    lib.resize_nearest_u8.argtypes = [_ptr, _i64, _i64, _i64, _ptr, _i64, _i64]
    return lib


def _as_mask(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be [H, W], got {mask.shape}")
    return mask if mask.dtype == np.uint8 else (mask != 0).astype(np.uint8)


def _rows(x: np.ndarray, dtype) -> tuple[np.ndarray, int]:
    """``x`` as ``dtype`` whose rows may be strided but whose pixels are
    packed (a crop of a C-ordered image passes without a copy), and its row
    stride in elements."""
    x = np.asarray(x, dtype)
    item = x.dtype.itemsize
    packed = x.ndim in (2, 3) and x.strides[-1] == item and (x.ndim == 2 or x.strides[1] == x.shape[2] * item)
    if not packed or x.strides[0] % item or x.strides[0] < x.shape[1] * (x.shape[2] if x.ndim == 3 else 1) * item:
        x = np.ascontiguousarray(x)
    return x, x.strides[0] // item


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """[H, W] mask (nonzero = foreground) -> [H, W] float32 distances to the
    nearest zero pixel (FLT_MAX everywhere when there is none)."""
    mask = _as_mask(mask)
    out = np.empty(mask.shape, np.float32)
    if mask.size:
        _load_library().chamfer_distance_3x3(mask.ctypes.data, mask.shape[0], mask.shape[1], out.ctypes.data)
    return out


def resize_linear(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=INTER_LINEAR)`` of a float32
    [H, W] or [H, W, C] array."""
    if x.ndim not in (2, 3) or 0 in x.shape:
        raise ValueError(f"resize_linear takes a non-empty [H, W] or [H, W, C] array, got {x.shape}")
    x, row = _rows(x, np.float32)
    c = x.shape[2] if x.ndim == 3 else 1
    out = np.empty((hw[0], hw[1], c) if x.ndim == 3 else tuple(hw), np.float32)
    _load_library().resize_linear_f32(x.ctypes.data, x.shape[0], x.shape[1], c, row, out.ctypes.data, hw[0], hw[1])
    return out


def resize_linear_u8(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=INTER_LINEAR)`` of a uint8
    [H, W] or [H, W, C] array, bit for bit: OpenCV's fixed-point path (and
    its INTER_AREA for an exact 2x downscale)."""
    if x.ndim not in (2, 3) or 0 in x.shape:
        raise ValueError(f"resize_linear_u8 takes a non-empty [H, W] or [H, W, C] array, got {x.shape}")
    x, row = _rows(x, np.uint8)
    c = x.shape[2] if x.ndim == 3 else 1
    out = np.empty((hw[0], hw[1], c) if x.ndim == 3 else tuple(hw), np.uint8)
    _load_library().resize_linear_u8(x.ctypes.data, x.shape[0], x.shape[1], c, row, out.ctypes.data, hw[0], hw[1])
    return out


def resize_nearest(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=INTER_NEAREST)`` of a uint8 [H, W] array."""
    if x.ndim != 2 or 0 in x.shape:
        raise ValueError(f"resize_nearest takes a non-empty [H, W] array, got {x.shape}")
    x, row = _rows(x, np.uint8)
    out = np.empty(tuple(hw), np.uint8)
    _load_library().resize_nearest_u8(x.ctypes.data, x.shape[0], x.shape[1], row, out.ctypes.data, hw[0], hw[1])
    return out


# ------------------------------------------------------------ plain versions
def distance_transform_plain(mask: np.ndarray) -> np.ndarray:
    """:func:`distance_transform` row by row in numpy."""
    mask = _as_mask(mask)
    h, w = mask.shape
    t = np.full((h + 2, w + 2), FAR, np.float32)
    for i in range(h):  # forward: up-left, up, up-right, then left in sequence
        up = t[i]
        above = np.minimum(np.minimum(up[:-2] + DIAG, up[1:-1] + EDGE), up[2:] + DIAG)
        row = t[i + 1]
        for j in range(w):
            row[j + 1] = np.float32(0) if not mask[i, j] else min(above[j], row[j] + EDGE)
    for i in range(h - 1, -1, -1):  # backward: down-right, down, down-left, then right in sequence
        down = t[i + 2]
        below = np.minimum(np.minimum(down[2:] + DIAG, down[1:-1] + EDGE), down[:-2] + DIAG)
        row = t[i + 1]
        for j in range(w - 1, -1, -1):
            if row[j + 1] > EDGE:
                row[j + 1] = min(row[j + 1], below[j], row[j + 2] + EDGE)
    return t[1:-1, 1:-1].copy()


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: (i0, i1, w0, w1)."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1) - frac, frac


def resize_linear_plain(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """:func:`resize_linear` in numpy: columns blended, then rows."""
    x = np.asarray(x, np.float32)
    y0, y1, wy0, wy1 = _linear_taps(x.shape[0], hw[0])
    x0, x1, wx0, wx1 = _linear_taps(x.shape[1], hw[1])
    col = (1, -1) + (1,) * (x.ndim - 2)
    rows = x[:, x0] * wx0.reshape(col) + x[:, x1] * wx1.reshape(col)
    row = (-1,) + (1,) * (x.ndim - 1)
    return rows[y0] * wy0.reshape(row) + rows[y1] * wy1.reshape(row)


def _fixed_taps(src: int, dst: int, clamp_edges: bool):
    """OpenCV's fixed-point INTER_LINEAR taps along one axis: (i0, w0, w1)."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    pos = pos - i0.astype(np.float32)
    if clamp_edges:
        out = (i0 < 0) | (i0 >= src - 1)
        pos[out] = 0.0
        i0 = np.clip(i0, 0, src - 1)
    w0 = np.rint((np.float32(1) - pos) * np.float32(2048)).astype(np.int64)
    return i0, w0, np.rint(pos * np.float32(2048)).astype(np.int64)


def resize_linear_u8_plain(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """:func:`resize_linear_u8` in numpy (int64 arithmetic)."""
    h, w = x.shape[:2]
    if (h, w) == (2 * hw[0], 2 * hw[1]):
        v = x.astype(np.int64)
        return ((v[0::2, 0::2] + v[0::2, 1::2] + v[1::2, 0::2] + v[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    x0, ax0, ax1 = _fixed_taps(w, hw[1], True)
    y0, by0, by1 = _fixed_taps(h, hw[0], False)
    col = (1, -1) + (1,) * (x.ndim - 2)
    v = x.astype(np.int64)
    rows = v[:, x0] * ax0.reshape(col) + v[:, np.minimum(x0 + 1, w - 1)] * ax1.reshape(col)
    row = (-1,) + (1,) * (x.ndim - 1)
    t = (((rows[np.clip(y0, 0, h - 1)] >> 4) * by0.reshape(row)) >> 16) + \
        (((rows[np.clip(y0 + 1, 0, h - 1)] >> 4) * by1.reshape(row)) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def resize_nearest_plain(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """:func:`resize_nearest` in numpy."""
    return x[_nearest_index(x.shape[0], hw[0])][:, _nearest_index(x.shape[1], hw[1])]
