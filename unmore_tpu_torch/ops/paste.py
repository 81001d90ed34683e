"""Paste-back of crop-space masks for stage-2 scoring and the detector, on
the host.

``csrc/paste.cpp`` (built by :mod:`~unmore_tpu_torch.ops.cuda_build` with
``g++`` at first use, bound here with ``ctypes``) gives the tight box, the
area and the COCO RLE of a crop's union mask pasted into its image, and
the RLE of a detector mask's probabilities pasted and thresholded, from the
paste geometry alone: no full-image canvas is materialized. A failed build
raises; there is no silent fallback.

The plain versions, :func:`paste_stats_plain`, :func:`paste_rle_plain` and
:func:`paste_prob_rle_plain`, paste with
:func:`~unmore_tpu_torch.ops.image.paste_mask_into_canvas` and encode with
:mod:`unmore_tpu_torch.utils.rle`; only the tests and ``chip_smoke.py`` use
them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from unmore_tpu_torch.ops.cuda_build import load_library
from unmore_tpu_torch.ops.image import paste_mask_into_canvas
from unmore_tpu_torch.utils import rle

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = load_library("paste")
    lib.rle_encode_counts.restype = _i64
    lib.rle_encode_counts.argtypes = [_i64p, _i64, ctypes.c_char_p]
    lib.paste_support_stats.restype = None
    lib.paste_support_stats.argtypes = [_u8p, _i64, _i64, _i64, _f32p, _i64, _i64, _f32p, _i64p]
    lib.paste_support_rle.restype = _i64
    lib.paste_support_rle.argtypes = [_u8p, _i64, _i64, _f32p, _i64, _i64, _i64p]
    lib.paste_prob_rle.restype = _i64
    lib.paste_prob_rle.argtypes = [_f32p, _i64, _i64, _f32p, _i64, _i64, ctypes.c_float, _i64p]
    return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _masks_and_boxes(masks, boxes):
    masks = np.ascontiguousarray(masks, np.uint8)
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    if masks.ndim != 3 or len(masks) != len(boxes):
        raise ValueError(f"masks {masks.shape} and boxes {boxes.shape} do not pair up")
    return masks, boxes


def paste_stats(masks: np.ndarray, boxes: np.ndarray, h: int, w: int):
    """Tight boxes and areas of crop-space masks pasted into an (h, w) image.

    masks: [N, s, s] uint8; boxes: [N, 4] float xyxy (paste locations).
    Returns (tight [N, 4] float32 xyxy with the xmax+1 convention, areas
    [N] int64). An empty paste gives an all-zero tight box and area 0.
    """
    masks, boxes = _masks_and_boxes(masks, boxes)
    n = len(masks)
    tight = np.zeros((n, 4), np.float32)
    areas = np.zeros((n,), np.int64)
    if n:
        _load_library().paste_support_stats(
            _ptr(masks, _u8p), n, masks.shape[1], masks.shape[2],
            _ptr(boxes, _f32p), h, w, _ptr(tight, _f32p), _ptr(areas, _i64p),
        )
    return tight, areas


def paste_rle(mask: np.ndarray, box: np.ndarray, h: int, w: int) -> dict:
    """COCO RLE of a crop-space mask [s, s] pasted into an (h, w) image at
    ``box``, emitted straight from the paste geometry."""
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"mask must be [s, s], got {mask.shape}")
    box = np.ascontiguousarray(np.asarray(box, np.float32).reshape(-1)[:4])
    lib = _load_library()
    runs = np.empty(h * w + 1, np.int64)
    m = lib.paste_support_rle(_ptr(mask, _u8p), mask.shape[0], mask.shape[1], _ptr(box, _f32p), h, w,
                              _ptr(runs, _i64p))
    buf = ctypes.create_string_buffer(int(m) * 7 + 1)
    n = lib.rle_encode_counts(_ptr(runs, _i64p), m, buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:n].decode("ascii")}


def paste_prob_rle(prob: np.ndarray, box: np.ndarray, h: int, w: int, thresh: float = 0.5) -> dict:
    """COCO RLE of ``paste_mask_into_canvas(prob, box, (h, w)) > thresh``
    for a crop-space probability mask [s, s] (the detector's masks), emitted
    without a full canvas."""
    prob = np.ascontiguousarray(prob, np.float32)
    if prob.ndim != 2:
        raise ValueError(f"prob must be [s, s], got {prob.shape}")
    box = np.ascontiguousarray(np.asarray(box, np.float32).reshape(-1)[:4])
    lib = _load_library()
    runs = np.empty(h * w + 1, np.int64)
    m = lib.paste_prob_rle(_ptr(prob, _f32p), prob.shape[0], prob.shape[1], _ptr(box, _f32p), h, w, thresh,
                           _ptr(runs, _i64p))
    buf = ctypes.create_string_buffer(int(m) * 7 + 1)
    n = lib.rle_encode_counts(_ptr(runs, _i64p), m, buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:n].decode("ascii")}


def paste_prob_rle_plain(prob: np.ndarray, box: np.ndarray, h: int, w: int, thresh: float = 0.5) -> dict:
    """:func:`paste_prob_rle` by pasting into a full canvas and encoding it."""
    pasted = paste_mask_into_canvas(np.asarray(prob, np.float32), np.asarray(box, np.float32), (h, w))
    return rle.encode((pasted > thresh).astype(np.uint8))


def paste_stats_plain(masks: np.ndarray, boxes: np.ndarray, h: int, w: int):
    """:func:`paste_stats` by pasting every mask into a full canvas."""
    masks, boxes = _masks_and_boxes(masks, boxes)
    tight = np.zeros((len(masks), 4), np.float32)
    areas = np.zeros((len(masks),), np.int64)
    for b in range(len(masks)):
        ys, xs = np.nonzero(paste_mask_into_canvas(masks[b].astype(np.float32), boxes[b], (h, w)) > 0)
        areas[b] = len(ys)
        if len(ys):
            tight[b] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return tight, areas


def paste_rle_plain(mask: np.ndarray, box: np.ndarray, h: int, w: int) -> dict:
    """:func:`paste_rle` by pasting into a full canvas and encoding it."""
    support = paste_mask_into_canvas(np.asarray(mask, np.float32), np.asarray(box, np.float32), (h, w)) > 0
    return rle.encode(support.astype(np.uint8))
