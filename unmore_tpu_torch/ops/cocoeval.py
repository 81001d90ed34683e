"""The COCO evaluator's hot loops on the host: mask IoU over RLEs and the
greedy detection-to-GT matching.

``csrc/cocoeval.cpp`` (built by :mod:`~unmore_tpu_torch.ops.cuda_build` with
``g++`` at first use, bound here with ``ctypes``) computes both. A failed
build raises; there is no silent fallback to Python.

The plain versions, :func:`mask_iou_plain` (decoded bitmaps, numpy) and
:func:`coco_match_plain` (the same loop in Python), give the same numbers;
only the tests and ``chip_smoke.py`` use them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from unmore_tpu_torch.ops.cuda_build import load_library
from unmore_tpu_torch.utils import rle

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = load_library("cocoeval")
    lib.rle_decode_counts.restype = _i64
    lib.rle_decode_counts.argtypes = [ctypes.c_char_p, _i64, _ptr]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [_ptr, _ptr, _i64, _ptr, _ptr, _i64, _ptr, _ptr]
    lib.coco_match.restype = None
    lib.coco_match.argtypes = [_ptr, _i64, _i64, _ptr, _ptr, _ptr, _i64, _ptr, _ptr]
    return lib


def _runs(lib, r: dict) -> np.ndarray:
    counts = r["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):  # uncompressed RLE
        return np.ascontiguousarray(counts, np.int64)
    s = counts.encode("ascii") if isinstance(counts, str) else bytes(counts)
    runs = np.empty(len(s) + 1, np.int64)
    return runs[: lib.rle_decode_counts(s, len(s), runs.ctypes.data)]


def _packed(lib, rles):
    runs = [_runs(lib, r) for r in rles]
    offs = np.zeros(len(runs) + 1, np.int64)
    offs[1:] = np.cumsum([len(r) for r in runs])
    flat = np.concatenate(runs) if runs else np.zeros(0, np.int64)
    return np.ascontiguousarray(flat, np.int64), offs


def mask_iou(rles_a: list[dict], rles_b: list[dict], iscrowd=None) -> np.ndarray:
    """IoU matrix [len(a), len(b)] of COCO RLEs; a crowd column (``iscrowd[j]``)
    divides by the area of the ``a`` mask alone."""
    out = np.zeros((len(rles_a), len(rles_b)), np.float64)
    if not len(rles_a) or not len(rles_b):
        return out
    lib = _load_library()
    (ra, oa), (rb, ob) = _packed(lib, rles_a), _packed(lib, rles_b)
    crowd = np.ascontiguousarray(np.zeros(len(rles_b)) if iscrowd is None else iscrowd, np.int32)
    lib.rle_iou_matrix(ra.ctypes.data, oa.ctypes.data, len(rles_a), rb.ctypes.data, ob.ctypes.data,
                       len(rles_b), crowd.ctypes.data, out.ctypes.data)
    return out


def coco_match(ious: np.ndarray, gt_ig: np.ndarray, iscrowd: np.ndarray, thrs: np.ndarray):
    """Greedy COCO matching over T thresholds.

    ious [D, G] (detections by descending score, ignored GTs last); gt_ig and
    iscrowd [G]; thrs [T]. Returns (dtm [T, D] int64 in {0, 1}, dt_ignore
    [T, D] float64).
    """
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ig = np.ascontiguousarray(gt_ig, np.int32)
    iscrowd = np.ascontiguousarray(iscrowd, np.int32)
    thrs = np.ascontiguousarray(thrs, np.float64)
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int64)
    dt_ignore = np.zeros((T, D), np.float64)
    _load_library().coco_match(ious.ctypes.data, D, G, gt_ig.ctypes.data, iscrowd.ctypes.data, thrs.ctypes.data,
                               T, dtm.ctypes.data, dt_ignore.ctypes.data)
    return dtm, dt_ignore


# ------------------------------------------------------------ plain versions
def mask_iou_plain(rles_a: list[dict], rles_b: list[dict], iscrowd=None) -> np.ndarray:
    """:func:`mask_iou` on decoded bitmaps."""
    return rle.iou(rles_a, rles_b, iscrowd=iscrowd)


def coco_match_plain(ious: np.ndarray, gt_ig: np.ndarray, iscrowd: np.ndarray, thrs: np.ndarray):
    """:func:`coco_match` as a Python loop."""
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int64)
    dt_ignore = np.zeros((T, D))
    gtm = np.zeros((T, G), np.int64)
    for t, thr in enumerate(thrs):
        for i in range(D):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for j in range(G):
                if gtm[t, j] > 0 and not iscrowd[j]:
                    continue
                if m > -1 and gt_ig[m] == 0 and gt_ig[j] == 1:
                    break  # the remaining GTs are ignored; keep the real match
                if ious[i, j] < best_iou:
                    continue
                best_iou = ious[i, j]
                m = j
            if m == -1:
                continue
            dt_ignore[t, i] = gt_ig[m]
            dtm[t, i] = 1
            gtm[t, m] = 1
    return dtm, dt_ignore
