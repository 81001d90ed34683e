"""COCO run-length mask codec in plain numpy (port of ``utils/rle.py``).

Byte-compatible with pycocotools' ``maskApi.c`` format, so the scoring
JSON interoperates with the reference tooling: column-major runs starting
with background, counts serialized as signed base-32 chars (offset 48)
with second-order deltas from the third run on.

The host libraries ``csrc/paste.cpp`` (:mod:`unmore_tpu_torch.ops.paste`)
and ``csrc/cocoeval.cpp`` (:mod:`unmore_tpu_torch.ops.cocoeval`) emit and
read the same format; this module is their plain version, and the tests
decode segmentations with it.
"""

from __future__ import annotations

import numpy as np


def mask_to_runs(mask: np.ndarray) -> np.ndarray:
    """Binary [H, W] mask -> run lengths in Fortran order, starting with 0s."""
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [n]])
    runs = np.diff(bounds)
    if flat[0] == 1:  # must start with a (possibly zero) background run
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def runs_to_mask(runs: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    h, w = size
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for r in runs:
        if val:
            flat[pos : pos + int(r)] = 1
        pos += int(r)
        val ^= 1
    return flat.reshape((h, w), order="F")


def encode_counts(runs: np.ndarray) -> str:
    """Serialize run lengths to the COCO counts string."""
    out = []
    runs = [int(r) for r in runs]
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        while True:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
            if not more:
                break
    return "".join(out)


def decode_counts(s: str) -> np.ndarray:
    runs = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * (k + 1))  # sign extension
                break
            k += 1
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return np.asarray(runs, np.int64)


def encode(mask: np.ndarray) -> dict:
    """Binary [H, W] mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts(mask_to_runs(mask))}


def decode(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):  # uncompressed RLE
        runs = np.asarray(counts, np.int64)
    else:
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        runs = decode_counts(counts)
    return runs_to_mask(runs, tuple(rle["size"]))


def area(rle: dict) -> int:
    counts = rle["counts"]
    runs = (
        np.asarray(counts, np.int64)
        if isinstance(counts, (list, tuple, np.ndarray))
        else decode_counts(counts if isinstance(counts, str) else counts.decode("ascii"))
    )
    return int(runs[1::2].sum())


def to_bbox(rle: dict) -> list[float]:
    """Tight xywh bbox of an RLE mask (pycocotools ``toBbox`` semantics:
    zero-area masks give [0,0,0,0])."""
    mask = decode(rle)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def iou(rles_a: list[dict], rles_b: list[dict], iscrowd=None) -> np.ndarray:
    """Mask IoU matrix [len(a), len(b)]; crowd columns use intersection/area_a."""
    out = np.zeros((len(rles_a), len(rles_b)), np.float64)
    masks_a = [decode(r).astype(bool) for r in rles_a]
    masks_b = [decode(r).astype(bool) for r in rles_b]
    for j, mb in enumerate(masks_b):
        crowd = bool(iscrowd[j]) if iscrowd is not None else False
        for i, ma in enumerate(masks_a):
            inter = np.logical_and(ma, mb).sum()
            if crowd:
                denom = ma.sum()
            else:
                denom = ma.sum() + mb.sum() - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out
