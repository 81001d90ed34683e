"""Anchor generation (detectron2 DefaultAnchorGenerator semantics; a copy of
``detector/anchors.py``).

Grid anchors per FPN level: sizes [[32],[64],[128],[256],[512]] for
P2..P6, aspect ratios (0.5, 1.0, 2.0), offset 0 — matching the CAD
Base-RCNN-FPN config so converted RPN weights see identical anchors.
Anchors of a level run over the grid row by row, then over the three
aspect ratios: the order of the RPN's outputs flattened NHWC
(``detector/rpn.py``).
"""

from __future__ import annotations

import numpy as np

ASPECT_RATIOS = (0.5, 1.0, 2.0)
LEVEL_SIZES = (32, 64, 128, 256, 512)
LEVEL_STRIDES = (4, 8, 16, 32, 64)


def cell_anchors(size: float, ratios=ASPECT_RATIOS) -> np.ndarray:
    """[A, 4] xyxy anchors centered at (0, 0)."""
    out = []
    area = size * size
    for r in ratios:
        w = np.sqrt(area / r)
        h = w * r
        out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, size: float) -> np.ndarray:
    """[H*W*A, 4] anchors for one level (row-major over the grid)."""
    cell = cell_anchors(size)  # [A, 4]
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    gx, gy = np.meshgrid(xs, ys)
    shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)  # [HW, 1, 4]
    return (shifts + cell[None]).reshape(-1, 4)


def fpn_anchors(image_size: int, levels=(2, 3, 4, 5, 6)) -> list[np.ndarray]:
    """Per-level anchors for a square padded image of ``image_size``."""
    out = []
    for li, lvl in enumerate(levels):
        stride = LEVEL_STRIDES[li]
        fh = fw = int(np.ceil(image_size / stride))
        out.append(grid_anchors(fh, fw, stride, LEVEL_SIZES[li]))
    return out
