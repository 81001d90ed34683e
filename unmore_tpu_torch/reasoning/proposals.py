"""Multi-scale grid proposal seeding.

Deterministic given the image size; matches reference
``object_reasoning.py:109-137`` exactly: for each grid size g in
{32, 64, 128, 256, 512}, centers at every g-step of the image plane and
three anchors per center (square 2gx2g, tall gx2g, wide 2gxg), clipped
to the image, plus the full-image box.
"""

from __future__ import annotations

import numpy as np

GRID_SIZES = (32, 64, 128, 256, 512)


def seed_proposals(height: int, width: int) -> np.ndarray:
    """[P, 4] float64 xyxy proposals for an image of the given size."""
    out = []
    for g in GRID_SIZES:
        cy = np.arange(0, height, g, dtype=np.int64)
        cx = np.arange(0, width, g, dtype=np.int64)
        xc, yc = np.meshgrid(cx, cy)
        centers = np.stack([xc.ravel(), yc.ravel(), xc.ravel(), yc.ravel()], axis=1).astype(np.float64)
        anchors = np.array(
            [
                [-g, -g, g, g],
                [-g / 2, -g, g / 2, g],
                [-g, -g / 2, g, g / 2],
            ],
            dtype=np.float64,
        )
        boxes = (centers[:, None, :] + anchors[None, :, :]).reshape(-1, 4)
        out.append(boxes)
    boxes = np.concatenate(out, axis=0)
    boxes[:, 0] = np.maximum(boxes[:, 0], 0)
    boxes[:, 1] = np.maximum(boxes[:, 1], 0)
    boxes[:, 2] = np.minimum(boxes[:, 2], width)
    boxes[:, 3] = np.minimum(boxes[:, 3], height)
    boxes = np.concatenate([boxes, [[0, 0, width, height]]], axis=0)
    return boxes


def max_seed_count(max_height: int, max_width: int) -> int:
    """Upper bound on seed proposals for any image up to the given size."""
    n = 1
    for g in GRID_SIZES:
        n += 3 * int(np.ceil(max_height / g)) * int(np.ceil(max_width / g))
    return n
