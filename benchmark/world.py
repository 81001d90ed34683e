"""Seeded inputs: discovery scenes, the benchmark's own data, made in
numpy from a seed and handed alike to the system and to the reference.
``scenes`` is the discovery smoke's generator (flat-coloured rectangles and
discs on a noisy background) with numpy's ``Generator`` in place of
``RandomState``, so that any whole seed works.
"""

from __future__ import annotations

import numpy as np


def key(seed: int, *more: int) -> list[int]:
    """A ``SeedSequence`` entropy for ``seed`` (any whole number) and ``more``."""
    return [seed % 2**64, *more]


def scenes(seed: int, index: int, sizes, n_shapes: int = 5):
    """The uint8 [h, w, 3] scenes of group ``index`` of the traffic drawn
    from ``seed``: one per (h, w) in ``sizes``."""
    rng = np.random.default_rng(key(seed, index))
    out = []
    for h, w in sizes:
        img = (rng.random((h, w, 3)) * 40 + 100).astype(np.float32)
        yy, xx = np.mgrid[:h, :w]
        for _ in range(n_shapes):
            colour = rng.random(3) * 255
            cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
            r = rng.integers(15, 60)
            if rng.random() < 0.5:
                sel = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r * 0.7)
            else:
                sel = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[sel] = colour
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out
