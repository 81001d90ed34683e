"""Existence-classifier training samples (port of the JAX package's
``data/existence.py``), without OpenCV.

Reference ``datasets.py:259-353``: half the samples are RandomResizedCrops
of the image (label 1 iff the bilinearly resized crop of the top-1 mask sums
to more than 1); the other half are the largest inscribed square of the
image's background (1 - union of all VoteCut masks), found by the distance
transform's argmax and radius, always label 0.
"""

from __future__ import annotations

import numpy as np

from unmore_tpu_torch.data.votecut import random_resized_crop_params
from unmore_tpu_torch.ops.labels import distance_transform, resize_linear


def background_square_crop(image: np.ndarray, full_mask: np.ndarray) -> np.ndarray | None:
    """Largest inscribed background square (reference datasets.py:293-323).
    The 10-pixel zero border makes the image's edge count as foreground."""
    bg = (1 - (full_mask > 0)).astype(np.uint8)
    d = distance_transform(np.pad(bg, 10))[10:-10, 10:-10]
    yc, xc = np.unravel_index(int(d.argmax()), d.shape)
    r = d[yc, xc]
    x1, y1, x2, y2 = int(xc - r), int(yc - r), int(xc + r), int(yc + r)
    if x2 <= max(x1, 0) or y2 <= max(y1, 0):
        return None
    crop = image[max(y1, 0) : y2, max(x1, 0) : x2]
    if crop.size == 0:
        return None
    return crop


def classifier_sample(
    image: np.ndarray,
    top1_mask: np.ndarray,
    full_mask: np.ndarray,
    image_size: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, float]:
    """Returns (crop [s,s,3] float32, label). Coin-flips positive vs background."""
    s = image_size
    if rng.random() < 0.5:
        crop = background_square_crop(image, full_mask)
        if crop is not None:
            return resize_linear(crop, (s, s)), 0.0
    h, w = image.shape[:2]
    top, left, ch, cw = random_resized_crop_params(rng, h, w)
    img_crop = resize_linear(image[top : top + ch, left : left + cw], (s, s))
    # the reference crops the *float* mask jointly and resizes bilinearly,
    # then labels on sum > 1 (datasets.py:338-346)
    mask_crop = resize_linear(top1_mask[top : top + ch, left : left + cw].astype(np.float32), (s, s))
    label = 1.0 if mask_crop.sum() > 1 else 0.0
    return img_crop, label
