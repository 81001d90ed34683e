"""Stage-1 ground-truth synthesis from VoteCut pseudo-masks (port of the JAX
package's ``data/votecut.py``), on the host, without OpenCV.

* resize image and mask to 400 (bilinear / nearest); the foreground SDF at
  400 is the chamfer distance transform (OpenCV's ``DIST_L2, maskSize=3``)
  normalized by its max;
* one RandomResizedCrop (scale [0.08, 1], ratio [3/4, 4/3]) applied jointly
  to image, SDF and mask, then a resize to ``image_size`` (bilinear for
  image and SDF, nearest for the mask);
* with ``use_bg_sdf``: minus the normalized background SDF at crop size;
* center field: L2-normalized (grid - object center), (dy, dx), masked to
  the foreground; the center is the *pre-crop* mask's box center mapped
  through the crop.

The distance transform and the resizes are OpenCV's, in the port's host
library (:mod:`~unmore_tpu_torch.ops.labels`): INTER_LINEAR with OpenCV's
taps (positions and fractions in float64; within 2e-7, where
``F.interpolate``'s float32 positions drift by up to 2e-5 on upscales),
INTER_NEAREST with OpenCV's index rule. :func:`random_resized_crop_params`
is numpy only, so one ``np.random.Generator`` draws the same crops in both
packages.

Images decode with PIL (imported where a file is read; without it those
functions raise). PNG files decode to the same pixels as OpenCV; JPEG
decoders may differ by a few levels between libjpeg builds.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from unmore_tpu_torch.ops.labels import distance_transform, resize_linear, resize_nearest


@dataclasses.dataclass
class Sample:
    image: np.ndarray  # [H, W, 3] float32 in [0,1]
    center_field: np.ndarray  # [H, W, 2] (dy, dx)
    sdf: np.ndarray  # [H, W]
    saliency_mask: np.ndarray  # [H, W] {0,1} float32
    object_center: np.ndarray  # [2] (x, y) in output coords


def random_resized_crop_params(
    rng: np.random.Generator, h: int, w: int,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> tuple[int, int, int, int]:
    """(top, left, height, width), torchvision RandomResizedCrop.get_params."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop at the clamped ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return top, left, ch, cw


def _normalized_edt(mask: np.ndarray) -> np.ndarray:
    d = distance_transform(mask.astype(np.uint8))
    m = d.max()
    return d / m if m > 0 else d


def synthesize_labels(
    image: np.ndarray,
    mask: np.ndarray,
    image_size: int = 128,
    use_bg_sdf: bool = True,
    rng: np.random.Generator | None = None,
    random_crop: bool = True,
    crop_scale=(0.08, 1.0),
    pre_resize: int = 400,
) -> Sample | None:
    """image [H,W,3] float32 [0,1]; mask [H,W] {0,1}. None if mask empty."""
    if mask.max() == 0:
        return None
    s = image_size
    image = resize_linear(image, (pre_resize, pre_resize))
    mask = resize_nearest(mask.astype(np.uint8), (pre_resize, pre_resize))
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    obj_cx = (xs.min() + xs.max()) / 2.0
    obj_cy = (ys.min() + ys.max()) / 2.0

    sdf = _normalized_edt(mask)

    if random_crop:
        rng = rng or np.random.default_rng()
        top, left, ch, cw = random_resized_crop_params(rng, pre_resize, pre_resize, scale=crop_scale)
        image = image[top : top + ch, left : left + cw]
        sdf = sdf[top : top + ch, left : left + cw]
        mask = mask[top : top + ch, left : left + cw]
        center = np.array([(obj_cx - left) * (s / cw), (obj_cy - top) * (s / ch)], np.float32)
    else:
        center = np.array([obj_cx * (s / pre_resize), obj_cy * (s / pre_resize)], np.float32)

    image = resize_linear(image, (s, s))
    sdf = resize_linear(sdf, (s, s))
    mask = resize_nearest(mask, (s, s))

    if use_bg_sdf:
        bg = (mask == 0).astype(np.uint8)
        sdf = sdf - _normalized_edt(bg)

    yy, xx = np.meshgrid(np.arange(s, dtype=np.float32), np.arange(s, dtype=np.float32), indexing="ij")
    field = np.stack([yy - center[1], xx - center[0]], axis=-1)
    norm = np.linalg.norm(field, axis=-1, keepdims=True)
    field = field / np.maximum(norm, 1e-12)
    field = field * (mask > 0)[..., None]

    return Sample(
        image=image.astype(np.float32),
        center_field=field.astype(np.float32),
        sdf=sdf.astype(np.float32),
        saliency_mask=(mask > 0).astype(np.float32),
        object_center=center,
    )


def _read_image(path: str, mode: str) -> np.ndarray | None:
    """Decode ``path`` with PIL as ``mode`` ("RGB" or "L"), with the EXIF
    orientation applied as OpenCV's imread applies it; None if unreadable."""
    try:
        from PIL import Image, ImageOps
    except ImportError as exc:
        raise ImportError("reading stage-1 images needs the Pillow package (PIL)") from exc
    if not os.path.isfile(path):
        return None
    try:
        with Image.open(path) as img:
            return np.asarray(ImageOps.exif_transpose(img).convert(mode), np.uint8)
    except OSError:  # not an image PIL can decode: OpenCV's imread gives None too
        return None


def load_mask(mask_path: str, image_hw) -> np.ndarray | None:
    """Mask-only load with the reference conventions (datasets.py:114-131):
    rotate 90° clockwise on a shape mismatch, dual binarization."""
    gray = _read_image(mask_path, "L")
    if gray is None:
        return None
    if gray.shape[:2] != tuple(image_hw):
        gray = np.rot90(gray, k=-1)
    if gray.max() > 128:
        return (gray > 0).astype(np.uint8)
    return (gray == 1).astype(np.uint8)


def load_image_mask_pair(image_path: str, mask_path: str):
    """(image [H,W,3] float32 RGB in [0,1], mask [H,W] uint8), or (None, None)."""
    rgb = _read_image(image_path, "RGB")
    if rgb is None:
        return None, None
    image = rgb.astype(np.float32) / 255.0
    mask = load_mask(mask_path, image.shape[:2])
    if mask is None:
        return None, None
    return image, mask


class VoteCutObjectnessDataset:
    """Directory-backed dataset: mask_dir/<class>/<name>.png paired with
    image_dir/<class>/<name>.JPEG (reference datasets.py:85-93)."""

    def __init__(self, image_dir: str, mask_dir: str, image_size=128, use_bg_sdf=True,
                 crop_scale=(0.08, 1.0), seed=0, shuffle=True):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_size = image_size
        self.use_bg_sdf = use_bg_sdf
        self.crop_scale = crop_scale
        names = []
        for cls in sorted(os.listdir(mask_dir)):
            sub = os.path.join(mask_dir, cls)
            if not os.path.isdir(sub):
                continue
            names.extend(os.path.join(cls, f) for f in sorted(os.listdir(sub)))
        self.names = names
        self.rng = np.random.default_rng(seed)
        if shuffle:
            self.rng.shuffle(self.names)

    def __len__(self):
        return len(self.names)

    def get(self, idx: int, random_crop=True) -> Sample | None:
        name = self.names[idx]
        image, mask = load_image_mask_pair(
            os.path.join(self.image_dir, name.replace(".png", ".JPEG")),
            os.path.join(self.mask_dir, name.replace(".JPEG", ".png")),
        )
        if image is None:
            return None
        return synthesize_labels(
            image, mask, self.image_size, self.use_bg_sdf, self.rng,
            random_crop=random_crop, crop_scale=self.crop_scale,
        )


def batch_iterator(sample_fn, num_samples: int, batch_size: int, rng: np.random.Generator):
    """Infinite fixed-shape batches of valid samples (FG and BG both present),
    in the wire format the trainer decodes on the card: uint8 images, float16
    center fields and SDF, uint8 mask."""
    while True:
        batch = []
        while len(batch) < batch_size:
            s = sample_fn(int(rng.integers(0, num_samples)))
            if s is None:
                continue
            fg = s.saliency_mask.sum()
            if fg == 0 or fg == s.saliency_mask.size:
                continue  # the reference drops no-FG and all-FG samples
            batch.append(s)
        images = np.stack([s.image for s in batch])
        if images.dtype != np.uint8:
            images = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
        yield {
            "image": images,
            "center_field": np.stack([s.center_field for s in batch]).astype(np.float16),
            "sdf": np.stack([s.sdf for s in batch]).astype(np.float16),
            "saliency_mask": np.stack([s.saliency_mask for s in batch]).astype(np.uint8),
        }
