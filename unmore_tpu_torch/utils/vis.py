"""Diagnostic images of stage-1 training (port of the JAX package's
``utils/vis.py``), without OpenCV.

Colour maps in numpy, PNG files through PIL (imported where a file is
written). Center fields as HSV direction wheels (hue = angle, saturation =
norm), SDF maps blue-negative / red-positive, masks and anti-center maps in
gray. Written by ``--visualize_every`` and ``--eval_mode`` of the stage-1
CLI.
"""

from __future__ import annotations

import os

import numpy as np

from unmore_tpu_torch.ops.fields import _anti_center_kernel


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Vectorized HSV -> RGB, all in [0, 1]."""
    i = np.floor(h * 6.0).astype(np.int64) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def center_field_to_rgb(field: np.ndarray) -> np.ndarray:
    """[H, W, 2] (dy, dx) -> uint8 RGB direction wheel."""
    angle = (np.arctan2(field[..., 0], field[..., 1]) + np.pi) / (2 * np.pi)  # [0, 1]
    norm = np.clip(np.linalg.norm(field, axis=-1), 0, 1)
    return (_hsv_to_rgb(angle % 1.0, norm, np.ones_like(norm)) * 255).astype(np.uint8)


def sdf_to_rgb(sdf: np.ndarray) -> np.ndarray:
    """[H, W] signed map -> uint8 RGB, red = positive (inside), blue = negative."""
    v = np.clip(sdf, -1, 1)
    img = np.zeros((*v.shape, 3), np.uint8)
    img[..., 0] = np.clip(v, 0, 1) * 255
    img[..., 2] = np.clip(-v, 0, 1) * 255
    return img


def gray(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float32)
    lo, hi = m.min(), m.max()
    if hi > lo:
        m = (m - lo) / (hi - lo)
    return (m * 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray):
    """uint8 [H, W] or [H, W, 3] RGB -> PNG."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("writing diagnostic images needs the Pillow package (PIL)") from exc
    Image.fromarray(np.ascontiguousarray(img)).save(path)


def anti_center_np(center_field: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Host-side anti-center map of one [H, W, 2] field, the map that stage 2
    thresholds (``center_score_max_thres``)."""
    k = _anti_center_kernel(kernel_size)[..., 0]  # [k, k, 2]
    pad = kernel_size // 2
    f = np.pad(center_field.astype(np.float32), ((pad, pad), (pad, pad), (0, 0)))
    h, w = center_field.shape[:2]
    out = np.zeros((h, w), np.float32)
    for iy in range(kernel_size):
        for ix in range(kernel_size):
            patch = f[iy : iy + h, ix : ix + w]
            out += patch[..., 0] * k[iy, ix, 0] + patch[..., 1] * k[iy, ix, 1]
    return out / float(kernel_size**2 - 1)


def image_gradients_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Forward differences, zero last row/col (the gradient loss's convention)."""
    dy = np.zeros_like(x, dtype=np.float32)
    dx = np.zeros_like(x, dtype=np.float32)
    dy[:-1] = x[1:] - x[:-1]
    dx[:, :-1] = x[:, 1:] - x[:, :-1]
    return dy, dx


def dump_objectness_diagnostics(
    out_dir: str,
    tag: str,
    image: np.ndarray,
    pred_center: np.ndarray,
    pred_sdf: np.ndarray,
    gt_center: np.ndarray | None = None,
    gt_sdf: np.ndarray | None = None,
    gt_mask: np.ndarray | None = None,
):
    """Write the per-sample diagnostic panel (the JAX package's file names).
    All inputs HWC/HW numpy; image in [0, 1]."""
    os.makedirs(out_dir, exist_ok=True)

    def save(name, img):
        save_png(os.path.join(out_dir, f"{tag}_{name}.png"), img)

    save("input", (np.clip(image, 0, 1) * 255).astype(np.uint8))
    save("pred_center_field", center_field_to_rgb(pred_center))
    save("pred_sdf", sdf_to_rgb(pred_sdf))
    save("pred_sdf_mask", gray(1.0 / (1.0 + np.exp(-pred_sdf)) > 0.5))
    save("pred_center_norm", gray(np.linalg.norm(pred_center, axis=-1)))
    save("pred_anti_center", gray(anti_center_np(pred_center)))
    dy, dx = image_gradients_np(pred_sdf)
    save("pred_sdf_grad_dy", gray(dy))
    save("pred_sdf_grad_dx", gray(dx))
    if gt_center is not None:
        save("gt_center_field", center_field_to_rgb(gt_center))
        save("gt_anti_center", gray(anti_center_np(gt_center)))
    if gt_sdf is not None:
        save("gt_sdf", sdf_to_rgb(gt_sdf))
        gdy, gdx = image_gradients_np(gt_sdf)
        save("gt_sdf_grad_dy", gray(gdy))
        save("gt_sdf_grad_dx", gray(gdx))
    if gt_mask is not None:
        save("gt_mask", gray(gt_mask))
    return out_dir
