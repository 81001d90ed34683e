"""Field-decoding ops for center-boundary reasoning (port of ``ops/fields.py``).

The decode chain of the center phase, written with shifted slices and zero
padding in the order of the fused TPU kernel's body, never with
``F.conv2d``: cuDNN runs f32 convolutions in TF32 by default on Hopper,
which would move scores near the hard 0.009 threshold and the ``k*k``
erosion counts. :func:`center_singularity_scores` is the plain version of
the CUDA kernel in :mod:`unmore_tpu_torch.ops.decode`; both compute every
value with the same f32 operations in the same order.

The union mask is ``sdf > 0 | cy^2 + cx^2 > 0.25``, the fused kernel's form
of ``sigmoid(sdf) > 0.5 | ||center|| > 0.5``. The two differ only within
about 1e-7 of a threshold, where the sigmoid and the square root round.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _anti_center_kernel(kernel_size: int) -> np.ndarray:
    """[k, k, 2, 1] kernel of unit vectors pointing toward the kernel center.

    Tap (i, j) holds normalize([c - i, c - j]), channel 0 = row (dy) and
    channel 1 = col (dx), the center-field channel order.
    """
    k = kernel_size
    c = k // 2
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    vec = np.stack([c - ii, c - jj], axis=-1).astype(np.float64)  # [k, k, 2]
    norm = np.linalg.norm(vec, axis=-1, keepdims=True)
    vec = vec / np.maximum(norm, 1e-12)
    out = vec[..., None].astype(np.float32)
    out.setflags(write=False)
    return out


def union_binary_mask(sdf_maps: torch.Tensor, center_fields: torch.Tensor) -> torch.Tensor:
    """Foreground union (sdf > 0) | (||center field|| > .5) -> int32 [B, H, W]."""
    sdf = sdf_maps.float()
    cy = center_fields[..., 0].float()
    cx = center_fields[..., 1].float()
    return ((sdf > 0.0) | (cy * cy + cx * cx > 0.25)).to(torch.int32)


def _min_filter(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Min over a k-window along ``dim`` (-1 or -2), zero padded."""
    half = k // 2
    n = x.shape[dim]
    pad = (half, half, 0, 0) if dim == -1 else (0, 0, half, half)
    padded = F.pad(x, pad)
    m = padded.narrow(dim, 0, n)
    for d in range(1, k):
        m = torch.minimum(m, padded.narrow(dim, d, n))
    return m


def batch_erode(masks: torch.Tensor, kernel_size: int = 9, num_rounds: int = 3) -> torch.Tensor:
    """Binary erosion: a pixel survives iff its full kxk window is set.

    masks: [B, H, W] (0/1). Separable min filter with zero padding (a
    kxk all-ones erosion is a min filter). Returns int32 [B, H, W].
    """
    out = masks.to(torch.float32)
    for _ in range(num_rounds):
        out = _min_filter(_min_filter(out, kernel_size, -1), kernel_size, -2)
    return out.to(torch.int32)


def anti_center_map(center_fields: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Score map of center-field sinks: +1 where the (dy, dx) field converges
    from all sides, -1 at object centers. center_fields [B, H, W, 2] ->
    [B, H, W] f32. Taps accumulate in (i, j) row-major order as
    ``acc + wy*ty + wx*tx``, skipping the zero center tap."""
    k = kernel_size
    ah = k // 2
    weights = _anti_center_kernel(k)[..., 0]
    H, W = center_fields.shape[1:3]
    pad_cy = F.pad(center_fields[..., 0].float(), (ah, ah, ah, ah))
    pad_cx = F.pad(center_fields[..., 1].float(), (ah, ah, ah, ah))
    acc = torch.zeros(pad_cy.shape[0], H, W, dtype=torch.float32, device=center_fields.device)
    for i in range(k):
        for j in range(k):
            wy, wx = (float(v) for v in weights[i, j])
            if wy == 0.0 and wx == 0.0:
                continue
            acc = acc + wy * pad_cy[:, i : i + H, j : j + W] + wx * pad_cx[:, i : i + H, j : j + W]
    # a tensor divisor: on CUDA, division by a Python scalar multiplies by
    # its reciprocal, one ulp away from the kernel's (and the CPU's) quotient
    return acc / torch.full((), float(k * k - 1), device=acc.device)


def center_singularity_scores(
    sdf_maps: torch.Tensor,
    center_fields: torch.Tensor,
    border: int = 10,
    erode_kernel: int = 9,
    erode_rounds: int = 3,
    anti_kernel: int = 5,
):
    """Full center-reasoning decode chain (plain version of the CUDA kernel).

    Returns (max_scores [B] f32, argmax_yx [B, 2] int32, union [B, H, W]
    int32): the per-crop max anti-center score inside the eroded
    foreground with a ``border``-px frame zeroed, its first-occurrence
    location, and the raw union mask that the CC analysis consumes.
    """
    B, H, W = sdf_maps.shape
    union = union_binary_mask(sdf_maps, center_fields)
    eroded = batch_erode(union, erode_kernel, erode_rounds)
    scores = anti_center_map(center_fields, anti_kernel) * eroded.to(torch.float32)
    yy = torch.arange(H, device=scores.device)[None, :, None]
    xx = torch.arange(W, device=scores.device)[None, None, :]
    interior = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    scores = torch.where(interior, scores, torch.zeros((), device=scores.device))
    flat = scores.reshape(B, -1)
    max_scores = flat.amax(dim=1)
    # first occurrence of the max (jnp.argmax semantics), explicitly
    flat_idx = torch.arange(H * W, device=flat.device)
    argmax = torch.where(flat == max_scores[:, None], flat_idx, H * W).amin(dim=1)
    argmax_yx = torch.stack([argmax // W, argmax % W], dim=-1).to(torch.int32)
    return max_scores, argmax_yx, union
