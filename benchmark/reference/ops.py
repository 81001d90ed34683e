"""Plain torch ops of stage-2 discovery, frozen with the benchmark.

These are the plain versions that the system keeps beside its kernels
(``ops/{image,fields,connected_components,nms}.py`` and
``reasoning/proposals.py`` of ``unmore_tpu_torch``, as of the benchmark's
first version), copied so that a later change to the system cannot move the
reference. They compute every value with the f32 operations, in the order,
of the system's decode kernel and engine, so that the same model outputs
give the same boxes bit for bit: the decode is held to its plain version
exactly, the rest is the same arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIG = 2**30
GRID_SIZES = (32, 64, 128, 256, 512)


def seed_proposals(height: int, width: int) -> np.ndarray:
    """[P, 4] float64 xyxy seeds: for each grid g, three anchors (2g x 2g,
    g x 2g, 2g x g) at every g-step centre, clipped; then the whole image."""
    out = []
    for g in GRID_SIZES:
        cy = np.arange(0, height, g, dtype=np.int64)
        cx = np.arange(0, width, g, dtype=np.int64)
        xc, yc = np.meshgrid(cx, cy)
        centers = np.stack([xc.ravel(), yc.ravel(), xc.ravel(), yc.ravel()], axis=1).astype(np.float64)
        anchors = np.array([[-g, -g, g, g], [-g / 2, -g, g / 2, g], [-g, -g / 2, g, g / 2]], dtype=np.float64)
        out.append((centers[:, None, :] + anchors[None, :, :]).reshape(-1, 4))
    boxes = np.concatenate(out, axis=0)
    boxes[:, 0] = np.maximum(boxes[:, 0], 0)
    boxes[:, 1] = np.maximum(boxes[:, 1], 0)
    boxes[:, 2] = np.minimum(boxes[:, 2], width)
    boxes[:, 3] = np.minimum(boxes[:, 3], height)
    return np.concatenate([boxes, [[0, 0, width, height]]], axis=0)


def image_gradients(x):
    dy = torch.zeros_like(x)
    dx = torch.zeros_like(x)
    dy[..., :-1, :] = x[..., 1:, :] - x[..., :-1, :]
    dx[..., :, :-1] = x[..., :, 1:] - x[..., :, :-1]
    return dy, dx


def _sample_coords(lo, hi, out_size, limit):
    size = torch.clamp(hi - lo, min=1.0)
    j = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    src = (j + 0.5) * (size[:, None] / out_size) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), size[:, None] - 1.0)
    i0f = torch.floor(src)
    frac = src - i0f
    i0 = i0f.to(torch.int64) + lo[:, None].to(torch.int64)
    i1 = torch.minimum(i0 + 1, (hi[:, None] - 1.0).to(torch.int64))
    return i0.clamp(0, limit - 1), i1.clamp(0, limit - 1), frac


def crop_and_resize(image, boxes, out_size, chunk, image_idx):
    """Boxes (floored / ceiled to integers) cropped from the [B, H, W, C]
    canvases and resized to out_size^2 with half-pixel bilinear taps, rows
    before columns. Returns [P, S, S, C] f32."""
    idx = image_idx.to(torch.int64).clamp(0, image.shape[0] - 1)
    _, H, W, C = image.shape
    S = out_size
    boxes = boxes.float()
    iy0, iy1, fy = _sample_coords(torch.floor(boxes[:, 1]), torch.ceil(boxes[:, 3]), S, H)
    ix0, ix1, fx = _sample_coords(torch.floor(boxes[:, 0]), torch.ceil(boxes[:, 2]), S, W)
    out = torch.empty((boxes.shape[0], S, S, C), dtype=torch.float32, device=image.device)
    for s in range(0, boxes.shape[0], chunk):
        e = s + chunk
        b = idx[s:e, None, None]
        y0, y1 = iy0[s:e, :, None], iy1[s:e, :, None]
        x0, x1 = ix0[s:e, None, :], ix1[s:e, None, :]
        wy = fy[s:e, :, None, None]
        c0 = image[b, y0, x0].float()
        c0 = c0 + (image[b, y1, x0].float() - c0) * wy
        c1 = image[b, y0, x1].float()
        c1 = c1 + (image[b, y1, x1].float() - c1) * wy
        out[s:e] = c0 + (c1 - c0) * fx[s:e, None, :, None]
    return out


# ------------------------------------------------------------ decode
def _anti_center_weights(k):
    c = k // 2
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    vec = np.stack([c - ii, c - jj], axis=-1).astype(np.float64)
    vec = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-12)
    return vec.astype(np.float32)


def _min_filter(x, k, dim):
    half = k // 2
    n = x.shape[dim]
    padded = F.pad(x, (half, half, 0, 0) if dim == -1 else (0, 0, half, half))
    m = padded.narrow(dim, 0, n)
    for d in range(1, k):
        m = torch.minimum(m, padded.narrow(dim, d, n))
    return m


def batch_erode(masks, k=9, rounds=3):
    out = masks.to(torch.float32)
    for _ in range(rounds):
        out = _min_filter(_min_filter(out, k, -1), k, -2)
    return out.to(torch.int32)


def anti_center_map(center, k=5):
    ah = k // 2
    weights = _anti_center_weights(k)
    H, W = center.shape[1:3]
    pad_cy = F.pad(center[..., 0].float(), (ah, ah, ah, ah))
    pad_cx = F.pad(center[..., 1].float(), (ah, ah, ah, ah))
    acc = torch.zeros(pad_cy.shape[0], H, W, dtype=torch.float32, device=center.device)
    for i in range(k):
        for j in range(k):
            wy, wx = (float(v) for v in weights[i, j])
            if wy == 0.0 and wx == 0.0:
                continue
            acc = acc + wy * pad_cy[:, i : i + H, j : j + W] + wx * pad_cx[:, i : i + H, j : j + W]
    return acc / torch.full((), float(k * k - 1), device=acc.device)


def decode(sdf, center, border=10):
    """(max singularity score [B], its first (y, x) [B, 2] int32, union mask
    [B, H, W] int32) of each crop: the anti-centre score inside the eroded
    union of ``sdf > 0`` and ``|center| > 0.5``, a border-px frame zeroed."""
    B, H, W = sdf.shape
    cy, cx = center[..., 0].float(), center[..., 1].float()
    union = ((sdf.float() > 0.0) | (cy * cy + cx * cx > 0.25)).to(torch.int32)
    scores = anti_center_map(center) * batch_erode(union).to(torch.float32)
    yy = torch.arange(H, device=scores.device)[None, :, None]
    xx = torch.arange(W, device=scores.device)[None, None, :]
    interior = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    flat = torch.where(interior, scores, torch.zeros((), device=scores.device)).reshape(B, -1)
    best = flat.amax(dim=1)
    flat_idx = torch.arange(H * W, device=flat.device)
    arg = torch.where(flat == best[:, None], flat_idx, H * W).amin(dim=1)
    return best, torch.stack([arg // W, arg % W], dim=-1).to(torch.int32), union


# ------------------------------------------------ connected components
def _min_pool_8(labels):
    h, w = labels.shape[-2:]
    padded = F.pad(labels, (1, 1, 1, 1), value=BIG)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, padded[:, dy : dy + h, dx : dx + w])
    return out


def label_components(masks, max_iters=256):
    """8-connected labels: each component holds its smallest linear index."""
    B, h, w = masks.shape
    fg = masks > 0
    idx = torch.arange(h * w, dtype=torch.int32, device=masks.device).reshape(1, h, w)
    big = torch.full((), BIG, dtype=torch.int32, device=masks.device)
    labels = torch.where(fg, idx, big)
    for _ in range(max_iters):
        prop = torch.where(fg, _min_pool_8(labels), big)
        flat = prop.reshape(B, h * w)
        hop = torch.gather(flat, 1, flat.clamp(0, h * w - 1).long()).reshape(B, h, w)
        new = torch.minimum(prop, torch.where(prop < BIG, hop, big))
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def component_boxes(labels, max_components):
    B, h, w = labels.shape
    dev = labels.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    big_f = torch.full((), 1e9, device=dev)
    remaining = labels
    boxes, valid = [], []
    for _ in range(max_components):
        cur = remaining.reshape(B, -1).amin(dim=1)
        found = cur < BIG
        sel = remaining == cur[:, None, None]
        box = torch.stack([torch.where(sel, xx, big_f).amin(dim=(1, 2)), torch.where(sel, yy, big_f).amin(dim=(1, 2)),
                           torch.where(sel, xx, -big_f).amax(dim=(1, 2)) + 1.0,
                           torch.where(sel, yy, -big_f).amax(dim=(1, 2)) + 1.0], dim=-1)
        boxes.append(torch.where(found[:, None], box, torch.zeros_like(box)))
        valid.append(found)
        remaining = torch.where(sel, torch.full((), BIG, dtype=labels.dtype, device=dev), remaining)
    valid_t = torch.stack(valid, dim=1)
    return torch.stack(boxes, dim=1), valid_t, valid_t.sum(dim=1, dtype=torch.int32)


# ------------------------------------------------------------------ NMS
def pairwise_iou(a, b):
    ax1, ay1, ax2, ay2 = (a[..., i : i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    inter = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0) * \
        (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros((), device=inter.device))


def nms_mask(boxes, scores, valid, iou_threshold):
    """Sequential greedy NMS (ties by input index): the keep-mask in input order."""
    n = boxes.shape[0]
    order = torch.argsort(torch.where(valid, -scores.float(), torch.full((), float("inf"), device=boxes.device)),
                          stable=True)
    iou = pairwise_iou(boxes.float()[order], boxes.float()[order]).cpu()
    valid_sorted = valid[order].cpu()
    kept = torch.zeros(n, dtype=torch.bool)
    for i in range(n):
        if valid_sorted[i] and not bool((iou[kept, i] > iou_threshold).any()):
            kept[i] = True
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = kept.to(boxes.device)
    return out
