"""The benchmark's fixed counts: the card's peaks, the model FLOPs of a crop,
the decode kernel's least bytes, and the crops a discovery group executes.

Every count here is worked out from the published sizes in a configuration
file, never by running the system's modules, so that a later change to how
the system computes a layer leaves the yardstick where it was. Model FLOPs
count the multiply-adds of convolutions, linear layers and attention
products (2 per multiply-add); resizes, norms and activations are not
counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# the decode kernel's least traffic (inputs read once, outputs written
# once): per pixel the f32 SDF, the (dy, dx) f32 centre field and the
# int32 union; per crop the f32 score and the int32 (y, x) argmax
DECODE_BYTES_PER_PIXEL = 4 + 8 + 4
DECODE_BYTES_PER_CROP = 4 + 8


def conv(h, w, cin, cout, k):
    """FLOPs of a k x k convolution producing an h x w map, or of a k x k,
    stride-k transposed convolution reading one."""
    return 2 * h * w * cin * cout * k * k


def vit_block(n, d, mlp):
    """FLOPs of one pre-LN transformer block over n tokens of width d."""
    return 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d + 2 * 2 * n * d * mlp


def resnet50_forward(s, stage_blocks=(3, 4, 6, 3)):
    """FLOPs of the ResNet-50 existence classifier on one s x s crop."""
    h = -(-s // 2)
    total = conv(h, h, 3, 64, 7)
    h = -(-h // 2)  # 3x3/2 max-pool
    cin, planes = 64, 64
    for stage, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            stride = 2 if (stage > 1 and b == 0) else 1
            ho = -(-h // stride)
            total += conv(h, h, cin, planes, 1) + conv(ho, ho, planes, planes, 3) + conv(ho, ho, planes, planes * 4, 1)
            if b == 0:
                total += conv(ho, ho, cin, planes * 4, 1)
            cin, h = planes * 4, ho
        planes *= 2
    return total + 2 * cin * 1000 + 2 * 1000 * 1


def resnetv2_trunk(s, trunk):
    """FLOPs of the hybrid's ResNetV2 stem and stages on one s x s crop;
    returns (FLOPs, [(channels, side) of each stage's output])."""
    stem = trunk.get("stem_width", 64)
    h = -(-s // 2)
    total = conv(h, h, 3, stem, 7)
    h = -(-h // 2)
    cin, taps = stem, []
    for si, ((mid, out), nb) in enumerate(zip(trunk["stage_widths"], trunk["stage_blocks"])):
        for b in range(nb):
            stride = 2 if (si > 0 and b == 0) else 1
            ho = -(-h // stride)
            total += conv(h, h, cin, mid, 1) + conv(ho, ho, mid, mid, 3) + conv(ho, ho, mid, out, 1)
            if b == 0:
                total += conv(ho, ho, cin, out, 1)
            cin, h = out, ho
        taps.append((out, h))
    return total, taps


def objectness_forward(cfg, s, center=True, sdf=True):
    """FLOPs of ObjectnessNet on one s x s crop: the DPT backbone and the
    heads asked for (the centre head ends in 2 channels, the SDF head in 1)."""
    vit, feats, widths = cfg["vit"], cfg["features"], cfg["widths"]
    d, p = vit["dim"], vit["patch"]
    g = s // p
    n = g * g + 1
    total, maps = 0, []
    if "trunk" in cfg:
        trunk_flops, taps = resnetv2_trunk(s, cfg["trunk"])
        total += trunk_flops + conv(g, g, taps[-1][0], d, 1)
        maps += [(c, side) for c, side in taps[:2]]
    else:
        total += conv(g, g, 3, d, p)
    total += (max(cfg["hooks"]) + 1) * vit_block(n, d, vit["mlp_dim"])
    for i in range(len(maps), 4):  # reassemble the ViT taps
        w = widths[i]
        total += 2 * g * g * 2 * d * d + conv(g, g, d, w, 1)
        if i == 0:
            total += conv(g, g, w, w, 4)
            maps.append((w, 4 * g))
        elif i == 1:
            total += conv(g, g, w, w, 2)
            maps.append((w, 2 * g))
        elif i == 2:
            maps.append((w, g))
        else:
            h = -(-g // 2)
            total += conv(h, h, w, w, 3)
            maps.append((w, h))
    for c, side in maps:  # layer{n}_rn
        total += conv(side, side, c, feats, 3)
    for n_map in (3, 2, 1, 0):  # refinenet4 .. refinenet1
        side = maps[n_map][1]
        rcus = 1 if n_map == 3 else 2
        total += rcus * 2 * conv(side, side, feats, feats, 3) + conv(2 * side, 2 * side, feats, feats, 1)

    def head(cout):
        return conv(s, s, feats, 512, 1) + conv(s, s, 512, 512, 3) + conv(s, s, 512, 1024, 1) + conv(s, s, 1024, cout, 1)

    return total + (head(2) if center else 0) + (head(1) if sdf else 0)


def crop_flops(config):
    """(both heads, SDF head only, classifier) FLOPs of one crop."""
    s = config["crop_size"]
    return (objectness_forward(config, s), objectness_forward(config, s, center=False),
            resnet50_forward(s, tuple(config["classifier_stage_blocks"])))


def decode_bytes(n_crops, side):
    """Least bytes the decode moves for ``n_crops`` crops of side ``side``."""
    return n_crops * (side * side * DECODE_BYTES_PER_PIXEL + DECODE_BYTES_PER_CROP)


def executed_crops(n_live, chunk, tail):
    """Crops a live-prefix map runs for ``n_live`` live rows: full chunks,
    then tail chunks over the rest (dead rows in the last tail chunk run too)."""
    full = (n_live // chunk) * chunk
    return full + -(-(n_live - full) // tail) * tail


def exist_tile(cfg):
    smallest = min(cfg["max_proposals"], cfg["max_splits"], cfg["max_active"]) * cfg["image_batch"]
    return max(min(cfg.get("exist_chunk", 1024), smallest), cfg["crop_chunk"])


def crop_counts(stats, seeds, cfg):
    """(live, executed) crops of each model phase of one discovery group,
    from the group's statistics (``stats`` of its first image; the counts of
    a shared lattice are the group's) and each image's seed count."""
    chunk, tail = cfg["crop_chunk"], min(cfg["crop_chunk_tail"], cfg["crop_chunk"])
    tile = exist_tile(cfg)
    exist_tail = min(chunk, tile) if tile > chunk else tail
    n_seed = sum(seeds)
    n_split_kept = min(stats["n_split"], cfg["max_splits"] * cfg["image_batch"])
    live = {"existence": n_seed + n_split_kept, "center": stats["n_center_in"],
            "recheck_center": stats["n_recheck_center_in"], "boundary": sum(stats["boundary_active_trace"])}
    executed = {
        "existence": sum(executed_crops(n, tile, exist_tail) for n in (n_seed, n_split_kept)),
        "center": executed_crops(stats["n_center_in"], chunk, tail),
        "recheck_center": executed_crops(stats["n_recheck_center_in"], chunk, tail),
        "boundary": sum(executed_crops(n, chunk, tail) for n in stats["boundary_active_trace"]),
    }
    return live, executed


def group_flops(counts, both, sdf_only, cls):
    """Model FLOPs of a group's crops: the classifier on the existence
    crops, both heads on the centre crops, the SDF head on the boundary."""
    return (counts["existence"] * cls + (counts["center"] + counts["recheck_center"]) * both
            + counts["boundary"] * sdf_only)
