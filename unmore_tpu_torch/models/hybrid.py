"""R50+ViT-B/16 hybrid backbone (timm ``vit_base_resnet50_384``), NCHW (port
of ``models/hybrid.py``).

The reference's ``dpt_hybrid`` option: a ResNetV2 trunk feeding a 1x1 patch
projection into a 12-block ViT-B. DPT taps the trunk's stage-1 output (256
ch, 1/4) and stage-2 output (512 ch, 1/8) and ViT blocks 8 and 11. The trunk
follows timm's ``vit_base_r50_s16_384`` (``docs/hybrid_stem_audit.md``):

* post-activation bottlenecks: conv1-norm1-relu-conv2-norm2-relu-conv3-norm3,
  the ReLU after the residual add; the first block of a stage takes its
  shortcut through a 1x1 conv and a norm without activation, from the raw
  input;
* the stem: a 7x7/2 ``StdConv2dSame``, GroupNorm + ReLU, a 3x3/2 max-pool;
  every conv and the pool pad as TF-SAME does (low = floor(total / 2), high
  = ceil), the pool with -inf;
* ``StdConv2dSame``: each output channel's kernel standardised,
  ``(w - mean) / sqrt(biased_var + 1e-8)``, at every forward;
* GroupNorm(32, eps 1e-5).

Parameter names are the reference checkpoint's:
``pretrained.model.patch_embed.backbone.{stem,stages}.*`` for the trunk and
``pretrained.model.patch_embed.proj`` for the projection, once nested in the
DPT module.

The kernels are standardised from float32. A dtype cast of the model to
bf16 or fp16 leaves ``StdConv2dSame`` kernels in float32 (the JAX package
keeps float32 parameters and casts the standardised kernel to the compute
dtype; standardising an already-rounded kernel gives other bits), and the
GroupNorms' scales and biases too: they normalise in float32 and round once,
as flax's ``GroupNorm`` does (``models/norms.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.models.norms import GroupNorm, KeepsFloat32
from unmore_tpu_torch.models.vit import ViTBackbone, ViTConfig

WS_EPS = 1e-8
GN_EPS = 1e-5


def _pads(x: torch.Tensor, k: int, stride: int):
    """TF-SAME padding of ``x``'s two spatial axes (low = floor(total / 2),
    high = ceil) as (padding for the op itself, F.pad tuple or None):
    symmetric pads go to the op, asymmetric ones to an explicit pad."""
    pads = []
    for size in x.shape[-2:]:
        total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (t, b), (l, r) = pads
    if (t, l) == (b, r):
        return (t, l), None
    return (0, 0), (l, r, t, b)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")``: -inf padding, asymmetric where SAME is."""
    padding, explicit = _pads(x, k, stride)
    if explicit is not None:
        x = F.pad(x, explicit, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=padding)


def standardize(w: torch.Tensor) -> torch.Tensor:
    """Per output channel ``(w - mean) / sqrt(biased_var + 1e-8)``, in at least float32."""
    w = w.to(torch.promote_types(w.dtype, torch.float32))
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
    return (w - mean) / torch.sqrt(var + WS_EPS)


class StdConv2dSame(KeepsFloat32, nn.Conv2d):
    """timm's ``StdConv2dSame(eps=1e-8)``: weight standardisation, TF-SAME padding, no bias."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=False)

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The standardised kernel in ``dtype``, from the float32 (or wider) weight."""
        return standardize(self.weight).to(dtype)

    def forward(self, x):
        padding, explicit = _pads(x, self.kernel_size[0], self.stride[0])
        if explicit is not None:
            x = F.pad(x, explicit)
        return F.conv2d(x, self.kernel(x.dtype), None, self.stride, padding)


class DownsampleConv(nn.Module):
    """The shortcut of a stage's first block: 1x1 ``StdConv2dSame`` + GroupNorm, no activation."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, groups: int):
        super().__init__()
        self.conv = StdConv2dSame(in_ch, out_ch, 1, stride)
        self.norm = GroupNorm(groups, out_ch, eps=GN_EPS)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2's post-activation bottleneck (``preact=False``)."""

    def __init__(self, in_ch: int, mid: int, out: int, stride: int, downsample: bool, groups: int):
        super().__init__()
        self.downsample = DownsampleConv(in_ch, out, stride, groups) if downsample else None
        self.conv1 = StdConv2dSame(in_ch, mid, 1)
        self.norm1 = GroupNorm(groups, mid, eps=GN_EPS)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride)
        self.norm2 = GroupNorm(groups, mid, eps=GN_EPS)
        self.conv3 = StdConv2dSame(mid, out, 1)
        self.norm3 = GroupNorm(groups, out, eps=GN_EPS)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(self.norm3(self.conv3(y)) + shortcut)


class ResNetV2Stages(nn.Module):
    """The 'same' stem and three stages; forward -> [stage0, stage1, stage2] outputs."""

    def __init__(self, stem_width: int = 64, stage_widths=((64, 256), (128, 512), (256, 1024)),
                 stage_blocks=(3, 4, 9), groups: int = 32, in_chans: int = 3):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv2dSame(in_chans, stem_width, 7, 2)
        self.stem.norm = GroupNorm(groups, stem_width, eps=GN_EPS)
        self.stages = nn.ModuleList()
        in_ch = stem_width
        for s, ((mid, out), nb) in enumerate(zip(stage_widths, stage_blocks)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                Bottleneck(in_ch if b == 0 else out, mid, out, 2 if (s > 0 and b == 0) else 1, b == 0, groups)
                for b in range(nb)
            )
            self.stages.append(stage)
            in_ch = out
        self.out_channels = in_ch

    def forward(self, x):
        y = max_pool_same(F.relu(self.stem.norm(self.stem.conv(x))))
        taps = []
        for stage in self.stages:
            for blk in stage.blocks:
                y = blk(y)
            taps.append(y)
        return taps


class HybridViTBackbone(ViTBackbone):
    """forward(images [B, 3, H, W]) -> [stage0 [B, 256, H/4, W/4], stage1
    [B, 512, H/8, W/8], tokens of block ``hooks[0]``, of block ``hooks[1]``]
    (tokens [B, 1 + h*w, C], cls at index 0). ``resnet_kwargs`` overrides the
    trunk's widths (the tests use miniature ones)."""

    def __init__(self, config: ViTConfig, hooks, resnet_kwargs=None):
        trunk = ResNetV2Stages(in_chans=config.in_chans, **(resnet_kwargs or {}))
        embed = nn.Module()
        embed.backbone = trunk
        embed.proj = nn.Conv2d(trunk.out_channels, config.dim, 1)
        super().__init__(config, hooks, patch_embed=embed)

    def forward(self, x):
        H, W = x.shape[-2:]
        s0, s1, feat = self.patch_embed.backbone(x)
        p = self.config.patch
        if tuple(feat.shape[-2:]) != (H // p, W // p):
            raise ValueError(f"the trunk's grid {tuple(feat.shape[-2:])} is not the {p}-pixel patch grid of "
                             f"{H}x{W}: take a side that is a multiple of {p}")
        return [s0, s1, *self.encode(self.patch_embed.proj(feat))]
