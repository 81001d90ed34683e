"""ResNet-50 FPN backbone of the CAD detector (port of ``detector/fpn.py``).

C2..C5 from a torchvision-layout ResNet-50 trunk (the port's
``models/resnet.py`` bottlenecks, BatchNorm from running statistics with
flax's eps 1e-5), lateral 1x1 convs, a top-down path, 3x3 output convs for
P2..P5, and P6. Module names follow the JAX package's parameter tree
(``backbone.trunk.layer1_0.conv1``, ``backbone.fpn.lateral2``, ...), so that
:mod:`unmore_tpu_torch.detector.convert` maps the two one to one.

Two details are the JAX package's, not ``F.interpolate``'s or a pooling
layer's: the top-down step repeats each pixel 2x2 and crops to the lateral's
size (``jnp.repeat`` twice, then a slice), and P6 is a 1x1 max-pool of
stride 2, i.e. ``P5[..., ::2, ::2]``. Features are NCHW.

With ``remat`` (the detector's default, as the JAX package's
``remat_backbone``) a forward that records gradients checkpoints each
bottleneck: its activations are recomputed in the backward pass rather than
kept. The recomputation runs the blocks' BatchNorms in train mode again;
:func:`~unmore_tpu_torch.models.resnet.frozen_running_stats` keeps it from
moving their running statistics a second time (flax's ``nn.remat`` updates
them once).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unmore_tpu_torch.models.resnet import BatchNorm2d, Bottleneck, frozen_running_stats

LEVELS = ("P2", "P3", "P4", "P5", "P6")


class ResNet50Trunk(nn.Module):
    """ResNet-50 returning {C2, C3, C4, C5} (NCHW)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), remat: bool = False):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, blocks in enumerate(self.stage_blocks):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, f"layer{stage + 1}_{b}", Bottleneck(inplanes, planes, stride, downsample=(b == 0)))
                inplanes = planes * 4
            planes *= 2

    def forward(self, x: torch.Tensor) -> dict:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)  # pads with -inf, as flax's max_pool
        feats = {}
        for stage, blocks in enumerate(self.stage_blocks):
            for b in range(blocks):
                block = getattr(self, f"layer{stage + 1}_{b}")
                if self.remat and torch.is_grad_enabled():
                    out = checkpoint(block, out, use_reentrant=False,
                                     context_fn=functools.partial(_recompute_contexts, block))
                else:
                    out = block(out)
            feats[f"C{stage + 2}"] = out
        return feats


def _recompute_contexts(block: nn.Module):
    """(forward context, recomputation context) of a checkpointed block."""
    return contextlib.nullcontext(), frozen_running_stats(block)


class FPN(nn.Module):
    """Lateral + top-down pyramid producing P2..P6 at ``out_channels``."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i + 2}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"output{i + 2}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: dict) -> dict:
        laterals = [getattr(self, f"lateral{i + 2}")(feats[f"C{i + 2}"]) for i in range(4)]
        merged = [None] * 4
        merged[3] = laterals[3]
        for i in (2, 1, 0):
            h, w = laterals[i].shape[-2:]
            up = merged[i + 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)[..., :h, :w]
            merged[i] = laterals[i] + up
        outs = {f"P{i + 2}": getattr(self, f"output{i + 2}")(merged[i]) for i in range(4)}
        outs["P6"] = outs["P5"][..., ::2, ::2]
        return outs


class ResNetFPN(nn.Module):
    def __init__(self, out_channels: int = 256, stage_blocks: Sequence[int] = (3, 4, 6, 3), remat: bool = False):
        super().__init__()
        self.trunk = ResNet50Trunk(stage_blocks, remat)
        self.fpn = FPN(out_channels=out_channels)

    def forward(self, images: torch.Tensor) -> dict:
        return self.fpn(self.trunk(images))
