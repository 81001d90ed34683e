"""ResNet-50 (torchvision v1 layout) and the existence classifier (port of
``models/resnet.py``).

BN after each conv, stride on the 3x3 conv of each bottleneck. In eval mode
BatchNorm normalizes with the running statistics (stage 2). In train mode
(the existence trainer) it normalizes with the batch statistics and updates
the running ones as flax does: momentum 0.9 on the batch mean and the
*biased* batch variance, where ``nn.BatchNorm2d`` would take the unbiased
one. (flax computes that variance as ``mean(x^2) - mean(x)^2``; the port
with ``torch.var_mean``, which rounds less.) Over several ranks a train-mode
BatchNorm normalises with the statistics of the global batch, as the JAX
package's step does, being one program over the whole mesh: the ranks sum
each channel's sum, sum of squares and count in f32 (flax's
``mean(x^2) - mean(x)^2``), and the backward pass sums the two per-channel
gradient sums. :func:`frozen_running_stats`
holds the running statistics of a module's BatchNorms still, for a forward
that is a recomputation (an activation checkpoint's). Names follow the
reference checkpoint: ``classifier_backbone.*`` and
``binary_classification_head.*``.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.models.norms import KeepsFloat32
from unmore_tpu_torch.parallel import distributed

FLAX_BN_MOMENTUM = 0.9  # running = m * running + (1 - m) * batch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or f64 when it is f64 (the tests' reference steps)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _global_moments(x: torch.Tensor):
    """(mean, biased variance, count) per channel of NCHW ``x`` over the
    batch of every rank, in f32 (f64 for f64 ``x``): one all-reduce of the
    sums."""
    xf = _acc(x)
    c = xf.shape[1]
    sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                      torch.full((1,), float(xf.numel() // c), device=xf.device)])
    distributed.all_reduce_sum_(sums)
    n = sums[2 * c]
    mean = sums[:c] / n
    var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
    return mean, var, n


def batch_moments(x: torch.Tensor):
    """(mean, biased variance) per channel of NCHW ``x`` in f32 (f64 for
    f64 ``x``), whatever autocast made of ``x``: of the global batch over
    several ranks."""
    if distributed.process_count() > 1:
        return _global_moments(x)[:2]
    var, mean = torch.var_mean(_acc(x), dim=(0, 2, 3), correction=0)
    return mean, var


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation with the global batch's statistics;
    ``stats_out`` receives (mean, var) for the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stats_out):
        mean, var, n = _global_moments(x)
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        y = (_acc(x) - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        stats_out.extend((mean, var))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dyf = _acc(dy)
        xhat = (_acc(x) - mean.view(shape)) * invstd.view(shape)
        c = mean.numel()
        local = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dbias, dweight = local[:c].clone(), local[c:].clone()  # this rank's share of the parameter gradients
        total = distributed.all_reduce_sum_(local)
        scale = (weight * invstd / n).view(shape)
        dx = scale * (n * dyf - total[:c].view(shape) - xhat * total[c:].view(shape))
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None, None


class BatchNorm2d(KeepsFloat32, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update in train mode
    (skipped while ``update_stats`` is false), over the global batch when
    the run has several ranks. A cast to bf16 keeps its parameters and
    statistics in float32, and an eval-mode forward normalises a bf16 input
    against them in float32 (``models/norms.py``)."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if distributed.process_count() > 1:
            stats: list = []
            y = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, stats)
            if self.update_stats:
                with torch.no_grad():
                    self._update_running_stats(*stats)
            return y
        if self.update_stats:
            with torch.no_grad():
                self._update_running_stats(*batch_moments(x))
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running_stats(self, mean, var):
        m = FLAX_BN_MOMENTUM
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Train-mode forwards of ``module`` inside leave its BatchNorms'
    running statistics as they are."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                BatchNorm2d(planes * 4),
            )
            if downsample
            else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet50(nn.Module):
    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, blocks in enumerate(stage_blocks, start=1):
            layer = nn.Sequential()
            for b in range(blocks):
                stride = 2 if (stage > 1 and b == 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride, downsample=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", layer)
            planes *= 2
        self.n_stages = len(stage_blocks)
        self.fc = nn.Linear(inplanes, 1000)

    def forward(self, x):  # [B, 3, H, W]
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        for stage in range(1, self.n_stages + 1):
            out = getattr(self, f"layer{stage}")(out)
        return self.fc(out.mean(dim=(2, 3)))


class BinaryClassifier(nn.Module):
    """Existence classifier: ResNet-50 -> Linear(1000, 1) -> sigmoid in f32."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.classifier_backbone = ResNet50(stage_blocks=stage_blocks)
        self.binary_classification_head = nn.Linear(1000, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [0, 1] -> scores [B, 1] f32."""
        x = images.permute(0, 3, 1, 2).to(self.classifier_backbone.conv1.weight.dtype)
        logit = self.binary_classification_head(self.classifier_backbone(x))
        return torch.sigmoid(logit.float())
