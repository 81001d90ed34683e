"""Normalisation layers that keep float32 leaves in a bf16 model, as flax's do.

A flax ``LayerNorm``, ``BatchNorm`` or ``GroupNorm`` built with
``dtype=bfloat16`` keeps its scale, bias and running statistics in float32,
takes the statistics of a bf16 input in float32, normalises in float32 and
rounds the result to bf16 once (``flax.linen.normalization._normalize``).

The port casts a model to its compute dtype with ``model.to(dtype)``. Every
such cast goes through :meth:`KeepsFloat32._apply`: a cast to bf16 or fp16
leaves the floating parameters and buffers of a module that mixes it in in
float32 (the norms here, the port's ``BatchNorm2d`` and the hybrid's
weight-standardised convolutions), and a cast back to float32 or float64
moves them as it moves the rest. The norms normalise a half-precision input
against those float32 leaves in float32 and return the input's dtype.
Under autocast (the trainers' bf16 forwards over float32 weights) they are
torch's modules unchanged.

CUDA's ``batch_norm`` takes a bf16 input with float32 parameters and
statistics, and computes in float32: :class:`~unmore_tpu_torch.models.resnet.BatchNorm2d`
calls it as it is. CUDA's ``layer_norm`` and ``group_norm`` want the
input's dtype in their parameters, so :class:`LayerNorm` and
:class:`GroupNorm` upcast the input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

HALF_DTYPES = (torch.bfloat16, torch.float16)


class KeepsFloat32:
    """Mixin of an ``nn.Module``: a dtype cast to bf16 or fp16 leaves the
    module's own floating parameters and buffers in float32."""

    def _apply(self, fn, recurse=True):
        leaves = {**self._parameters, **self._buffers}
        kept = {n: t.data for n, t in leaves.items() if t is not None and t.is_floating_point()}
        super()._apply(fn, recurse)
        for name, master in kept.items():
            t = getattr(self, name)
            if t.dtype in HALF_DTYPES:
                t.data = master.to(t.device, torch.float32)
        return self


def in_float32(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether ``x`` is normalised in float32 against float32 leaves: its
    dtype is not the weight's, outside autocast."""
    return x.dtype != weight.dtype and not torch.is_autocast_enabled(x.device.type)


class LayerNorm(KeepsFloat32, nn.LayerNorm):
    def forward(self, x):
        if not in_float32(x, self.weight):
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class GroupNorm(KeepsFloat32, nn.GroupNorm):
    def forward(self, x):
        if not in_float32(x, self.weight):
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)
