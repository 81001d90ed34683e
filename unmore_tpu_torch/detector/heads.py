"""Cascade box heads and the mask head (port of ``detector/heads.py``, the
inference half; the losses and matchers come with detector training).

The box head flattens its pooled [N, 7, 7, C] features in HWC order, the
JAX package's, so ``fc1`` holds the flax kernel transposed; a detectron2
``fc1`` (CHW order) is permuted once by
:func:`~unmore_tpu_torch.detector.convert.d2_to_state_dict`. The deconv is
``ConvTranspose2d``, which flax's ``ConvTranspose(transpose_kernel=True)``
reproduces. Both heads return float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)


class BoxHead(nn.Module):
    """2-FC head + class scores (K+1) + class-agnostic box deltas."""

    def __init__(self, in_channels: int = 256, pooled: int = 7, num_classes: int = 1, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(pooled * pooled * in_channels, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, 4)

    def forward(self, pooled: torch.Tensor):  # [N, 7, 7, C]
        x = pooled.reshape(pooled.shape[0], -1).to(self.fc1.weight.dtype)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """4x conv3x3(256) + x2 deconv + 1x1 -> per-class mask logits."""

    def __init__(self, in_channels: int = 256, num_classes: int = 1, conv_dim: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}", nn.Conv2d(in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:  # [N, 14, 14, C] -> [N, 28, 28, K] f32
        x = pooled.permute(0, 3, 1, 2).to(self.deconv.weight.dtype)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).permute(0, 2, 3, 1).float()
