"""ObjectnessNet: DPT backbone + center-field and SDF heads (port of
``models/objectness.py``).

Canonical operating point: ``dpt_large`` backbone, ``use_bg_sdf=True``,
``sdf_activation='tanh'``; the SDF head then has no intermediate
activations and a Tanh output; the center head is
conv1x1-relu-conv3x3-relu-conv1x1-relu-conv1x1. Heads are ``nn.Sequential``
with the reference checkpoint's indices (0, 2, 4, 6 with ReLUs between;
0, 1, 2, 3 and an optional final activation without).

Backbones: ``dpt_large`` (ViT-L/16), ``dpt_base`` (ViT-B/16) and
``dpt_hybrid`` (a ResNetV2-50 trunk under ViT-B/16, ``models/hybrid.py``).
``remat_vit`` checkpoints the ViT blocks of the first two in training; the
hybrid ignores it, as the JAX package does.

Public layout is NHWC as in the JAX package: images [B, H, W, 3] in [0, 1];
center_fields [B, H, W, 2] (dy, dx) and sdf_maps [B, H, W], both f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unmore_tpu_torch.models.dpt import DPTFeatureExtractor

BACKBONE_ALIASES = {
    "dpt_large": "vitl16_384",
    "dpt_base": "vitb16_384",
    "dpt_hybrid": "vitb_rn50_384",
}


class Sine(nn.Module):
    def forward(self, x):
        return torch.sin(x)


def sdf_head_layout(sdf_activation: str | None, use_bg_sdf: bool) -> tuple[bool, str | None]:
    """(use_relu, final_act) of the SDF head for an ObjectnessNet config."""
    if use_bg_sdf and sdf_activation in ("tanh", "sine"):
        return False, sdf_activation
    if use_bg_sdf and sdf_activation is None:
        return False, None
    return True, None  # relu variant / fg-only sdf


def conv_head(in_ch: int, out_channels: int, use_relu: bool, final_act: str | None = None) -> nn.Sequential:
    """conv1x1(512) -> conv3x3(512) -> conv1x1(1024) -> conv1x1(out)."""
    layers: list[nn.Module] = []
    for conv in (nn.Conv2d(in_ch, 512, 1), nn.Conv2d(512, 512, 3, padding=1), nn.Conv2d(512, 1024, 1)):
        layers.append(conv)
        if use_relu:
            layers.append(nn.ReLU())
    layers.append(nn.Conv2d(1024, out_channels, 1))
    if final_act == "tanh":
        layers.append(nn.Tanh())
    elif final_act == "sine":
        layers.append(Sine())
    return nn.Sequential(*layers)


class ObjectnessNet(nn.Module):
    def __init__(self, backbone_type: str = "dpt_large", sdf_activation: str | None = "tanh",
                 use_bg_sdf: bool = True, features: int = 256, vit_config=None, hooks=None,
                 widths=None, remat_vit: bool = False, hybrid_resnet_kwargs=None):
        super().__init__()
        self.sdf_activation, self.use_bg_sdf = sdf_activation, use_bg_sdf  # the SDF head's layout
        if backbone_type not in BACKBONE_ALIASES:
            raise ValueError(f"unknown backbone_type {backbone_type!r}; choose one of {sorted(BACKBONE_ALIASES)}")
        self.backbone = DPTFeatureExtractor(
            BACKBONE_ALIASES[backbone_type], features, vit_config=vit_config, hooks=hooks, widths=widths,
            remat_vit=remat_vit, hybrid_resnet_kwargs=hybrid_resnet_kwargs,
        )
        self.center_field_prediction_head = conv_head(features, 2, use_relu=True)
        use_relu, final = sdf_head_layout(sdf_activation, use_bg_sdf)
        self.sdf_prediction_head = conv_head(features, 1, use_relu, final)

    def forward(self, images: torch.Tensor, compute_center: bool = True) -> dict:
        """images [B, H, W, 3] in [0, 1]. Returns dict(sdf_maps [B, H, W]
        and, when ``compute_center``, center_fields [B, H, W, 2]); the
        center head does not run otherwise."""
        dtype = self.center_field_prediction_head[0].weight.dtype
        feat = self.backbone(images.permute(0, 3, 1, 2).to(dtype))
        out = {"sdf_maps": self.sdf_prediction_head(feat)[:, 0].float()}
        if compute_center:
            center = self.center_field_prediction_head(feat)
            out["center_fields"] = center.permute(0, 2, 3, 1).float().contiguous()
        return out
