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
``remat_vit`` checkpoints the ViT blocks of the first two in training and
``vit_pack`` packs that many crops into one encoder sequence (numerically
the same, the crop batch must divide by it); the hybrid ignores both, as the
JAX package does.

Public layout is NHWC as in the JAX package: images [B, H, W, 3] in [0, 1];
center_fields [B, H, W, 2] (dy, dx) and sdf_maps [B, H, W], both f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.models.dpt import DPTFeatureExtractor
from unmore_tpu_torch.utils import tracing

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


def fold_linear_head(head: nn.Sequential, height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The one 3x3 convolution that a ``conv_head`` without ReLUs equals on
    [height, width] maps: (kernel [out, in_ch, 3, 3], bias map [out, height,
    width]), from the head's live weights, in float64.

    conv1x1 (W1, b1), conv3x3 (W2, b2, zero padding), conv1x1 (W3, b3),
    conv1x1 (W4, b4) is conv3x3(x, K) + B with v = W4 W3 and K[t] = v W2[t] W1
    for each tap t. B is c = v b2 + W4 b3 + b4 plus k[t] = v W2[t] b1 for each
    tap that lands inside the map: constant inside, other on the one-pixel
    border, where the padding holds zeros and not conv1x1's bias.
    """
    w1, w2, w3, w4 = (head[i].weight.double() for i in range(4))
    b1, b2, b3, b4 = (head[i].bias.double() for i in range(4))
    w4 = w4[:, :, 0, 0]
    v = w4 @ w3[:, :, 0, 0]
    vw2 = torch.einsum("om,mnij->onij", v, w2)
    kernel = torch.einsum("onij,nc->ocij", vw2, w1[:, :, 0, 0])
    taps = torch.einsum("onij,n->oij", vw2, b1)[:, None]
    const = v @ b2 + w4 @ b3 + b4
    bias = F.conv2d(w1.new_ones(1, 1, height, width), taps, const, padding=1)[0]
    return kernel, bias


def folded_head(head: nn.Sequential, feat: torch.Tensor) -> torch.Tensor:
    """A ``conv_head`` without ReLUs on feat [B, C, H, W] as its fold: one
    3x3 convolution in feat's dtype, then the bias map and the head's final
    activation in float32 (float64 for float64 maps). [B, out, H, W].

    The kernel goes in as two parts, its rounding to feat's dtype and the
    rest rounded again, summed in float32 after the convolution: in bf16 a
    kernel rounded once errs by a share of the sum of the terms' sizes, which
    near the SDF's zero crossings is more than the four convolutions err."""
    kernel, bias = fold_linear_head(head, feat.shape[-2], feat.shape[-1])  # autocast leaves float64 be
    hi = kernel.to(feat.dtype)
    lo = (kernel - hi.double()).to(feat.dtype)
    dtype = torch.promote_types(feat.dtype, torch.float32)
    parts = F.conv2d(feat, torch.cat([hi, lo]), padding=1).to(dtype)
    out = parts[:, : len(kernel)] + parts[:, len(kernel) :] + bias.to(dtype)
    return head[4](out) if len(head) > 4 else out


class ObjectnessNet(nn.Module):
    def __init__(self, backbone_type: str = "dpt_large", sdf_activation: str | None = "tanh",
                 use_bg_sdf: bool = True, features: int = 256, vit_config=None, hooks=None,
                 widths=None, remat_vit: bool = False, hybrid_resnet_kwargs=None, vit_pack: int = 1):
        super().__init__()
        self.sdf_activation, self.use_bg_sdf = sdf_activation, use_bg_sdf  # the SDF head's layout
        if backbone_type not in BACKBONE_ALIASES:
            raise ValueError(f"unknown backbone_type {backbone_type!r}; choose one of {sorted(BACKBONE_ALIASES)}")
        self.backbone = DPTFeatureExtractor(
            BACKBONE_ALIASES[backbone_type], features, vit_config=vit_config, hooks=hooks, widths=widths,
            remat_vit=remat_vit, hybrid_resnet_kwargs=hybrid_resnet_kwargs, vit_pack=vit_pack,
        )
        self.center_field_prediction_head = conv_head(features, 2, use_relu=True)
        use_relu, final = sdf_head_layout(sdf_activation, use_bg_sdf)
        self.sdf_prediction_head = conv_head(features, 1, use_relu, final)
        self.sdf_head_is_linear = not use_relu

    def forward(self, images: torch.Tensor, compute_center: bool = True) -> dict:
        """images [B, H, W, 3] in [0, 1]. Returns dict(sdf_maps [B, H, W]
        and, when ``compute_center``, center_fields [B, H, W, 2]); the
        center head does not run otherwise. Without a gradient, a linear SDF
        head runs as its fold (:func:`folded_head`), counted in
        ``models.sdf_fold.calls``."""
        dtype = self.center_field_prediction_head[0].weight.dtype
        feat = self.backbone(images.permute(0, 3, 1, 2).to(dtype))
        if self.sdf_head_is_linear and not torch.is_grad_enabled():
            tracing.count("models.sdf_fold.calls")
            out = {"sdf_maps": folded_head(self.sdf_prediction_head, feat)[:, 0].float()}
        else:
            out = {"sdf_maps": self.sdf_prediction_head(feat)[:, 0].float()}
        if compute_center:
            center = self.center_field_prediction_head(feat)
            out["center_fields"] = center.permute(0, 2, 3, 1).float().contiguous()
        return out
