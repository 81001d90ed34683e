"""DPT feature extractor (port of ``models/dpt.py``), NCHW.

ViT taps -> project-readout -> reassemble (1x1 conv + {x4 deconv, x2
deconv, id, /2 conv}) -> 3x3 ``layer*_rn`` convs to a common width -> four
refinenet fusion blocks (residual conv units, x2 ``align_corners=True``
upsampling, 1x1 out conv) -> final x2 upsample. For a 128^2 input with patch
16 the pyramid is 32/16/8/4, fused back to 64, then 128. The hybrid
(``vitb_rn50_384``) takes its first two maps from the ResNetV2 trunk's
stages as they are: ``act_postprocess1/2`` are identities with no
parameters, as in the reference.

Module names follow the reference checkpoint: ``pretrained.model`` (the
ViT), ``pretrained.act_postprocess{n}.{0,3,4}``, ``scratch.layer{n}_rn``,
``scratch.refinenet{n}.{resConfUnit1,resConfUnit2,out_conv}``. Like the
reference, ``refinenet4`` holds a ``resConfUnit1`` that it never runs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unmore_tpu_torch.models.hybrid import HybridViTBackbone
from unmore_tpu_torch.models.vit import VIT_CONFIGS, ViTBackbone, ViTConfig
from unmore_tpu_torch.ops.image import resize_bilinear_nchw

# per-backbone reassemble widths and hooked blocks
DPT_BACKBONE_SPECS = {
    "vitl16_384": dict(vit="vitl16_384", features=(256, 512, 1024, 1024), hooks=(5, 11, 17, 23)),
    "vitb16_384": dict(vit="vitb16_384", features=(96, 192, 384, 768), hooks=(2, 5, 8, 11)),
    # hybrid: maps 1/2 from the trunk's stages, 3/4 from ViT blocks 8/11
    "vitb_rn50_384": dict(vit="vitb16_384", features=(256, 512, 768, 768), hooks=(8, 11)),
}
HYBRID = "vitb_rn50_384"


class ProjectReadout(nn.Module):
    """Fuse the cls token into every patch token: Linear(2C -> C) + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):  # [B, 1+N, C] -> [B, N, C]
        patches = tokens[:, 1:]
        readout = tokens[:, :1].expand_as(patches)
        return self.project(torch.cat([patches, readout], dim=-1))


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, residual."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Optional skip through resConfUnit1, then resConfUnit2, x2
    ``align_corners`` upsample (in f32), 1x1 out conv."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        h, w = x.shape[-2] * 2, x.shape[-1] * 2
        x = resize_bilinear_nchw(x, (h, w), align_corners=True).to(x.dtype)
        return self.out_conv(x)


def _reassemble(i: int, dim: int, width: int) -> nn.Sequential:
    post = nn.Sequential()
    post.add_module("0", ProjectReadout(dim))
    post.add_module("1", nn.Identity())  # reference Transpose
    post.add_module("2", nn.Identity())  # reference Unflatten
    post.add_module("3", nn.Conv2d(dim, width, 1))
    if i == 0:
        post.add_module("4", nn.ConvTranspose2d(width, width, 4, stride=4))
    elif i == 1:
        post.add_module("4", nn.ConvTranspose2d(width, width, 2, stride=2))
    elif i == 3:
        post.add_module("4", nn.Conv2d(width, width, 3, stride=2, padding=1))
    return post


class DPTFeatureExtractor(nn.Module):
    """images [B, 3, H, W] -> features [B, features, H, W].

    ``backbone`` picks a named spec; ``vit_config``/``hooks``/``widths``/
    ``hybrid_resnet_kwargs`` override it (the tests use miniature
    dimensions). ``remat_vit`` checkpoints the ViT blocks in training
    (:class:`ViTBackbone`); the hybrid ignores it, as the JAX package does.
    """

    def __init__(self, backbone: str = "vitl16_384", features: int = 256,
                 vit_config: ViTConfig | None = None, hooks=None, widths=None, remat_vit: bool = False,
                 hybrid_resnet_kwargs=None):
        super().__init__()
        spec = DPT_BACKBONE_SPECS[backbone]
        vit_cfg = vit_config or VIT_CONFIGS[spec["vit"]]
        hooks = tuple(hooks) if hooks is not None else spec["hooks"]
        widths = tuple(widths) if widths is not None else spec["features"]
        self.patch = vit_cfg.patch
        self.pretrained = nn.Module()
        if backbone == HYBRID:
            self.pretrained.model = HybridViTBackbone(vit_cfg, hooks, hybrid_resnet_kwargs)
        else:
            self.pretrained.model = ViTBackbone(vit_cfg, hooks, remat=remat_vit)
        for i in range(4):  # the hybrid's first two maps are the trunk's stages
            post = nn.Identity() if backbone == HYBRID and i < 2 else _reassemble(i, vit_cfg.dim, widths[i])
            setattr(self.pretrained, f"act_postprocess{i + 1}", post)
        self.scratch = nn.Module()
        for n in range(1, 5):
            setattr(self.scratch, f"layer{n}_rn", nn.Conv2d(widths[n - 1], features, 3, padding=1, bias=False))
            setattr(self.scratch, f"refinenet{n}", FeatureFusionBlock(features))

    def forward(self, x):
        B, _, H, W = x.shape
        gh, gw = H // self.patch, W // self.patch
        maps = []
        for i, tap in enumerate(self.pretrained.model(x)):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            if isinstance(post, nn.Identity):  # a trunk stage's map
                maps.append(tap)
                continue
            t = post[0](tap)
            fmap = post[3](t.transpose(1, 2).reshape(B, t.shape[-1], gh, gw))
            if len(post) > 4:
                fmap = post[4](fmap)
            maps.append(fmap)
        sc = self.scratch
        rn = [getattr(sc, f"layer{n}_rn")(maps[n - 1]) for n in range(1, 5)]
        path = sc.refinenet4(rn[3])
        path = sc.refinenet3(path, rn[2])
        path = sc.refinenet2(path, rn[1])
        path = sc.refinenet1(path, rn[0])
        out = resize_bilinear_nchw(path, (path.shape[-2] * 2, path.shape[-1] * 2), align_corners=True)
        return out.to(path.dtype)
