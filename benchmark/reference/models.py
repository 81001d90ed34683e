"""Plain float32 reference of the models the benchmark runs: ObjectnessNet on
DPT (ViT-L/16 or the R50+ViT-B/16 hybrid) and the ResNet-50 existence
classifier.

Written after the published descriptions (Ranftl et al. 2021, arXiv
2103.13413, for DPT; He et al. 2016 for ResNet-50; timm's
``vit_base_r50_s16_384`` for the hybrid trunk) in plain ``torch`` ops, with
the module names of the reference checkpoint so that one state dict loads
into this model and into the system under test alike. It imports nothing of
the system: no kernel, no cache, no batching tricks. Departures from the
published models are the system's own conventions, kept here on purpose:
crops are NHWC in [0, 1], the SDF head ends in tanh without intermediate
ReLUs (``use_bg_sdf``), and BatchNorm's running statistics move by flax's
rule (momentum 0.9 on the biased batch variance).

``quant="fp8"`` is the precision below the system's bf16 autocast, the
control that the check must fail: both operands of every convolution and
matrix product are rounded to float8 e4m3 (per-tensor scale, amax over
448) and the product's result to bfloat16, as fp8 tensor-core products
with bf16 outputs would give; the rest stays in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16; the gradient passes straight through."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


class Quant:
    """How products round: not at all (f32), or fp8 operands and bf16 results."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x):
        return fp8_round(x) if self.mode == "fp8" else x

    def out(self, x):
        return bf16_round(x) if self.mode == "fp8" else x


Q = Quant()  # replaced per model by set_precision


def set_precision(model: nn.Module, mode: str):
    for m in model.modules():
        m._quant = Quant(mode)
    return model


def _q(module, x):
    return getattr(module, "_quant", Q)(x)


def _o(module, x):
    return getattr(module, "_quant", Q).out(x)


class Linear(nn.Linear):
    def forward(self, x):
        return _o(self, F.linear(_q(self, x), _q(self, self.weight), self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return _o(self, F.conv2d(_q(self, x), _q(self, self.weight), self.bias, self.stride, self.padding))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return _o(self, F.conv_transpose2d(_q(self, x), _q(self, self.weight), self.bias, self.stride))


# ------------------------------------------------------------------ ViT
class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = _o(self, (_q(self, q) * hd**-0.5) @ _q(self, k).transpose(-2, -1))
        attn = attn.softmax(dim=-1)
        return self.proj(_o(self, _q(self, attn) @ _q(self, v)).transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_dim):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-6), nn.LayerNorm(dim, eps=1e-6)
        self.attn, self.mlp = Attention(dim, heads), Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, in_chans=3):
        super().__init__()
        self.proj = Conv2d(in_chans, dim, patch, stride=patch)


class ViT(nn.Module):
    """Tokens of the blocks in ``hooks`` (cls first); position embeddings at
    the pretraining grid, resized bilinearly to the crop's grid."""

    def __init__(self, vit: dict, hooks, patch_embed=None):
        super().__init__()
        self.dim, self.patch, self.grid = vit["dim"], vit["patch"], vit["pretrain_grid"]
        self.hooks = tuple(hooks)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, self.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.grid**2, self.dim))
        self.patch_embed = patch_embed or PatchEmbed(self.dim, self.patch)
        self.blocks = nn.ModuleList(Block(self.dim, vit["heads"], vit["mlp_dim"]) for _ in range(vit["depth"]))

    def encode(self, grid):
        B, _, gh, gw = grid.shape
        tokens = grid.flatten(2).transpose(1, 2)
        g = self.grid
        pos = self.pos_embed[:, 1:].reshape(1, g, g, self.dim).permute(0, 3, 1, 2)
        if (gh, gw) != (g, g):
            pos = F.interpolate(pos, size=(gh, gw), mode="bilinear", align_corners=False)
        pos = torch.cat([self.pos_embed[:, :1], pos.flatten(2).transpose(1, 2)], dim=1)
        x = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1) + pos
        taps = {}
        for i, blk in enumerate(self.blocks[: max(self.hooks) + 1]):
            x = blk(x)
            if i in self.hooks:
                taps[i] = x
        return [taps[h] for h in self.hooks]

    def forward(self, x):
        return self.encode(self.patch_embed.proj(x))


# ------------------------------------------------------- hybrid trunk
def _same_pads(size, k, stride):
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class StdConv2dSame(nn.Conv2d):
    """Weight-standardised convolution (eps 1e-8) with TF-SAME padding."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (l, r) = _same_pads(x.shape[-2], k, s), _same_pads(x.shape[-1], k, s)
        x = F.pad(x, (l, r, t, b))
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, correction=0)
        w = (self.weight - mean) / torch.sqrt(var + 1e-8)
        return _o(self, F.conv2d(_q(self, x), _q(self, w), None, self.stride))


class DownsampleConv(nn.Module):
    def __init__(self, cin, cout, stride, groups):
        super().__init__()
        self.conv, self.norm = StdConv2dSame(cin, cout, 1, stride), nn.GroupNorm(groups, cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class V2Bottleneck(nn.Module):
    def __init__(self, cin, mid, out, stride, downsample, groups):
        super().__init__()
        self.downsample = DownsampleConv(cin, out, stride, groups) if downsample else None
        self.conv1, self.norm1 = StdConv2dSame(cin, mid, 1), nn.GroupNorm(groups, mid, eps=1e-5)
        self.conv2, self.norm2 = StdConv2dSame(mid, mid, 3, stride), nn.GroupNorm(groups, mid, eps=1e-5)
        self.conv3, self.norm3 = StdConv2dSame(mid, out, 1), nn.GroupNorm(groups, out, eps=1e-5)

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(self.norm3(self.conv3(y)) + short)


class ResNetV2Stages(nn.Module):
    def __init__(self, stem_width=64, stage_widths=((64, 256), (128, 512), (256, 1024)),
                 stage_blocks=(3, 4, 9), groups=32):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv2dSame(3, stem_width, 7, 2)
        self.stem.norm = nn.GroupNorm(groups, stem_width, eps=1e-5)
        self.stages = nn.ModuleList()
        cin = stem_width
        for s, ((mid, out), nb) in enumerate(zip(stage_widths, stage_blocks)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                V2Bottleneck(cin if b == 0 else out, mid, out, 2 if (s > 0 and b == 0) else 1, b == 0, groups)
                for b in range(nb))
            self.stages.append(stage)
            cin = out
        self.out_channels = cin

    def forward(self, x):
        y = F.relu(self.stem.norm(self.stem.conv(x)))
        (t, b), (l, r) = _same_pads(y.shape[-2], 3, 2), _same_pads(y.shape[-1], 3, 2)
        y = F.max_pool2d(F.pad(y, (l, r, t, b), value=float("-inf")), 3, 2)
        taps = []
        for stage in self.stages:
            for blk in stage.blocks:
                y = blk(y)
            taps.append(y)
        return taps


class HybridViT(ViT):
    def __init__(self, vit: dict, hooks, trunk: dict):
        body = ResNetV2Stages(**{k: tuple(map(tuple, v)) if k == "stage_widths" else v for k, v in trunk.items()})
        embed = nn.Module()
        embed.backbone = body
        embed.proj = Conv2d(body.out_channels, vit["dim"], 1)
        super().__init__(vit, hooks, patch_embed=embed)

    def forward(self, x):
        s0, s1, feat = self.patch_embed.backbone(x)
        return [s0, s1, *self.encode(self.patch_embed.proj(feat))]


# ------------------------------------------------------------------ DPT
def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1, self.conv2 = Conv2d(f, f, 3, padding=1), Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.resConfUnit1, self.resConfUnit2 = ResidualConvUnit(f), ResidualConvUnit(f)
        self.out_conv = Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_up2(self.resConfUnit2(x)))


class ProjectReadout(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        patches = tokens[:, 1:]
        return self.project(torch.cat([patches, tokens[:, :1].expand_as(patches)], dim=-1))


def _reassemble(i, dim, width):
    post = nn.Sequential()
    post.add_module("0", ProjectReadout(dim))
    post.add_module("1", nn.Identity())
    post.add_module("2", nn.Identity())
    post.add_module("3", Conv2d(dim, width, 1))
    if i == 0:
        post.add_module("4", ConvTranspose2d(width, width, 4, stride=4))
    elif i == 1:
        post.add_module("4", ConvTranspose2d(width, width, 2, stride=2))
    elif i == 3:
        post.add_module("4", Conv2d(width, width, 3, stride=2, padding=1))
    return post


class DPT(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        vit, hooks, widths, feats = cfg["vit"], cfg["hooks"], cfg["widths"], cfg["features"]
        self.patch = vit["patch"]
        self.hybrid = "trunk" in cfg
        self.pretrained = nn.Module()
        self.pretrained.model = HybridViT(vit, hooks, cfg["trunk"]) if self.hybrid else ViT(vit, hooks)
        for i in range(4):
            post = nn.Identity() if self.hybrid and i < 2 else _reassemble(i, vit["dim"], widths[i])
            setattr(self.pretrained, f"act_postprocess{i + 1}", post)
        self.scratch = nn.Module()
        for n in range(1, 5):
            setattr(self.scratch, f"layer{n}_rn", Conv2d(widths[n - 1], feats, 3, padding=1, bias=False))
            setattr(self.scratch, f"refinenet{n}", FeatureFusionBlock(feats))

    def forward(self, x):
        B, _, H, W = x.shape
        gh, gw = H // self.patch, W // self.patch
        maps = []
        for i, tap in enumerate(self.pretrained.model(x)):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            if isinstance(post, nn.Identity):
                maps.append(tap)
                continue
            t = post[0](tap)
            fmap = post[3](t.transpose(1, 2).reshape(B, t.shape[-1], gh, gw))
            maps.append(post[4](fmap) if len(post) > 4 else fmap)
        sc = self.scratch
        rn = [getattr(sc, f"layer{n}_rn")(maps[n - 1]) for n in range(1, 5)]
        path = sc.refinenet4(rn[3])
        path = sc.refinenet3(path, rn[2])
        path = sc.refinenet2(path, rn[1])
        return _up2(sc.refinenet1(path, rn[0]))


def conv_head(cin, cout, final_tanh):
    layers = []
    for i, conv in enumerate((Conv2d(cin, 512, 1), Conv2d(512, 512, 3, padding=1), Conv2d(512, 1024, 1))):
        layers.append(conv)
        if not final_tanh:
            layers.append(nn.ReLU())
    layers.append(Conv2d(1024, cout, 1))
    if final_tanh:
        layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class ObjectnessNet(nn.Module):
    """crops [B, S, S, 3] in [0, 1] -> sdf_maps [B, S, S] and, with
    ``compute_center``, center_fields [B, S, S, 2]. The tanh bg-sdf head
    (``use_bg_sdf``, ``sdf_activation="tanh"``) is the one the benchmark runs."""

    def __init__(self, cfg: dict):
        super().__init__()
        if not (cfg["use_bg_sdf"] and cfg["sdf_activation"] == "tanh"):
            raise ValueError("the reference holds the tanh bg-sdf ObjectnessNet only")
        self.backbone = DPT(cfg)
        self.center_field_prediction_head = conv_head(cfg["features"], 2, False)
        self.sdf_prediction_head = conv_head(cfg["features"], 1, True)

    def forward(self, crops, compute_center=True):
        feat = self.backbone(crops.permute(0, 3, 1, 2))
        out = {"sdf_maps": self.sdf_prediction_head(feat)[:, 0]}
        if compute_center:
            out["center_fields"] = self.center_field_prediction_head(feat).permute(0, 2, 3, 1)
        return out


# ------------------------------------------------------------ ResNet-50
class FlaxBatchNorm2d(nn.BatchNorm2d):
    """Train mode: batch statistics, running ones moved by momentum 0.9 on
    the biased variance (flax). Eval mode: the running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(cin, planes, 1, bias=False), FlaxBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3, self.bn3 = Conv2d(planes, planes * 4, 1, bias=False), FlaxBatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
                                        FlaxBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    def __init__(self, stage_blocks=(3, 4, 6, 3)):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False), FlaxBatchNorm2d(64)
        cin, planes = 64, 64
        self.n_stages = len(stage_blocks)
        for stage, blocks in enumerate(stage_blocks, start=1):
            layer = nn.Sequential()
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, 2 if (stage > 1 and b == 0) else 1, b == 0))
                cin = planes * 4
            setattr(self, f"layer{stage}", layer)
            planes *= 2
        self.fc = Linear(cin, 1000)

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        for stage in range(1, self.n_stages + 1):
            out = getattr(self, f"layer{stage}")(out)
        return self.fc(out.mean(dim=(2, 3)))


class BinaryClassifier(nn.Module):
    """crops [B, S, S, 3] -> existence scores [B]: ResNet-50, Linear(1000, 1), sigmoid."""

    def __init__(self, stage_blocks=(3, 4, 6, 3)):
        super().__init__()
        self.classifier_backbone = ResNet50(stage_blocks)
        self.binary_classification_head = Linear(1000, 1)

    def forward(self, crops):
        return torch.sigmoid(self.binary_classification_head(self.classifier_backbone(crops.permute(0, 3, 1, 2))))[:, 0]


def dpt_spec(config: dict) -> dict:
    """The objectness model's sizes from a configuration file."""
    spec = {k: config[k] for k in ("vit", "hooks", "widths", "features", "sdf_activation", "use_bg_sdf")}
    if "trunk" in config:
        spec["trunk"] = config["trunk"]
    return spec


def build_objectness(config: dict, device="cpu") -> ObjectnessNet:
    return ObjectnessNet(dpt_spec(config)).to(device)


def build_classifier(config: dict, device="cpu") -> BinaryClassifier:
    return BinaryClassifier(tuple(config["classifier_stage_blocks"])).to(device)
