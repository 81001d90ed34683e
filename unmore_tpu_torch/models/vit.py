"""Vision Transformer backbone with intermediate taps (port of ``models/vit.py``).

timm's ``vit_large_patch16_384`` / ``vit_base_patch16_384`` layout: pre-LN
blocks, fused qkv with bias, exact GELU MLP, no final norm (DPT reads only
the hooked block outputs). Parameter names follow the reference checkpoint
(``backbone.pretrained.model.*`` once nested in the DPT module). Position
embeddings are stored at the pretraining grid and bilinearly resized
(``align_corners=False``) to the runtime grid. Attention is a plain matmul
with the softmax in f32. With ``remat`` each block runs under
``torch.utils.checkpoint`` while gradients are on: its activations are
recomputed in the backward pass (the JAX package's ``remat_vit``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unmore_tpu_torch.ops.image import resize_bilinear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    depth: int
    dim: int
    heads: int
    mlp_dim: int
    patch: int = 16
    pretrain_grid: int = 24  # 384 // 16
    in_chans: int = 3


VIT_CONFIGS = {
    "vitl16_384": ViTConfig(depth=24, dim=1024, heads=16, mlp_dim=4096),
    "vitb16_384": ViTConfig(depth=12, dim=768, heads=12, mlp_dim=3072),
}


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)  # [B, H, N, N]
        attn = attn.float().softmax(dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.dim, cfg.patch, stride=cfg.patch)


class ViTBackbone(nn.Module):
    """forward(images [B, 3, H, W]) -> list of [B, 1 + h*w, C] token maps,
    the outputs of blocks ``hooks[i]``; cls token at index 0."""

    def __init__(self, config: ViTConfig, hooks, remat: bool = False):
        super().__init__()
        self.config = config
        self.hooks = tuple(hooks)
        self.remat = remat
        self.cls_token = nn.Parameter(torch.zeros(1, 1, config.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + config.pretrain_grid**2, config.dim))
        self.patch_embed = PatchEmbed(config)
        self.blocks = nn.ModuleList(
            Block(config.dim, config.heads, config.mlp_dim) for _ in range(config.depth)
        )

    def forward(self, x):
        cfg = self.config
        B, _, H, W = x.shape
        gh, gw = H // cfg.patch, W // cfg.patch
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # [B, gh*gw, C]
        g = cfg.pretrain_grid
        pos_grid = self.pos_embed[:, 1:].reshape(1, g, g, cfg.dim)
        if (gh, gw) != (g, g):
            pos_grid = resize_bilinear(pos_grid, (gh, gw), align_corners=False)
        pos = torch.cat(
            [self.pos_embed[:, :1].to(tokens.dtype), pos_grid.reshape(1, gh * gw, cfg.dim).to(tokens.dtype)],
            dim=1,
        )
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(B, -1, -1), tokens], dim=1) + pos
        taps = {}
        last = max(self.hooks)
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks[: last + 1]):
            tokens = checkpoint(blk, tokens, use_reentrant=False) if remat else blk(tokens)
            if i in self.hooks:
                taps[i] = tokens
        return [taps[h] for h in self.hooks]
