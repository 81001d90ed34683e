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

At inference on a card the forward replays a CUDA graph of itself for each
input signature it has met before (:meth:`ObjectnessNet.forward`): a
discovery round's small chunks then cost one launch instead of ~600.
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


class _Graph:
    """One captured forward: the static input it reads ([B, 3, H, W] in the
    model's dtype, over NHWC storage as the eager cast leaves it), the graph,
    and the static outputs it writes."""

    def __init__(self, images: torch.Tensor, dtype: torch.dtype, pool, forward):
        self.x = torch.empty(images.shape, dtype=dtype, device=images.device).permute(0, 3, 1, 2)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = forward(self.x)

    def __call__(self, images: torch.Tensor) -> dict:
        self.x.copy_(images.permute(0, 3, 1, 2))
        self.graph.replay()
        # fresh tensors, as the eager forward returns: the next replay writes
        # the static outputs again
        return {k: v.clone() for k, v in self.out.items()}


def replayable(images: torch.Tensor) -> bool:
    """Whether a forward on ``images`` may run as a CUDA graph: a CUDA input,
    no gradient, no autocast, and no capture under way."""
    return (images.is_cuda and not torch.is_grad_enabled() and not torch.is_autocast_enabled(images.device.type)
            and not torch.cuda.is_current_stream_capturing())


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
        self._drop_graphs()

    def _drop_graphs(self):
        self._graphs = {}  # input signature -> _Graph, or None once met and not captured
        self._graph_pool = None

    def _apply(self, fn, recurse=True):
        """Any ``.to``/``.cuda``/``.half`` may give the leaves new storage,
        which a captured graph would not read: the graphs go."""
        self._drop_graphs()
        return super()._apply(fn, recurse)

    def load_state_dict(self, *args, **kwargs):
        self._drop_graphs()  # ``assign=True`` gives the leaves new storage
        return super().load_state_dict(*args, **kwargs)

    def forward(self, images: torch.Tensor, compute_center: bool = True) -> dict:
        """images [B, H, W, 3] in [0, 1]. Returns dict(sdf_maps [B, H, W]
        and, when ``compute_center``, center_fields [B, H, W, 2]); the
        center head does not run otherwise. Without a gradient, a linear SDF
        head runs as its fold (:func:`folded_head`), counted in
        ``models.sdf_fold.calls``.

        Where :func:`replayable` holds, the first call with a signature
        (``compute_center``, shape, dtype, device, inference mode) runs
        eagerly, which warms cuDNN and cuBLAS and fills the resize weights'
        cache; the second captures the forward as a CUDA graph
        (``models.graph.captures``), and that call and every later one copy
        the input into the graph's static input, replay it and return clones
        of its outputs (a replay after the capturing call counts in
        ``models.graph.replays``). A replay reads the parameters' storage as
        it is then, so in-place updates reach it; it runs no module hooks.
        No graph is captured while a torch profiler collects."""
        dtype = self.center_field_prediction_head[0].weight.dtype
        fold = self.sdf_head_is_linear and not torch.is_grad_enabled()
        if fold:
            tracing.count("models.sdf_fold.calls")
        if replayable(images):
            key = (compute_center, tuple(images.shape), images.dtype, images.device, torch.is_inference_mode_enabled())
            graph = self._graphs.get(key)
            if graph is not None:
                tracing.count(tracing.GRAPH_REPLAYS)
                return graph(images)
            if key in self._graphs and not tracing.profiling():
                graph = self._graphs[key] = self._capture(images, dtype, compute_center, fold)
                return graph(images)
            self._graphs[key] = None
        return self._forward(images.permute(0, 3, 1, 2).to(dtype), compute_center, fold)

    def _capture(self, images, dtype, compute_center: bool, fold: bool) -> _Graph:
        if self._graph_pool is None:
            # one pool for all the graphs: replays run one at a time on the
            # caller's stream and each call clones its outputs before the next
            # replay, so one graph's scratch may overwrite another's
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = _Graph(images, dtype, self._graph_pool, lambda x: self._forward(x, compute_center, fold))
        tracing.count(tracing.GRAPH_CAPTURES)
        return graph

    def _forward(self, x: torch.Tensor, compute_center: bool, fold: bool) -> dict:
        """The forward on x [B, 3, H, W] in the model's dtype."""
        feat = self.backbone(x)
        if fold:
            out = {"sdf_maps": folded_head(self.sdf_prediction_head, feat)[:, 0].float()}
        else:
            out = {"sdf_maps": self.sdf_prediction_head(feat)[:, 0].float()}
        if compute_center:
            center = self.center_field_prediction_head(feat)
            out["center_fields"] = center.permute(0, 2, 3, 1).float().contiguous()
        return out
