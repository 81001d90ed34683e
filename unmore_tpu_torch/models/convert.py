"""Weights carried across: JAX param trees and reference checkpoints to
this package's state_dicts.

The port's parameter names are the reference checkpoint's, so a reference
``.ckpt``'s ``model_state_dict`` loads directly. The two functions
``*_state_dict_from_flax`` invert the JAX package's ``models/convert.py``
(numpy param trees in, torch state_dicts out):

* Conv2d kernel HWIO -> OIHW; ConvTranspose2d kernel (``transpose_kernel=True``,
  [H, W, O, I]) -> IOHW: both are a (3, 2, 0, 1) transpose
* Dense kernel [in, out] -> Linear weight [out, in]
* BatchNorm ``scale/bias`` + ``batch_stats`` ``mean/var`` -> ``weight/bias/
  running_mean/running_var``; LayerNorm and GroupNorm ``scale`` -> ``weight``
* the hybrid's trunk: ``backbone/vit/resnet/{stem_conv, stem_norm,
  stage{s}_block{b}/{conv1..3, norm1..3, downsample_conv, downsample_norm}}``
  -> ``backbone.pretrained.model.patch_embed.backbone.{stem.{conv,norm},
  stages.{s}.blocks.{b}.{conv1..3, norm1..3, downsample.{conv,norm}}}``; its
  1x1 projection ``backbone/vit/patch_embed`` -> ``...patch_embed.proj``

The way back, port -> JAX (the trainers' checkpoints), goes through
:func:`flax_layout`: one rule per key, so that the same map carries the
weights and the optimizer's moments (``mu``, ``nu``, ``trace``), which have
the weights' tree.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from unmore_tpu_torch.models.objectness import sdf_head_layout

# reference-checkpoint keys the port's modules hold but never run, or that
# the reference holds and the port has no module for (the ViT's final norm
# and classifier head: DPT reads only the hooked blocks)
_UNUSED_OBJECTNESS = (
    re.compile(r"backbone\.scratch\.refinenet4\.resConfUnit1\."),
    re.compile(r"backbone\.pretrained\.model\.(norm|head)\."),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _linear(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _head_indices(use_relu: bool) -> list[int]:
    return [0, 2, 4, 6] if use_relu else [0, 1, 2, 3]


def _trunk_from_flax(resnet: Mapping[str, Any], sd: dict):
    """The hybrid's ResNetV2 trunk (``backbone/vit/resnet``) into ``sd``."""
    t = "backbone.pretrained.model.patch_embed.backbone."

    def norm(name, leaf):
        sd[name + ".weight"] = _t(leaf["scale"])
        sd[name + ".bias"] = _t(leaf["bias"])

    sd[t + "stem.conv.weight"] = _conv(resnet["stem_conv"]["kernel"])
    norm(t + "stem.norm", resnet["stem_norm"])
    for name, blk in resnet.items():
        m = re.fullmatch(r"stage(\d)_block(\d+)", name)
        if m is None:
            continue
        bt = f"{t}stages.{m[1]}.blocks.{m[2]}."
        for c in ("conv1", "conv2", "conv3"):
            sd[bt + c + ".weight"] = _conv(blk[c]["kernel"])
        for n in ("norm1", "norm2", "norm3"):
            norm(bt + n, blk[n])
        if "downsample_conv" in blk:
            sd[bt + "downsample.conv.weight"] = _conv(blk["downsample_conv"]["kernel"])
            norm(bt + "downsample.norm", blk["downsample_norm"])


def objectness_state_dict_from_flax(params: Mapping[str, Any], sdf_activation: str | None = "tanh",
                                    use_bg_sdf: bool = True) -> dict[str, torch.Tensor]:
    """JAX ObjectnessNet params (dpt_large / dpt_base / dpt_hybrid) -> port state_dict."""
    sd: dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    vit = bb["vit"]
    m = "backbone.pretrained.model."
    sd[m + "cls_token"] = _t(vit["cls_token"])
    sd[m + "pos_embed"] = _t(vit["pos_embed"])
    sd[m + "patch_embed.proj.weight"] = _conv(vit["patch_embed"]["kernel"])
    sd[m + "patch_embed.proj.bias"] = _t(vit["patch_embed"]["bias"])
    if "resnet" in vit:
        _trunk_from_flax(vit["resnet"], sd)
    for name, blk in vit.items():
        if not re.fullmatch(r"block\d+", name):
            continue
        t = f"{m}blocks.{int(name[5:])}."
        for ln in ("norm1", "norm2"):
            sd[t + ln + ".weight"] = _t(blk[ln]["scale"])
            sd[t + ln + ".bias"] = _t(blk[ln]["bias"])
        for path, leaf in (("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                           ("mlp.fc1", blk["mlp"]["fc1"]), ("mlp.fc2", blk["mlp"]["fc2"])):
            sd[t + path + ".weight"] = _linear(leaf["kernel"])
            sd[t + path + ".bias"] = _t(leaf["bias"])

    for i in range(4):
        if f"readout{i}" not in bb:
            continue
        t = f"backbone.pretrained.act_postprocess{i + 1}."
        sd[t + "0.project.0.weight"] = _linear(bb[f"readout{i}"]["project"]["kernel"])
        sd[t + "0.project.0.bias"] = _t(bb[f"readout{i}"]["project"]["bias"])
        sd[t + "3.weight"] = _conv(bb[f"reassemble{i}"]["kernel"])
        sd[t + "3.bias"] = _t(bb[f"reassemble{i}"]["bias"])
        extra = {0: "upsample0", 1: "upsample1", 3: "downsample3"}.get(i)
        if extra is not None:
            sd[t + "4.weight"] = _conv(bb[extra]["kernel"])
            sd[t + "4.bias"] = _t(bb[extra]["bias"])

    for n in range(1, 5):
        sd[f"backbone.scratch.layer{n}_rn.weight"] = _conv(bb[f"layer{n}_rn"]["kernel"])
        r = bb[f"refinenet{n}"]
        t = f"backbone.scratch.refinenet{n}."
        sd[t + "out_conv.weight"] = _conv(r["out_conv"]["kernel"])
        sd[t + "out_conv.bias"] = _t(r["out_conv"]["bias"])
        for rcu_f, rcu_t in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if rcu_f not in r:
                continue
            for c in ("conv1", "conv2"):
                sd[f"{t}{rcu_t}.{c}.weight"] = _conv(r[rcu_f][c]["kernel"])
                sd[f"{t}{rcu_t}.{c}.bias"] = _t(r[rcu_f][c]["bias"])

    sdf_relu, _ = sdf_head_layout(sdf_activation, use_bg_sdf)
    for flax_head, torch_head, use_relu in (
        ("center_head", "center_field_prediction_head", True),
        ("sdf_head", "sdf_prediction_head", sdf_relu),
    ):
        for j, idx in enumerate(_head_indices(use_relu)):
            conv = params[flax_head][f"conv{j}"]
            sd[f"{torch_head}.{idx}.weight"] = _conv(conv["kernel"])
            sd[f"{torch_head}.{idx}.bias"] = _t(conv["bias"])
    return sd


def _bn(sd, name, scale_bias, stats):
    sd[name + ".weight"] = _t(scale_bias["scale"])
    sd[name + ".bias"] = _t(scale_bias["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def classifier_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX BinaryClassifier variables ({'params', 'batch_stats'}) -> port state_dict."""
    p = variables["params"]["backbone"]
    s = variables["batch_stats"]["backbone"]
    rb = "classifier_backbone."
    sd: dict[str, torch.Tensor] = {rb + "conv1.weight": _conv(p["conv1"]["kernel"])}
    _bn(sd, rb + "bn1", p["bn1"], s["bn1"])
    for name, blk in p.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        t = f"{rb}layer{m.group(1)}.{m.group(2)}."
        for c in ("conv1", "conv2", "conv3"):
            sd[t + c + ".weight"] = _conv(blk[c]["kernel"])
        for bn in ("bn1", "bn2", "bn3"):
            _bn(sd, t + bn, blk[bn], s[name][bn])
        if "downsample_conv" in blk:
            sd[t + "downsample.0.weight"] = _conv(blk["downsample_conv"]["kernel"])
            _bn(sd, t + "downsample.1", blk["downsample_bn"], s[name]["downsample_bn"])
    sd[rb + "fc.weight"] = _linear(p["fc"]["kernel"])
    sd[rb + "fc.bias"] = _t(p["fc"]["bias"])
    head = variables["params"]["head"]
    sd["binary_classification_head.weight"] = _linear(head["kernel"])
    sd["binary_classification_head.bias"] = _t(head["bias"])
    return sd


# ---------------------------------------------------------------- port -> JAX
# Each rule maps a port state_dict key to its leaf in the JAX tree and the
# layout change: "conv" (OIHW <-> HWIO; IOHW <-> HWOI for the transposed
# convs), "linear" ([out, in] <-> [in, out]) or "vec" (unchanged).
_OBJ = r"backbone\.pretrained\."
_TRUNK = _OBJ + r"model\.patch_embed\.backbone\."
_RESNET = ("backbone", "vit", "resnet")


def _norm_leaf(leaf: str) -> str:
    return "scale" if leaf == "weight" else "bias"


_OBJECTNESS_RULES = (
    (_TRUNK + r"stem\.conv\.weight", lambda m: (*_RESNET, "stem_conv", "kernel"), "conv"),
    (_TRUNK + r"stem\.norm\.(weight|bias)", lambda m: (*_RESNET, "stem_norm", _norm_leaf(m[1])), "vec"),
    (_TRUNK + r"stages\.(\d)\.blocks\.(\d+)\.(conv[123])\.weight",
     lambda m: (*_RESNET, f"stage{m[1]}_block{m[2]}", m[3], "kernel"), "conv"),
    (_TRUNK + r"stages\.(\d)\.blocks\.(\d+)\.(norm[123])\.(weight|bias)",
     lambda m: (*_RESNET, f"stage{m[1]}_block{m[2]}", m[3], _norm_leaf(m[4])), "vec"),
    (_TRUNK + r"stages\.(\d)\.blocks\.(\d+)\.downsample\.conv\.weight",
     lambda m: (*_RESNET, f"stage{m[1]}_block{m[2]}", "downsample_conv", "kernel"), "conv"),
    (_TRUNK + r"stages\.(\d)\.blocks\.(\d+)\.downsample\.norm\.(weight|bias)",
     lambda m: (*_RESNET, f"stage{m[1]}_block{m[2]}", "downsample_norm", _norm_leaf(m[3])), "vec"),
    (_OBJ + r"model\.(cls_token|pos_embed)", lambda m: ("backbone", "vit", m[1]), "vec"),
    (_OBJ + r"model\.patch_embed\.proj\.weight", lambda m: ("backbone", "vit", "patch_embed", "kernel"), "conv"),
    (_OBJ + r"model\.patch_embed\.proj\.bias", lambda m: ("backbone", "vit", "patch_embed", "bias"), "vec"),
    (_OBJ + r"model\.blocks\.(\d+)\.(norm[12])\.(weight|bias)",
     lambda m: ("backbone", "vit", f"block{m[1]}", m[2], "scale" if m[3] == "weight" else "bias"), "vec"),
    (_OBJ + r"model\.blocks\.(\d+)\.(attn|mlp)\.(qkv|proj|fc1|fc2)\.weight",
     lambda m: ("backbone", "vit", f"block{m[1]}", m[2], m[3], "kernel"), "linear"),
    (_OBJ + r"model\.blocks\.(\d+)\.(attn|mlp)\.(qkv|proj|fc1|fc2)\.bias",
     lambda m: ("backbone", "vit", f"block{m[1]}", m[2], m[3], "bias"), "vec"),
    (_OBJ + r"act_postprocess(\d)\.0\.project\.0\.weight",
     lambda m: ("backbone", f"readout{int(m[1]) - 1}", "project", "kernel"), "linear"),
    (_OBJ + r"act_postprocess(\d)\.0\.project\.0\.bias",
     lambda m: ("backbone", f"readout{int(m[1]) - 1}", "project", "bias"), "vec"),
    (_OBJ + r"act_postprocess(\d)\.3\.(weight|bias)",
     lambda m: ("backbone", f"reassemble{int(m[1]) - 1}", "kernel" if m[2] == "weight" else "bias"), None),
    (_OBJ + r"act_postprocess(\d)\.4\.(weight|bias)",
     lambda m: ("backbone", {"1": "upsample0", "2": "upsample1", "4": "downsample3"}[m[1]],
                "kernel" if m[2] == "weight" else "bias"), None),
    (r"backbone\.scratch\.layer(\d)_rn\.weight", lambda m: ("backbone", f"layer{m[1]}_rn", "kernel"), "conv"),
    (r"backbone\.scratch\.refinenet(\d)\.out_conv\.(weight|bias)",
     lambda m: ("backbone", f"refinenet{m[1]}", "out_conv", "kernel" if m[2] == "weight" else "bias"), None),
    (r"backbone\.scratch\.refinenet(\d)\.resConfUnit([12])\.(conv[12])\.(weight|bias)",
     lambda m: None if (m[1], m[2]) == ("4", "1") else  # refinenet4 never runs its resConfUnit1
     ("backbone", f"refinenet{m[1]}", f"rcu{m[2]}", m[3], "kernel" if m[4] == "weight" else "bias"), None),
)
_CLS = r"classifier_backbone\."
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _bn_path(name: tuple[str, ...], leaf: str):
    col, key = _BN_LEAF[leaf]
    return (col, "backbone", *name, key)


_CLASSIFIER_RULES = (
    (_CLS + r"conv1\.weight", lambda m: ("params", "backbone", "conv1", "kernel"), "conv"),
    (_CLS + r"bn1\.(weight|bias|running_mean|running_var)", lambda m: _bn_path(("bn1",), m[1]), "vec"),
    (_CLS + r"layer(\d)\.(\d+)\.(conv[123])\.weight",
     lambda m: ("params", "backbone", f"layer{m[1]}_{m[2]}", m[3], "kernel"), "conv"),
    (_CLS + r"layer(\d)\.(\d+)\.(bn[123])\.(weight|bias|running_mean|running_var)",
     lambda m: _bn_path((f"layer{m[1]}_{m[2]}", m[3]), m[4]), "vec"),
    (_CLS + r"layer(\d)\.(\d+)\.downsample\.0\.weight",
     lambda m: ("params", "backbone", f"layer{m[1]}_{m[2]}", "downsample_conv", "kernel"), "conv"),
    (_CLS + r"layer(\d)\.(\d+)\.downsample\.1\.(weight|bias|running_mean|running_var)",
     lambda m: _bn_path((f"layer{m[1]}_{m[2]}", "downsample_bn"), m[3]), "vec"),
    (_CLS + r"fc\.weight", lambda m: ("params", "backbone", "fc", "kernel"), "linear"),
    (_CLS + r"fc\.bias", lambda m: ("params", "backbone", "fc", "bias"), "vec"),
    (r"binary_classification_head\.weight", lambda m: ("params", "head", "kernel"), "linear"),
    (r"binary_classification_head\.bias", lambda m: ("params", "head", "bias"), "vec"),
)
_TO_FLAX = {"conv": (2, 3, 1, 0), "linear": (1, 0)}
_FROM_FLAX = {"conv": (3, 2, 0, 1), "linear": (1, 0)}


def _head_rules(keys) -> dict[str, tuple[tuple[str, ...], str]]:
    """The conv heads: ``<head>.<idx>`` is ``conv<j>`` for the j-th conv index."""
    out = {}
    for torch_head, flax_head in (("center_field_prediction_head", "center_head"),
                                  ("sdf_prediction_head", "sdf_head")):
        idxs = sorted({int(m[1]) for k in keys if (m := re.fullmatch(rf"{torch_head}\.(\d+)\.weight", k))})
        for j, idx in enumerate(idxs):
            out[f"{torch_head}.{idx}.weight"] = ((flax_head, f"conv{j}", "kernel"), "conv")
            out[f"{torch_head}.{idx}.bias"] = ((flax_head, f"conv{j}", "bias"), "vec")
    return out


def flax_layout(keys, model: str) -> dict[str, tuple[tuple[str, ...], str]]:
    """For each port state_dict key of ``model`` ("objectness" or
    "classifier") that the JAX tree holds: (its path in the JAX tree, its
    layout rule). Keys the JAX model has no leaf for (refinenet4's
    ``resConfUnit1``, ``num_batches_tracked``) are left out."""
    keys = list(keys)
    rules = _OBJECTNESS_RULES if model == "objectness" else _CLASSIFIER_RULES
    out = _head_rules(keys) if model == "objectness" else {}
    for k in keys:
        for pattern, path_of, kind in rules:
            m = re.fullmatch(pattern, k)
            if m is None:
                continue
            path = path_of(m)
            if path is not None:
                out[k] = (path, kind or ("conv" if path[-1] == "kernel" else "vec"))
            break
    return out


def flax_tree(tensors: Mapping[str, Any], layout) -> dict:
    """Port tensors by state_dict key -> the nested JAX tree of numpy f32
    leaves, for the keys of ``layout`` (see :func:`flax_layout`)."""
    tree: dict = {}
    for k, (path, kind) in layout.items():
        a = tensors[k]
        a = a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(np.transpose(a, _TO_FLAX[kind]) if kind in _TO_FLAX else a)
    return tree


def flax_shape(shape, kind: str) -> tuple[int, ...]:
    """A port tensor's shape in the JAX tree under the layout rule ``kind``
    ("conv", "linear" or "vec")."""
    perm = _TO_FLAX.get(kind)
    return tuple(shape) if perm is None else tuple(shape[i] for i in perm)


def tensors_from_flax(tree: Mapping[str, Any], layout) -> dict[str, torch.Tensor]:
    """The inverse of :func:`flax_tree`: a JAX tree -> f32 tensors by key. A
    tree of torch tensors stays on its device (the leaves become views)."""
    out = {}
    for k, (path, kind) in layout.items():
        a = tree
        for p in path:
            a = a[p]
        if isinstance(a, torch.Tensor):
            out[k] = a.permute(_FROM_FLAX[kind]) if kind in _FROM_FLAX else a
            continue
        a = np.asarray(a, np.float32)
        out[k] = _t(np.transpose(a, _FROM_FLAX[kind]) if kind in _FROM_FLAX else a)
    return out


def objectness_flax_from_state_dict(sd: Mapping[str, Any]) -> dict:
    """Port ObjectnessNet state_dict -> JAX ObjectnessNet params (the inverse
    of :func:`objectness_state_dict_from_flax`)."""
    return flax_tree(sd, flax_layout(sd, "objectness"))


def classifier_flax_from_state_dict(sd: Mapping[str, Any]) -> dict:
    """Port BinaryClassifier state_dict -> JAX variables ``{"params",
    "batch_stats"}`` (the inverse of :func:`classifier_state_dict_from_flax`)."""
    return flax_tree(sd, flax_layout(sd, "classifier"))


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.ckpt`` (``{'model_state_dict': ...}``) or a plain
    state_dict saved by this package -> state_dict on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("model_state_dict", ckpt)


def load_objectness_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]):
    """Load into an ObjectnessNet, tolerating only the reference keys the
    port never runs (refinenet4's resConfUnit1, the ViT's final norm/head);
    any other missing or unexpected key raises."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in list(missing) + list(unexpected) if not any(r.match(k) for r in _UNUSED_OBJECTNESS)]
    if bad:
        raise KeyError(f"objectness state_dict does not match the model: {bad[:8]}")
