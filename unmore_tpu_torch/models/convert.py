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
  running_mean/running_var``; LayerNorm ``scale`` -> ``weight``
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


def objectness_state_dict_from_flax(params: Mapping[str, Any], sdf_activation: str | None = "tanh",
                                    use_bg_sdf: bool = True) -> dict[str, torch.Tensor]:
    """JAX ObjectnessNet params (dpt_large / dpt_base) -> port state_dict."""
    sd: dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    vit = bb["vit"]
    m = "backbone.pretrained.model."
    sd[m + "cls_token"] = _t(vit["cls_token"])
    sd[m + "pos_embed"] = _t(vit["pos_embed"])
    sd[m + "patch_embed.proj.weight"] = _conv(vit["patch_embed"]["kernel"])
    sd[m + "patch_embed.proj.bias"] = _t(vit["patch_embed"]["bias"])
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
