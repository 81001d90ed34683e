"""The detector's weights across packages and from detectron2.

The port's module names follow the JAX package's parameter tree, so the
two map key for key (:func:`state_dict_from_flax` and its inverse
:func:`flax_from_state_dict`):

* ``params/.../kernel`` -> ``....weight``: conv HWIO -> OIHW, transposed
  conv (flax ``transpose_kernel=True``, [H, W, O, I]) -> IOHW, both a
  (3, 2, 0, 1) transpose; dense [in, out] -> [out, in];
* ``scale`` / ``bias`` -> ``weight`` / ``bias``; ``batch_stats`` ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``;
* a bottleneck's ``downsample_conv`` / ``downsample_bn`` ->
  ``downsample.0`` / ``downsample.1`` (the port's ``models/resnet.py``).

:func:`d2_to_state_dict` takes a detectron2 Cascade Mask R-CNN state dict
(the published CAD model, or the DINO ResNet-50 init, which holds only the
trunk) by detectron2's names, as the JAX package's ``convert_d2.py`` does,
permuting ``fc1`` from detectron2's CHW flatten to the box head's HWC.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_TO_PORT = (("downsample_conv", "downsample.0"), ("downsample_bn", "downsample.1"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(path) -> str:
    name = ".".join(path)
    for flax_name, port_name in _TO_PORT:
        name = name.replace(flax_name, port_name)
    return name


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX detector variables ``{"params", "batch_stats"}`` (numpy or JAX
    leaves) -> the port's state dict, float32."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        mod, name = _module_name(path[:-1]), path[-1]
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            sd[mod + ".weight"] = _t(np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T)
        elif name in ("scale", "bias"):
            sd[mod + (".weight" if name == "scale" else ".bias")] = _t(a)
        else:
            raise KeyError(f"unexpected detector parameter {'/'.join(path)}")
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        mod = _module_name(path[:-1])
        sd[mod + (".running_mean" if path[-1] == "mean" else ".running_var")] = _t(leaf)
        sd[mod + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> JAX variables ``{"params", "batch_stats"}``
    of numpy float32 leaves (the inverse of :func:`state_dict_from_flax`)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        a = value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor) else np.asarray(value, np.float32)
        path = mod
        for flax_name, port_name in _TO_PORT:
            path = path.replace(port_name, flax_name)
        path = path.split(".")
        is_bn = f"{mod}.running_mean" in sd
        if leaf in ("running_mean", "running_var"):
            col, name = "batch_stats", ("mean" if leaf == "running_mean" else "var")
        elif leaf == "weight":
            col, name = "params", ("scale" if is_bn else "kernel")
            if not is_bn:
                a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        else:
            col, name = "params", "bias"
        node = out[col]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return out


def _d2_rules():
    """(detectron2 key pattern, port key template) pairs."""
    bn = r"(weight|bias|running_mean|running_var)"
    return (
        (r"backbone\.bottom_up\.stem\.conv1\.weight", lambda m: "backbone.trunk.conv1.weight"),
        (rf"backbone\.bottom_up\.stem\.conv1\.norm\.{bn}", lambda m: f"backbone.trunk.bn1.{m[1]}"),
        (r"backbone\.bottom_up\.res(\d)\.(\d+)\.conv(\d)\.weight",
         lambda m: f"backbone.trunk.layer{int(m[1]) - 1}_{m[2]}.conv{m[3]}.weight"),
        (rf"backbone\.bottom_up\.res(\d)\.(\d+)\.conv(\d)\.norm\.{bn}",
         lambda m: f"backbone.trunk.layer{int(m[1]) - 1}_{m[2]}.bn{m[3]}.{m[4]}"),
        (r"backbone\.bottom_up\.res(\d)\.(\d+)\.shortcut\.weight",
         lambda m: f"backbone.trunk.layer{int(m[1]) - 1}_{m[2]}.downsample.0.weight"),
        (rf"backbone\.bottom_up\.res(\d)\.(\d+)\.shortcut\.norm\.{bn}",
         lambda m: f"backbone.trunk.layer{int(m[1]) - 1}_{m[2]}.downsample.1.{m[3]}"),
        (r"backbone\.fpn_(lateral|output)(\d)\.(weight|bias)", lambda m: f"backbone.fpn.{m[1]}{m[2]}.{m[3]}"),
        (r"proposal_generator\.rpn_head\.(conv|objectness_logits|anchor_deltas)\.(weight|bias)",
         lambda m: f"rpn.{m[1]}.{m[2]}"),
        (r"roi_heads\.box_head\.(\d)\.(fc[12])\.(weight|bias)", lambda m: f"box_head{m[1]}.{m[2]}.{m[3]}"),
        (r"roi_heads\.box_predictor\.(\d)\.(cls_score|bbox_pred)\.(weight|bias)",
         lambda m: f"box_head{m[1]}.{m[2]}.{m[3]}"),
        (r"roi_heads\.mask_head\.(mask_fcn[1-4]|deconv|predictor)\.(weight|bias)",
         lambda m: f"mask_head.{m[1]}.{m[2]}"),
    )


def d2_to_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A detectron2 detector state dict (by its names; partial ones, such as
    the DINO trunk, give partial results) -> the port's state dict. Keys the
    detector has no module for are left out."""
    rules = [(re.compile(p), f) for p, f in _d2_rules()]
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        for pattern, port_key in rules:
            m = pattern.fullmatch(key)
            if m is None:
                continue
            a = value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor) else np.asarray(value, np.float32)
            name = port_key(m)
            if name.endswith(".fc1.weight"):  # detectron2 flattens NCHW; the box head flattens NHWC
                a = a.reshape(a.shape[0], -1, 7, 7).transpose(0, 2, 3, 1).reshape(a.shape[0], -1)
            out[name] = _t(a)
            if name.endswith(".running_mean"):
                out[name[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            break
    return out
