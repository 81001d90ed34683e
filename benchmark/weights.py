"""Seeded weights, drawn by the benchmark on the device and handed alike to
the system (``load_state_dict``) and to the reference.

Scales follow flax's initializers: every convolution and linear kernel is
normal with standard deviation 1/sqrt(fan_in) (lecun normal, untruncated),
position embeddings normal * 0.02, biases, class tokens and norm shifts
zero, norm scales one, BatchNorm's running mean 0 and variance 1. All the
random kernels come from one ``torch.randn`` call on the device, scaled in
place leaf by leaf, so that drawing ViT-L takes a fraction of a second.
The weights depend on the configuration's ``weights_seed`` and the device
kind alone, never on ``--seed``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def _fan_in(module: nn.Module, shape) -> int:
    if isinstance(module, nn.ConvTranspose2d):  # [in, out, kh, kw]: flax counts kh * kw * in
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def draw(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """A float32 state dict for ``model``'s names and shapes on ``device``."""
    random, fixed = [], {}
    for mname, module in model.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False)):
            name = f"{mname}.{leaf}" if mname else leaf
            if leaf == "weight" and t.ndim >= 2:
                random.append((name, tuple(t.shape), 1.0 / math.sqrt(_fan_in(module, t.shape))))
            elif leaf == "pos_embed":
                random.append((name, tuple(t.shape), 0.02))
            elif leaf in ("weight", "running_var"):
                fixed[name] = torch.ones(t.shape, device=device)
            elif leaf == "num_batches_tracked":
                fixed[name] = torch.zeros((), dtype=torch.long, device=device)
            else:  # biases, class token, norm shifts, running means
                fixed[name] = torch.zeros(t.shape, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in random), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, scale in random:
        n = math.prod(shape)
        out[name] = flat[off : off + n].view(shape).mul_(scale)
        off += n
    out.update(fixed)
    return out


def for_config(config: dict, device) -> dict:
    """The objectness net's and the classifier's weights of a configuration:
    names and shapes from the reference models (built without memory), the
    classifier drawn from ``weights_seed + 1``."""
    from benchmark.reference import models

    with torch.device("meta"):
        obj, cls = models.ObjectnessNet(models.dpt_spec(config)), models.BinaryClassifier(
            tuple(config["classifier_stage_blocks"]))
    return {"objectness": draw(obj, config["weights_seed"], device),
            "classifier": draw(cls, config["weights_seed"] + 1, device)}
