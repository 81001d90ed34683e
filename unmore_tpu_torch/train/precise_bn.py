"""PreciseBN: BatchNorm statistics recomputed from fresh data (port of the JAX
package's ``train/precise_bn.py``).

detectron2's PreciseBN hook (enabled in the CAD YAML with NUM_ITER 200)
runs train-mode forwards over fresh batches and replaces the running
statistics with the plain average of the per-batch statistics (batch mean
and biased batch variance; of the global batch over several ranks), every
batch counting equally. The JAX package recovers each batch's statistics by
inverting flax's momentum update; here a hook on each BatchNorm reads them
off its input directly, while the running statistics stay as they are.
"""

from __future__ import annotations

import torch

from unmore_tpu_torch.models.resnet import BatchNorm2d, batch_moments, frozen_running_stats


@torch.no_grad()
def precise_bn_stats(model: torch.nn.Module, forward, batches) -> dict[str, torch.Tensor]:
    """``forward(batch)`` runs ``model`` (put in train mode here) on one
    batch. Returns {buffer name: tensor} of every BatchNorm's averaged
    ``running_mean`` and ``running_var`` over ``batches``; the model's own
    buffers are left unchanged. A BatchNorm that no batch reached keeps its
    current statistics."""
    norms = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    sums: dict[str, list[torch.Tensor]] = {}

    def record(name):
        def hook(module, args):
            mean, var = batch_moments(args[0])
            if name in sums:
                sums[name][0] += mean
                sums[name][1] += var
            else:
                sums[name] = [mean, var]
        return hook

    handles = [m.register_forward_pre_hook(record(name)) for name, m in norms.items()]
    was_training, n = model.training, 0
    try:
        model.train()
        with frozen_running_stats(model):
            for batch in batches:
                forward(batch)
                n += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    out = {}
    for name, m in norms.items():
        if name in sums:
            count = torch.tensor(float(n), device=m.running_mean.device)
            mean, var = sums[name][0] / count, sums[name][1] / count
        else:
            mean, var = m.running_mean.clone(), m.running_var.clone()
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = mean, var
    return out
