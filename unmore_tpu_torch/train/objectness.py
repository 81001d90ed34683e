"""Stage-1 ObjectnessNet training on one card (port of the JAX package's
``train/objectness.py``).

The four losses of the reference ``ObjectnessNetTrainer``
(``train_objectness_net.py:215-254``), summed and differentiated in one
step:

  1. center field L2 (or L1),
  2. SDF L1 (or L2),
  3. SDF forward-gradient loss, last row and column dropped,
  4. BCE of sigmoid(SDF) against the saliency mask.

With ``dtype="bfloat16"`` the forward runs under ``torch.autocast`` over
f32 parameters (the master weights); the losses are f32. The spike guard
keeps the parameters and the whole optimizer state, counts included, when
the loss is non-finite or, from step ``spike_guard_warmup`` on, not below
``skip_loss_above``; the step count still advances. It is decided on the
card: the step returns device scalars, and nothing in it waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch

from unmore_tpu_torch.config import TrainObjectnessConfig
from unmore_tpu_torch.models.convert import flax_layout, flax_tree, tensors_from_flax
from unmore_tpu_torch.ops.image import image_gradients
from unmore_tpu_torch.parallel import distributed
from unmore_tpu_torch.train.optim import FlatParams, Optimizer

_255 = 255.0  # wire-format scale; divided by as a 0-d tensor (see decode_wire_batch)


def objectness_losses(out: dict, batch: dict, cfg: TrainObjectnessConfig) -> dict:
    """Per-term losses. out: model outputs (NHWC, f32); batch: f32 targets."""
    pred_center, gt_center = out["center_fields"], batch["center_field"]
    if cfg.center_field_loss_type == "l2":
        center_loss = torch.mean((pred_center - gt_center) ** 2)
    else:
        center_loss = torch.mean(torch.abs(pred_center - gt_center))

    pred_sdf, gt_sdf = out["sdf_maps"], batch["sdf"]
    if cfg.sdf_loss_type == "l2":
        sdf_loss = torch.mean((pred_sdf - gt_sdf) ** 2)
    else:
        sdf_loss = torch.mean(torch.abs(pred_sdf - gt_sdf))

    losses = {"center_field": center_loss, "sdf": sdf_loss}

    if cfg.use_sdf_gradient_loss:
        gt_grad = torch.stack(image_gradients(gt_sdf), 1)[:, :, :-1, :-1]
        pred_grad = torch.stack(image_gradients(pred_sdf), 1)[:, :, :-1, :-1]
        if cfg.sdf_loss_type == "l2":
            losses["sdf_gradient"] = torch.mean((gt_grad - pred_grad) ** 2)
        else:
            losses["sdf_gradient"] = torch.mean(torch.abs(gt_grad - pred_grad))

    if cfg.use_sdf_binary_mask_loss:
        p = torch.sigmoid(pred_sdf)
        y = batch["saliency_mask"]
        eps = 1e-7
        losses["sdf_binary_mask"] = -torch.mean(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))

    losses["total"] = sum(losses.values())
    return losses


def mean_over_ranks(losses: dict) -> dict:
    """The losses, detached, each the mean over the ranks (one all-reduce):
    the global batch's losses, on which every rank decides alike."""
    out = {k: v.detach() for k, v in losses.items()}
    if distributed.world() is not None:
        flat = distributed.all_reduce_mean_(torch.stack(list(out.values())))
        out = dict(zip(out, flat.unbind()))
    return out


def to_device(batch: dict, device) -> dict:
    """Host numpy batch -> tensors on ``device``; from pinned memory and
    without waiting when ``device`` is a card."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
    return out


def decode_wire_batch(batch: dict) -> dict:
    """Wire-format tensors (uint8 images and mask, float16 fields) -> the
    f32 the model and the losses take; f32 tensors pass through. The uint8
    image is divided by a 0-d tensor: CUDA divides by a Python scalar as a
    multiply by its reciprocal, one ulp off the CPU."""
    out = dict(batch)
    img = batch["image"]
    if img.dtype == torch.uint8:
        out["image"] = img.float() / torch.tensor(_255, device=img.device)
    for k in ("center_field", "sdf", "saliency_mask"):
        if k in batch and batch[k].dtype != torch.float32:
            out[k] = batch[k].float()
    return out


class Trainer:
    """State shared by the stage-1 trainers: the model, its flat trainable
    parameters (those the JAX tree holds), the optimizer and the step
    count, all on the model's device, and the checkpoint tree in the JAX
    trainers' ``TrainState`` layout."""

    kind = ""  # "objectness" or "classifier": which JAX tree the weights map to

    def __init__(self, model: torch.nn.Module, optim_cfg, dtype: str = "float32"):
        self.model = model
        self.device = next(model.parameters()).device
        # by parameter name: its path in the JAX param tree (the classifier's
        # paths start with the variables' "params" collection: dropped here)
        self.layout = {k: (path[1:] if path[0] == "params" else path, rule)
                       for k, (path, rule) in flax_layout(dict(model.named_parameters()), self.kind).items()}
        self.flat = FlatParams(model, list(self.layout))
        self.opt = Optimizer(optim_cfg, self.flat)
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.bf16 = dtype == "bfloat16"

    def autocast(self):
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16, enabled=self.bf16)

    # -------------------------------------------------------- checkpoints
    def params_tree(self, flat) -> dict:
        """A flat array shaped like the parameters -> the JAX param tree."""
        flat = torch.as_tensor(flat)
        return flax_tree(dict(zip(self.flat.names, self.flat.views(flat))), self.layout)

    def params_flat(self, tree: dict) -> torch.Tensor:
        return self.flat.flatten(tensors_from_flax(tree, self.layout))

    def checkpoint_tensors(self) -> dict[str, torch.Tensor]:
        """Every tensor of the checkpoint, by name, on the card."""
        opt = {f"opt.{k}": v for k, v in self.opt.state_tensors().items()}
        return {"step": self.step, "params": self.flat.data, **opt}

    def checkpoint_tree(self, host: dict) -> dict:
        """The JAX ``TrainState`` tree from host copies of
        :meth:`checkpoint_tensors`: ``{"step", "params", "opt_state"}``."""
        opt = {k[4:]: v for k, v in host.items() if k.startswith("opt.")}
        return {
            "step": np.asarray(host["step"], np.int32).reshape(()),
            "params": self.params_tree(host["params"]),
            "opt_state": self.opt.state_tree(opt, self.params_tree),
        }

    @torch.no_grad()
    def load_tree(self, tree: dict):
        """Resume from a checkpoint tree written by either package."""
        self.flat.data.copy_(self.params_flat(tree["params"]))
        self.opt.load_state_tree(tree["opt_state"], self.params_flat)
        self.step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=self.device)


class ObjectnessTrainer(Trainer):
    """One ObjectnessNet training step at a time: :meth:`train_step`."""

    kind = "objectness"

    def __init__(self, model: torch.nn.Module, cfg: TrainObjectnessConfig, dtype: str | None = None):
        super().__init__(model.train(), cfg.optim, dtype or cfg.model.dtype)
        self.cfg = cfg

    def loss(self, batch: dict) -> dict:
        """The losses of a batch (wire format or f32), with the graph."""
        batch = decode_wire_batch(batch)
        with self.autocast():
            out = self.model(batch["image"])
        return objectness_losses(out, batch, self.cfg)

    def train_step(self, batch: dict) -> dict:
        """One guarded update from a batch of tensors on the card (wire
        format or f32; this rank's rows). Returns the global batch's losses
        (and ``skipped`` when the guard is on) as device scalars."""
        cfg = self.cfg
        self.flat.grad.zero_()
        losses = self.loss(batch)
        losses["total"].backward()
        distributed.all_reduce_mean_(self.flat.grad)
        losses = mean_over_ranks(losses)
        ok = None
        if cfg.skip_loss_above > 0:
            total = losses["total"]
            armed = self.step >= cfg.spike_guard_warmup
            ok = torch.isfinite(total) & (~armed | (total < cfg.skip_loss_above))
            losses["skipped"] = (~ok).float()
        self.opt.step(ok)
        self.step += 1
        return losses
