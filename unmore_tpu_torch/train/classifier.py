"""Stage-1 existence-classifier training on one card (port of the JAX
package's ``train/classifier.py``).

The reference ``BinaryClassifierTrainer`` (``train_objectness_net.py:540-743``):
BCE on the sigmoid output with clipping, Adam with the multi-step schedule,
BatchNorm in train mode (batch statistics; running statistics updated as
flax does, see :mod:`unmore_tpu_torch.models.resnet`), evaluation of the
accuracy at 0.5 with the running statistics. Over several ranks the flat
gradient is averaged and the BatchNorms take the global batch's statistics,
as one step of the JAX package over its mesh.
"""

from __future__ import annotations

import torch

from unmore_tpu_torch.config import OptimConfig
from unmore_tpu_torch.models.convert import flax_layout, flax_tree, tensors_from_flax
from unmore_tpu_torch.parallel import distributed
from unmore_tpu_torch.train.objectness import Trainer, decode_wire_batch, mean_over_ranks


def bce_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    pred = torch.clamp(pred, eps, 1 - eps)
    return -torch.mean(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))


class ClassifierTrainer(Trainer):
    """Training steps (:meth:`train_step`) and evaluation (:meth:`eval_step`)
    of a BinaryClassifier; the checkpoint tree adds ``batch_stats``."""

    kind = "classifier"

    def __init__(self, model: torch.nn.Module, optim_cfg: OptimConfig, dtype: str = "float32"):
        super().__init__(model.train(), optim_cfg, dtype)
        buffers = dict(model.named_buffers())
        # running statistics by name, and their paths in the batch_stats tree
        self.stats_layout = {k: (path[1:], rule) for k, (path, rule) in flax_layout(buffers, self.kind).items()}
        self.stats = {k: buffers[k] for k in self.stats_layout}

    def loss(self, batch: dict) -> dict:
        """``{"loss"}`` of a batch in train mode, with the graph (BatchNorm
        updates its running statistics)."""
        self.model.train()
        with self.autocast():
            pred = self.model(decode_wire_batch(batch)["image"])
        return {"loss": bce_loss(pred[:, 0], batch["label"].float())}

    def train_step(self, batch: dict) -> dict:
        """One update from a batch of tensors on the card (this rank's
        rows); the global batch's ``{"loss"}`` as a device scalar."""
        self.flat.grad.zero_()
        losses = self.loss(batch)
        losses["loss"].backward()
        distributed.all_reduce_mean_(self.flat.grad)
        self.opt.step()
        self.step += 1
        return mean_over_ranks(losses)

    @torch.no_grad()
    def eval_step(self, batch: dict):
        """(hits, total, scores) with the running statistics, on the card."""
        self.model.eval()
        with self.autocast():
            pred = self.model(decode_wire_batch(batch)["image"])[:, 0]
        label = batch["label"].float()
        hits = ((pred > 0.5).float() == label).float()
        return hits.sum(), torch.tensor(float(label.shape[0]), device=hits.device), pred

    # -------------------------------------------------------- checkpoints
    def checkpoint_tensors(self) -> dict[str, torch.Tensor]:
        return {**super().checkpoint_tensors(), **{f"stats.{k}": v for k, v in self.stats.items()}}

    def checkpoint_tree(self, host: dict) -> dict:
        """``{"step", "params", "batch_stats", "opt_state"}``."""
        tree = super().checkpoint_tree(host)
        stats = {k[6:]: v for k, v in host.items() if k.startswith("stats.")}
        return {"step": tree["step"], "params": tree["params"], "batch_stats": flax_tree(stats, self.stats_layout),
                "opt_state": tree["opt_state"]}

    @torch.no_grad()
    def load_tree(self, tree: dict):
        super().load_tree(tree)
        for k, v in tensors_from_flax(tree["batch_stats"], self.stats_layout).items():
            self.stats[k].copy_(v)
