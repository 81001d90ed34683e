"""Optimizer state of the stage-1 trainers: flat parameters, optax's three
optimizers, in torch; fresh weights come from
:func:`unmore_tpu_torch.models.flax_init.init_like_flax`.

:class:`FlatParams` keeps the trainable parameters of a model as views of
one flat float32 buffer and their gradients as views of another, so that an
optimizer step is a few elementwise passes over whole buffers and the spike
guard's "keep the old state" is one ``torch.where`` per buffer, decided on
the card from a device scalar: no host sync.

:class:`Optimizer` is ``optax.adam``, ``optax.chain(add_decayed_weights,
sgd)`` and ``optax.lars`` (trust coefficient 1e-3, momentum 0.9, no weight
decay: optax's defaults) of the JAX package's ``make_optimizer``, with its
``multi_step_lr`` schedule (``piecewise_constant_schedule``) read from the
optimizer's own update count, which a skipped step does not advance.
:meth:`Optimizer.state_tree` and :meth:`Optimizer.load_state_tree` speak
optax's state layout as flax's ``to_state_dict`` writes it, so that the
checkpoints of both packages are interchangeable:

* adam: ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``
* sgd: ``{"0": {}, "1": {"0": {"trace"}, "1": {"count"}}}``
* lars: ``{"0": {"inner_state": {}}, "1": {"inner_state": {}}, "2": {"count"}, "3": {"trace"}}``

(with a constant rate the schedule's ``{"count"}`` is ``{}``); counts are
int32 scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from unmore_tpu_torch.config import OptimConfig
from unmore_tpu_torch.models.flax_init import init_like_flax  # noqa: F401  (the trainers' fresh weights)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LARS_TRUST, LARS_MOMENTUM = 1e-3, 0.9


class FlatParams:
    """The parameters ``names`` of ``model`` as views of ``self.data``, their
    gradients as views of ``self.grad``. Every other parameter of the model
    is frozen (``requires_grad=False``): it enters no optimizer state."""

    def __init__(self, model: torch.nn.Module, names, dtype: torch.dtype = torch.float32):
        params = dict(model.named_parameters())
        self.names = list(names)
        self.shapes = [params[n].shape for n in self.names]
        self.sizes = [params[n].numel() for n in self.names]
        dev = params[self.names[0]].device
        self.data = torch.empty(sum(self.sizes), dtype=dtype, device=dev)
        self.grad = torch.zeros_like(self.data)
        for p in params.values():
            p.requires_grad_(False)
        for n, view, gview in zip(self.names, self.views(self.data), self.views(self.grad)):
            p = params[n]
            view.copy_(p.detach())
            p.data = view
            p.requires_grad_(True)
            p.grad = gview  # backward accumulates into the flat buffer in place

    def views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """``flat`` (shaped like :attr:`data`) cut into the parameters' shapes."""
        return [v.view(s) for v, s in zip(torch.split(flat, self.sizes), self.shapes)]

    def flatten(self, tensors: dict) -> torch.Tensor:
        """Tensors by name -> one flat tensor of :attr:`data`'s dtype and device."""
        return torch.cat([torch.as_tensor(tensors[n]).reshape(-1) for n in self.names]).to(self.data)


def _count(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


class Optimizer:
    """optax's adam / sgd / lars of :class:`OptimConfig` on a :class:`FlatParams`."""

    def __init__(self, cfg: OptimConfig, flat: FlatParams):
        if cfg.optimizer not in ("adam", "sgd", "lars"):
            raise NotImplementedError(cfg.optimizer)
        if cfg.lr_scheduler_type not in ("multi_step_lr", "constant"):
            raise NotImplementedError(cfg.lr_scheduler_type)
        self.cfg, self.flat = cfg, flat
        dev = flat.data.device
        self.scheduled = cfg.lr_scheduler_type == "multi_step_lr"
        self.milestones = sorted({int(m): cfg.lr_scheduler_gamma for m in cfg.lr_scheduler_milestones}.items())
        self.sched_count = _count(dev)  # the schedule's own count (optax ScaleByScheduleState)
        if cfg.optimizer == "adam":
            self.count = _count(dev)
            self.mu, self.nu = torch.zeros_like(flat.data), torch.zeros_like(flat.data)
        else:
            self.trace = torch.zeros_like(flat.data)

    def learning_rate(self) -> torch.Tensor:
        """The rate of the next update, f32 on the card: optax's
        ``piecewise_constant_schedule`` at the schedule's count."""
        v = torch.tensor(self.cfg.learning_rate, dtype=torch.float32, device=self.flat.data.device)
        if not self.scheduled:
            return v
        for threshold, scale in self.milestones:
            indicator = torch.clamp(torch.sign((threshold - self.sched_count).float()), min=0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v

    @torch.no_grad()
    def step(self, ok: torch.Tensor | None = None):
        """One update from the gradients in ``flat.grad``. With ``ok`` (a
        bool device scalar) the parameters and the whole state, counts
        included, keep their old values where ``ok`` is false."""
        p, g = self.flat.data, self.flat.grad
        neg_lr = -self.learning_rate()
        new = {}
        if self.cfg.optimizer == "adam":
            count = self.count + 1
            mu = g.mul(1 - ADAM_B1).add_(self.mu, alpha=ADAM_B1)
            nu = (g * g).mul_(1 - ADAM_B2).add_(self.nu, alpha=ADAM_B2)
            bc1 = 1 - torch.pow(ADAM_B1, count.float())
            bc2 = 1 - torch.pow(ADAM_B2, count.float())
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(ADAM_EPS)).mul_(neg_lr)
            new.update(count=count, mu=mu, nu=nu)
        elif self.cfg.optimizer == "sgd":
            decayed = g.add(p, alpha=self.cfg.sgd_weight_decay)
            trace = decayed.add_(self.trace, alpha=self.cfg.sgd_momentum)
            update = trace * neg_lr
            new.update(trace=trace)
        else:  # lars: trust ratio per parameter, then the rate, then momentum
            p_norm = torch.stack(torch._foreach_norm(self.flat.views(p)))
            g_norm = torch.stack(torch._foreach_norm(self.flat.views(g)))
            ratio = LARS_TRUST * p_norm / g_norm
            ratio = torch.where((p_norm == 0) | (g_norm == 0), torch.ones_like(ratio), ratio)
            sizes = torch.tensor(self.flat.sizes, device=p.device)
            scaled = g * torch.repeat_interleave(ratio, sizes) * neg_lr
            trace = scaled.add_(self.trace, alpha=LARS_MOMENTUM)
            update = trace
            new.update(trace=trace)
        new_p = p + update
        new["sched_count"] = self.sched_count + 1
        if ok is not None:
            torch.where(ok, new_p, p, out=p)
            for k, v in new.items():
                new[k] = torch.where(ok, v, getattr(self, k))
        else:
            p.copy_(new_p)
        for k, v in new.items():
            setattr(self, k, v)

    # ------------------------------------------------------ optax layout
    def state_tensors(self) -> dict[str, torch.Tensor]:
        """The state's tensors by name (for a device snapshot)."""
        names = ("count", "mu", "nu") if self.cfg.optimizer == "adam" else ("trace",)
        return {"sched_count": self.sched_count, **{n: getattr(self, n) for n in names}}

    def state_tree(self, host: dict, to_tree) -> dict:
        """optax's state tree from host copies of :meth:`state_tensors`;
        ``to_tree`` maps a flat array to the JAX parameter tree."""

        def count(name):
            return np.asarray(host[name], np.int32).reshape(())

        sched = {"count": count("sched_count")} if self.scheduled else {}
        if self.cfg.optimizer == "adam":
            return {"0": {"count": count("count"), "mu": to_tree(host["mu"]), "nu": to_tree(host["nu"])}, "1": sched}
        if self.cfg.optimizer == "sgd":
            return {"0": {}, "1": {"0": {"trace": to_tree(host["trace"])}, "1": sched}}
        return {"0": {"inner_state": {}}, "1": {"inner_state": {}}, "2": sched, "3": {"trace": to_tree(host["trace"])}}

    def load_state_tree(self, tree: dict, from_tree):
        """The inverse of :meth:`state_tree`; ``from_tree`` maps a JAX
        parameter tree to a flat tensor."""
        dev = self.flat.data.device

        def count(node):
            return torch.tensor(int(np.asarray(node["count"])), dtype=torch.int32, device=dev)

        if self.cfg.optimizer == "adam":
            sched, self.count = tree["1"], count(tree["0"])
            self.mu, self.nu = from_tree(tree["0"]["mu"]), from_tree(tree["0"]["nu"])
        elif self.cfg.optimizer == "sgd":
            sched, self.trace = tree["1"]["1"], from_tree(tree["1"]["0"]["trace"])
        else:
            sched, self.trace = tree["2"], from_tree(tree["3"]["trace"])
        if self.scheduled:
            self.sched_count = count(sched)
