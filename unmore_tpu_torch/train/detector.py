"""CAD detector training on one card (port of the JAX package's
``train/detector.py``).

The reference solver (``cad/solver/build.py`` and the CAD YAML): SGD with
momentum 0.9, base LR 0.01, weight decay 5e-5 on every parameter (BatchNorm
scales, biases and heads included), a linear warmup from factor 1e-3 over
``warmup_iters``, x``gamma`` at each of ``steps``, and the gradient clipped
to global norm 1.0: optax's ``chain(clip_by_global_norm,
add_decayed_weights, sgd(schedule, momentum))`` of
:func:`make_detector_optimizer` there, :class:`DetectorSGD` here, on the flat
parameter buffer of :class:`~unmore_tpu_torch.train.optim.FlatParams`.
With ``dtype="bfloat16"`` the forward runs under ``torch.autocast`` over the
f32 parameters; the losses are f32.

A step whose total loss is not finite keeps the parameters and the
BatchNorm statistics, but the optimizer still updates its state from zero
gradients (the trace decays and gains ``weight_decay * params``, the count
advances), and the step count and the random stream advance: the JAX
package's step. It is decided on the card, with no host sync.

The checkpoint tree is the JAX package's ``DetectorTrainState``: ``{step,
params, batch_stats, opt_state, rng}`` with the optimizer state in optax's
chain layout ``{"0": {}, "1": {}, "2": {"0": {"trace"}, "1": {"count"}}}``
and ``rng`` a uint32[2] ``jax.random`` key. Each step splits ``rng`` into
the next key and the step's key, and the samplers draw under the step's key,
as the JAX package's step does, with :mod:`unmore_tpu_torch.utils.prng`:
both packages draw the same numbers, and a run resumed from either
package's checkpoint continues that run's stream.

Over several ranks each rank takes its rows of the global batch. The flat
gradient is averaged by one all-reduce, the BatchNorms take the global
batch's statistics, the non-finite decision reads the global batch's loss,
and every rank computes its own rows of the split of the step's key into
the global batch's image keys: a step of N ranks samples what a step of one
rank on the whole batch samples.
"""

from __future__ import annotations

import numpy as np
import torch

from unmore_tpu_torch.detector.cascade_rcnn import DetectorConfig, detector_forward_train, uniform_draws
from unmore_tpu_torch.detector.convert import flax_from_state_dict, state_dict_from_flax
from unmore_tpu_torch.parallel import distributed
from unmore_tpu_torch.train.objectness import mean_over_ranks
from unmore_tpu_torch.train.optim import FlatParams
from unmore_tpu_torch.utils import prng


class DetectorSGD:
    """optax's ``chain(clip_by_global_norm(clip_norm),
    add_decayed_weights(weight_decay), sgd(schedule, momentum))`` on a
    :class:`FlatParams`, the schedule read from the optimizer's own count."""

    def __init__(self, flat: FlatParams, base_lr: float = 0.01, momentum: float = 0.9, weight_decay: float = 5e-5,
                 warmup_iters: int = 1000, warmup_factor: float = 1e-3, steps: tuple = (), gamma: float = 0.02,
                 clip_norm: float = 1.0):
        self.flat = flat
        self.base_lr, self.momentum, self.weight_decay = base_lr, momentum, weight_decay
        self.warmup_iters, self.warmup_factor = warmup_iters, warmup_factor
        self.steps, self.gamma, self.clip_norm = tuple(steps), gamma, clip_norm
        self.trace = torch.zeros_like(flat.data)
        self.count = torch.zeros((), dtype=torch.int32, device=flat.data.device)

    def learning_rate(self) -> torch.Tensor:
        """The rate of the next update at the count, in the parameters'
        dtype on their device."""
        dev, dtype = self.flat.data.device, self.flat.data.dtype
        c = self.count.to(dtype)
        ramp = (1 - self.warmup_factor) * c / torch.tensor(float(max(self.warmup_iters, 1)), dtype=dtype, device=dev)
        warm = torch.where(c < self.warmup_iters, self.warmup_factor + ramp, torch.ones((), dtype=dtype, device=dev))
        lr = torch.tensor(self.base_lr, dtype=dtype, device=dev)
        for s in self.steps:
            lr = torch.where(c >= s, lr * self.gamma, lr)
        return lr * warm

    @torch.no_grad()
    def step(self, ok: torch.Tensor):
        """One update from ``flat.grad``. Where ``ok`` (a bool device scalar)
        is false the gradients count as zero and the parameters keep their
        values; the trace and the count are updated either way."""
        p = self.flat.data
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        g = torch.where(ok, self.flat.grad, zero)
        norm = torch.linalg.vector_norm(g)
        max_norm = torch.tensor(self.clip_norm, dtype=p.dtype, device=p.device)
        g = torch.where(norm < max_norm, g, g / norm * max_norm)
        g = g.add_(p, alpha=self.weight_decay)
        self.trace = g.add_(self.trace, alpha=self.momentum)
        new_p = p + self.trace * -self.learning_rate()
        torch.where(ok, new_p, p, out=p)
        self.count = self.count + 1

    def state_tree(self, trace_tree: dict, count) -> dict:
        """optax's state tree, from the trace as a JAX parameter tree."""
        return {"0": {}, "1": {}, "2": {"0": {"trace": trace_tree}, "1": {"count": np.asarray(count, np.int32)
                                                                            .reshape(())}}}


class DetectorTrainer:
    """The detector, its flat parameters and BatchNorm statistics (in the
    model's dtype: f32 master weights, or f64 for reference checks), the
    optimizer, the step count and the random key, all on the model's
    device; one guarded step at a time (:meth:`train_step`). ``dtype``
    "bfloat16" runs the forward under autocast. ``rng``: the uint32[2] key,
    kept on the host."""

    def __init__(self, model: torch.nn.Module, cfg: DetectorConfig, optim: dict | None = None,
                 dtype: str = "bfloat16", rng=(0, 0)):
        self.model = model.train()
        self.cfg = cfg
        first = next(model.parameters())
        self.device = first.device
        self.flat = FlatParams(model, [n for n, _ in model.named_parameters()], dtype=first.dtype)
        # the BatchNorm statistics as views of one flat buffer, so that a
        # skipped step restores them with one torch.where
        buffers = dict(model.named_buffers())
        self.stats_names = [n for n in buffers if n.endswith((".running_mean", ".running_var"))]
        self.stats = torch.cat([buffers[n].reshape(-1) for n in self.stats_names])
        for n, view in zip(self.stats_names, self._stat_views(self.stats)):
            buffers[n].data = view
        self.opt = DetectorSGD(self.flat, **(optim or {}))
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)  # steps skipped since creation
        self.rng = np.asarray(rng, np.uint32).reshape(2)
        self.bf16 = dtype == "bfloat16"

    def _stat_views(self, flat) -> list[torch.Tensor]:
        buffers = dict(self.model.named_buffers())
        sizes = [buffers[n].numel() for n in self.stats_names]
        return [v.view(buffers[n].shape) for v, n in zip(torch.split(flat, sizes), self.stats_names)]

    def autocast(self):
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16, enabled=self.bf16)

    def next_draws(self, batch_size: int) -> dict:
        """The samplers' draws of the next step for this rank's
        ``batch_size`` images: ``rng, step = jax.random.split(rng)`` (the
        same on every rank), then this rank's rows of the global batch's
        draws under ``step``."""
        keys = prng.split(self.rng)
        self.rng = keys[0].numpy().astype(np.uint32)
        r = distributed.process_index()
        return uniform_draws(self.cfg, keys[1], batch_size * distributed.process_count(), self.device,
                             r * batch_size, (r + 1) * batch_size)

    def loss(self, batch: dict, uniform: dict | None = None) -> dict:
        """The losses of a batch of tensors on the card, with the graph, and
        their sum as ``total``; ``uniform`` defaults to :meth:`next_draws`."""
        self.model.train()
        if uniform is None:
            uniform = self.next_draws(batch["images"].shape[0])
        with self.autocast():
            losses = detector_forward_train(self.model, self.cfg, batch, uniform)
        losses["total"] = sum(losses.values())
        return losses

    def train_step(self, batch: dict, uniform: dict | None = None) -> dict:
        """One guarded update from this rank's rows of the global batch;
        returns the global batch's losses as device scalars."""
        self.flat.grad.zero_()
        stats = self.stats.clone()
        losses = self.loss(batch, uniform)
        losses["total"].backward()
        distributed.all_reduce_mean_(self.flat.grad)
        losses = mean_over_ranks(losses)
        # the global batch's total is the sum of its terms, as :meth:`loss` sums them
        losses["total"] = sum(v for k, v in losses.items() if k != "total")
        ok = torch.isfinite(losses["total"])
        self.opt.step(ok)
        torch.where(ok, self.stats, stats, out=self.stats)
        self.step += 1
        self.skipped += (~ok).int()
        return losses

    # -------------------------------------------------------- checkpoints
    def checkpoint_tensors(self) -> dict[str, torch.Tensor]:
        """Every tensor of the checkpoint, by name (the key on the host)."""
        return {"step": self.step, "params": self.flat.data, "stats": self.stats, "trace": self.opt.trace,
                "count": self.opt.count, "rng": torch.from_numpy(self.rng.astype(np.int64))}

    def _variables(self, params, stats) -> dict:
        """Flat params and stats (host arrays) -> JAX ``{params, batch_stats}``."""
        sd = dict(zip(self.flat.names, self.flat.views(torch.from_numpy(np.asarray(params)))))
        sd.update(zip(self.stats_names, self._stat_views(torch.from_numpy(np.asarray(stats)))))
        return flax_from_state_dict(sd)

    def checkpoint_tree(self, host: dict) -> dict:
        """The JAX ``DetectorTrainState`` tree from host copies of
        :meth:`checkpoint_tensors`."""
        variables = self._variables(host["params"], host["stats"])
        trace = self._variables(host["trace"], host["stats"])["params"]
        return {"step": np.asarray(host["step"], np.int32).reshape(()), "params": variables["params"],
                "batch_stats": variables["batch_stats"], "opt_state": self.opt.state_tree(trace, host["count"]),
                "rng": np.asarray(host["rng"]).astype(np.uint32).reshape(2)}

    def state_tree(self) -> dict:
        """:meth:`checkpoint_tree` of the current state."""
        return self.checkpoint_tree({k: v.detach().to("cpu", copy=True).numpy()
                                     for k, v in self.checkpoint_tensors().items()})

    @torch.no_grad()
    def load_tree(self, tree: dict):
        """Resume from a checkpoint tree written by either package."""
        sd = state_dict_from_flax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
        self.flat.data.copy_(self.flat.flatten(sd))
        self.stats.copy_(torch.cat([sd[n].reshape(-1) for n in self.stats_names]).to(self.stats))
        opt = tree["opt_state"]["2"]
        self.opt.trace = self.flat.flatten(state_dict_from_flax({"params": opt["0"]["trace"]}))
        self.opt.count = torch.tensor(int(np.asarray(opt["1"]["count"])), dtype=torch.int32, device=self.device)
        self.step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=self.device)
        self.rng = np.asarray(tree["rng"]).astype(np.uint32).reshape(2)
