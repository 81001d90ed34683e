"""Typed configuration of stage-1 training (port of the JAX package's ``config.py``).

The same dataclasses with the same defaults, and the same JSON round trip
(:func:`save_config`, :func:`load_config`): a file either package writes
loads in the other. The defaults are the reference recipe (``script.sh``:
batch 20, gamma 0.1, both extra SDF losses on); the CLI's own defaults
differ (batch 16, gamma 1, extra losses off) and stay as they are, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json


def save_config(cfg, path: str):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_config(cls, path: str):
    """A config dataclass from its JSON; keys the class lacks are ignored."""
    with open(path) as f:
        data = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone_type: str = "dpt_large"  # dpt_large | dpt_base | dpt_hybrid
    sdf_activation: str | None = "tanh"
    use_bg_sdf: bool = True
    image_size: int = 128
    dtype: str = "float32"  # "bfloat16": autocast over f32 parameters
    # kept for configs.json compatibility with the JAX package, where it pins
    # the matmul precision; here f32 means f32 wherever TF32 is off
    precision: str | None = "highest"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"  # adam | sgd | lars
    learning_rate: float = 1e-4
    lr_scheduler_type: str = "multi_step_lr"  # multi_step_lr | constant
    lr_scheduler_milestones: tuple[int, ...] = (10000, 20000)
    lr_scheduler_gamma: float = 0.1
    sgd_momentum: float = 0.9
    sgd_weight_decay: float = 5e-5


@dataclasses.dataclass(frozen=True)
class TrainObjectnessConfig:
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    seed: int = 0
    batch_size: int = 20
    train_iter: int = 500_000
    save_ckpt_every: int = 5000
    log_every: int = 50
    # losses (reference train_objectness_net.py:215-254 + script.sh)
    sdf_loss_type: str = "l1"
    center_field_loss_type: str = "l2"
    use_sdf_gradient_loss: bool = True
    use_sdf_binary_mask_loss: bool = True
    # data
    random_crop_scale_min: float = 0.08
    random_crop_scale_max: float = 1.0
    # spike guard: skip the update (params and the whole optimizer state)
    # when the batch loss is non-finite, or, from step spike_guard_warmup
    # on, at or above this ceiling; 0 disables the guard. The warmup exists
    # because Adam's early transient can exceed any fixed ceiling.
    skip_loss_above: float = 1000.0
    spike_guard_warmup: int = 500

    def __post_init__(self):
        if isinstance(self.model, dict):
            object.__setattr__(self, "model", ModelConfig(**self.model))
        if isinstance(self.optim, dict):
            object.__setattr__(self, "optim", OptimConfig(**self.optim))
