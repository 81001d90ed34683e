"""PyTorch/CUDA port of the unMORE object-discovery system for one NVIDIA H100.

Imports ``torch`` only; the JAX package beside it is the reference that the
tests hold this package against. Entry points take ``device=None``, which
means ``"cuda"``; without a card they raise (see :func:`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a card raises: the port
    never moves to the CPU on its own; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "unmore_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
