"""Faults planted in the system under test, to show that the check catches
them: each function breaks the timed path through ``setattr`` (a pytest
``monkeypatch.setattr`` or :class:`Patches`) and is undone with it.

A boundary round that returns its boxes unchanged, half of each model chunk
left out, the final boxes altered where the engine produces them.
"""

from __future__ import annotations

import torch


class Patches:
    """``setattr`` that remembers, and ``undo`` that restores."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def frozen_boxes(patch):
    """Every boundary round returns its boxes unchanged."""
    from unmore_tpu_torch.reasoning import engine

    original = engine.ObjectDiscoveryEngine._boundary_chunk_stats

    def stats(self, canvases, bc, ic):
        out = original(self, canvases, bc, ic)
        return {k: (v if k == "max_sdf" else torch.zeros_like(v)) for k, v in out.items()}

    patch.setattr(engine.ObjectDiscoveryEngine, "_boundary_chunk_stats", stats)


def half_batch_discovery(patch):
    """The objectness net runs the first half of each chunk's crops; the rest read zero."""
    from unmore_tpu_torch.models.objectness import ObjectnessNet

    original = ObjectnessNet.forward

    def forward(self, images, compute_center=True):
        half = original(self, images[: max(len(images) // 2, 1)], compute_center)
        return {k: torch.cat([v, v.new_zeros((len(images) - len(v), *v.shape[1:]))]) for k, v in half.items()}

    patch.setattr(ObjectnessNet, "forward", forward)


def altered_boxes(patch):
    """The final boxes move by a pixel where the engine produces them."""
    from unmore_tpu_torch.reasoning import engine

    original = engine.ObjectDiscoveryEngine.discover_batch

    def discover_batch(self, images):
        results = original(self, images)
        for r in results:
            r["boxes"] = r["boxes"] + 1.0
        return results

    patch.setattr(engine.ObjectDiscoveryEngine, "discover_batch", discover_batch)


DISCOVERY = {"frozen_boxes": frozen_boxes, "half_batch": half_batch_discovery, "altered_boxes": altered_boxes}
