"""Fail-fast on persistent corruption of a training run (port of the JAX
package's ``train/resilience.py``).

The contract: when consecutive log windows look corrupt (every batch
skipped by the spike guard, or a non-finite window loss), the trainer exits
with :data:`FATAL_EXIT_CODE` WITHOUT saving, and a supervisor
(``--max_restarts``) resumes it from the last periodic checkpoint in a fresh
process. The step-level spike guard handles isolated bad batches.

``UNMORE_FAULT_INJECT_AT="<iter>:<marker_path>"`` drives that path in tests:
every log window at or past ``<iter>`` counts as corrupt until
``<marker_path>`` exists; the trainer writes the marker right before its
fatal exit, so the restarted process trains cleanly.
"""

from __future__ import annotations

import dataclasses
import math
import os

FATAL_EXIT_CODE = 3  # supervisors key on this


@dataclasses.dataclass
class CorruptionDetector:
    """Counts consecutive corrupt log windows; fatal at ``threshold``. One
    bad window resets on the next healthy one."""

    threshold: int = 2
    consecutive: int = 0

    def update(self, window_is_corrupt: bool) -> bool:
        """Record one log window; True when the run is fatal."""
        self.consecutive = self.consecutive + 1 if window_is_corrupt else 0
        return self.consecutive >= self.threshold

    @property
    def last_window_corrupt(self) -> bool:
        """True when the newest window looked corrupt: a checkpoint written
        now would snapshot suspect state, so callers skip it."""
        return self.consecutive > 0

    @staticmethod
    def loss_window_corrupt(total_loss: float, ceiling: float = 1e3, in_warmup: bool = False) -> bool:
        """A non-finite window loss always counts; a finite one above
        ``ceiling`` counts only after warmup (losses under LR warmup may sit
        above any fixed ceiling)."""
        if not math.isfinite(total_loss):
            return True
        return not in_warmup and total_loss > ceiling


def _injection_spec() -> tuple[int, str] | None:
    spec = os.environ.get("UNMORE_FAULT_INJECT_AT")
    if not spec:
        return None
    at, _, marker = spec.partition(":")
    if not marker:
        raise ValueError(f"UNMORE_FAULT_INJECT_AT must be '<iter>:<marker_path>', got {spec!r}")
    return int(at), marker


def fault_injection_active(step: int) -> bool:
    """True when a test-injected fault should corrupt this window."""
    spec = _injection_spec()
    if spec is None:
        return False
    at, marker = spec
    return step >= at and not os.path.exists(marker)


def mark_fault_injected() -> None:
    """Record that the injected fault fired (restarted runs skip it)."""
    spec = _injection_spec()
    if spec is not None:
        with open(spec[1], "w") as f:
            f.write("injected\n")
