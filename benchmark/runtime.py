"""What a driver gets from the harness: the cell, the run's arguments and
the device, with the device's clock and memory in one place.

On a card, step marks are CUDA events recorded on the current stream (no
synchronise added) and the peak is ``max_memory_allocated``. The CPU path
exists for the harness's own tests at toy sizes; it reads the host clock
and reports no device memory.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.spec import Cell


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.time() at process start
    system: object = None  # a stand-in for the system under test (the control, the tests' faults)
    until_checked: bool = False  # close the window once the checked group has run (the control's short runs)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self):
        """A point on the device's timeline, recorded without waiting."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        if self.device.type == "cuda":
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def free(self):
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
