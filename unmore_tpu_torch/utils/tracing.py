"""The port's tracer: named spans and counters, kept in the process's memory.

One recorder serves the whole process, as ``torch.profiler`` does.

* ``span(name)`` records, while recording is on, the host start and end
  (``time.perf_counter_ns``), the span open when it began (its parent) and
  the group it belongs to. Inside a :func:`group` on a CUDA device it also
  records a ``torch.cuda.Event`` pair on the group's stream, so its
  ``device_s`` is the stream time between its two ends, idle included; in
  a group on the CPU ``device_s`` is the host time, and outside a group a
  span has no ``device_s``. Every recording span also enters
  ``torch.profiler.record_function(name)``, so that under a running profiler
  it lies in the same trace as the kernels, on the profiler's clock. With
  recording off it returns one shared null context.
* ``count(name, n)`` adds to a counter, always. ``read(site, fn, *args)``
  makes a device-to-host read through ``fn``: it counts ``host_syncs`` and,
  while recording, spans the read as ``sync.<site>``.
* ``group(name, device)`` is a root span (the discovery engine's
  ``engine.discover_batch``). Recording is on inside it when :func:`enable`
  was called or a torch profiler is collecting as it starts. At its end the
  group's spans fold into totals per name (``count``, ``host_s``,
  ``device_s``, ``self_device_s`` = ``device_s`` less the children's) and
  the group's counter deltas, which it hands to its caller.
* :func:`summary` and :func:`dump` give the totals since :func:`enable`,
  with the counters, as the discovery CLI's ``stage_timings.json``.

The recorder is not thread-safe: spans and groups are opened and closed by
the thread that runs the device work.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

HOST_SYNCS = "host_syncs"
# ObjectnessNet's CUDA graphs (``models/objectness.py``): forwards captured,
# and calls that replayed a graph captured by an earlier call
GRAPH_CAPTURES = "models.graph.captures"
GRAPH_REPLAYS = "models.graph.replays"
_NULL = contextlib.nullcontext()


class _Tracer:
    def __init__(self):
        self.enabled = False  # enable() was called
        self.recording = False  # spans record now
        self.counters = defaultdict(int)
        self.since = {}  # counters at enable()
        self.stream = None  # the open group's CUDA stream, where spans record events
        self.group_id = None  # the open group's number
        self.n_groups = 0
        self.open = []  # open spans, innermost last
        self.closed = []  # closed spans not yet folded
        self.totals = {}  # per-name totals since enable()


_T = _Tracer()


class _Span:
    __slots__ = ("name", "parent", "group", "t0", "t1", "ev0", "ev1", "fn", "child_s")

    def __init__(self, name):
        self.name = name
        self.ev0 = self.ev1 = None
        self.child_s = 0.0

    def __enter__(self):
        self.parent = _T.open[-1] if _T.open else None
        self.group = _T.group_id
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if _T.stream is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(_T.stream)
        _T.open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(_T.stream)
        _T.open.pop()
        self.fn.__exit__(*exc)
        _T.closed.append(self)
        if self.group is None:  # outside a group nothing waits on the device: fold at once
            _fold(_T.totals)
        return False


def span(name: str):
    """A context that records a span named ``name`` while recording is on."""
    return _Span(name) if _T.recording else _NULL


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    _T.counters[name] += n


def counter(name: str) -> int:
    """The counter ``name``'s value in this process."""
    return _T.counters.get(name, 0)


def read(site: str, fn, *args):
    """``fn(*args)``, a read that waits for the device: counted in
    ``host_syncs`` and, while recording, spanned as ``sync.<site>``."""
    _T.counters[HOST_SYNCS] += 1
    if not _T.recording:
        return fn(*args)
    with _Span("sync." + site):
        return fn(*args)


def enable():
    """Record spans from now on, everywhere; start the totals anew."""
    _T.enabled = _T.recording = True
    _T.totals = {}
    _T.since = dict(_T.counters)


def disable():
    """Record spans only inside a group under a running profiler."""
    _T.enabled = _T.recording = False


def profiling() -> bool:
    """Whether a torch profiler collects now."""
    return torch.autograd.profiler._is_profiler_enabled


def _fold(into: dict) -> dict:
    """Fold the closed spans into ``into`` (name -> totals) and forget them.
    Children close before their parents, so each parent has its children's
    time before its own self time is taken."""
    for s in _T.closed:
        host_s = (s.t1 - s.t0) / 1e9
        device_s = None if s.ev0 is None else s.ev0.elapsed_time(s.ev1) / 1e3
        if s.group is not None and s.ev0 is None:
            device_s = host_s  # a group on the CPU: the host is the device
        t = into.setdefault(s.name, {"count": 0, "host_s": 0.0})
        t["count"] += 1
        t["host_s"] += host_s
        if device_s is not None:
            t["device_s"] = t.get("device_s", 0.0) + device_s
            t["self_device_s"] = t.get("self_device_s", 0.0) + device_s - s.child_s
            if s.parent is not None:
                s.parent.child_s += device_s
    _T.closed = []
    return into


def _add(into: dict, spans: dict):
    for name, t in spans.items():
        mine = into.setdefault(name, {})
        for k, v in t.items():
            mine[k] = mine.get(k, 0) + v


@contextlib.contextmanager
def group(name: str, device):
    """A root span over one group of work on ``device``. Yields a dict that,
    when the group recorded, holds ``group`` (its number), ``spans`` (totals
    per name) and ``counters`` (the group's counter deltas) once the group
    has ended; otherwise it stays empty."""
    out = {}
    if not (_T.enabled or profiling()):
        yield out
        return
    device = torch.device(device)
    _T.n_groups += 1
    _T.group_id, _T.recording = _T.n_groups, True
    _T.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    before = dict(_T.counters)
    root = _Span(name)
    try:
        with root:
            yield out
        if root.ev1 is not None:
            root.ev1.synchronize()
        spans = _fold({})
        deltas = {k: v - before.get(k, 0) for k, v in _T.counters.items() if v != before.get(k, 0)}
        out.update(group=_T.group_id, spans=spans, counters={HOST_SYNCS: 0, **deltas})
        if _T.enabled:
            _add(_T.totals, spans)
    finally:
        _T.closed = [s for s in _T.closed if s.group is None]
        _T.group_id, _T.stream, _T.recording = None, None, _T.enabled


def summary() -> dict:
    """Totals per name since :func:`enable`: ``total_s``, ``count`` and
    ``mean_s`` on the host clock, ``device_s`` where measured; and under
    ``counters`` each counter's change since then."""
    out = {}
    for name, t in _T.totals.items():
        row = {"total_s": round(t["host_s"], 4), "count": t["count"],
               "mean_s": round(t["host_s"] / max(t["count"], 1), 4)}
        if "device_s" in t:
            row["device_s"] = round(t["device_s"], 4)
        out[name] = row
    out["counters"] = {k: v - _T.since.get(k, 0) for k, v in _T.counters.items() if v != _T.since.get(k, 0)}
    return out


def dump(path: str):
    """Write :func:`summary` to ``path`` as JSON."""
    with open(path, "w") as f:
        json.dump(summary(), f, indent=2)
