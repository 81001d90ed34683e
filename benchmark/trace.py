"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a short
stretch of the window, reduced in memory to what the per-layer readers and
the result's ``breakdown`` need.

The stretch opens and closes at a ``synchronize()``, inside a
``bench.traced`` annotation whose length is the traced window. Device time
is the union of the kernel, memcpy and memset intervals inside it. The
chrome trace goes to a temporary file under ``TMPDIR`` and is deleted once
read; keep the stretch short (a discovery group) so
that the file stays at some tens of MB.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
WINDOW = "bench.traced"


@contextlib.contextmanager
def traced(sync, out: dict):
    """Profile the body; ``out`` receives the summary (``summarize``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(summarize(events))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events) -> dict:
    """window_s, busy_s, kernels (count), kernel_s by name, the ten largest
    device ops and idle gaps (by the host op under way), from chrome-trace
    events."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1), e)
           for e in xs if e.get("cat") in DEVICE_CATS]
    dev = [(s, t, e) for s, t, e in dev if t > s]
    merged = _union([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged)
    by_name = defaultdict(float)
    kernel_s = defaultdict(float)
    n_kernels = 0
    for s, t, e in dev:
        by_name[e["name"][:160]] += (t - s) / 1e6
        if e.get("cat") == "kernel":
            n_kernels += 1
            kernel_s[e["name"]] += (t - s) / 1e6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for se in merged for x in se] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        t = (g0 + g1) / 2
        name = "host: python or idle"
        for j in range(bisect.bisect_right(starts, t) - 1, max(bisect.bisect_right(starts, t) - 400, -1), -1):
            if host[j][1] >= t:
                name = host[j][2]
                break
        gaps[name[:160]] += (g1 - g0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "kernels": n_kernels, "kernel_s": dict(kernel_s),
            "breakdown": {"device_ops": [list(kv) for kv in top], "idle_gaps": [list(kv) for kv in top_gaps]}}
