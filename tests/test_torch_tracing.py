"""The port's tracer (``unmore_tpu_torch/utils/tracing.py``) on the CPU.

A toy discovery engine (fake models that read painted fields from each
crop, a 96x96 canvas, 32x32 crops) runs one group with recording off, under
``torch.profiler`` and after ``tracing.enable()``. Recording off leaves the
JAX engine's ``stats`` as they are; recording on adds ``stats["trace"]``,
whose spans and counters are held against what the group did. The
counters that replaced the ops' function attributes count as those did.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unmore_tpu_torch.ops import decode
from unmore_tpu_torch.ops.nms import nms_mask
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from unmore_tpu_torch.utils import tracing

PHASES = ("engine.existence", "engine.center", "engine.recheck_existence", "engine.recheck_center",
          "engine.boundary", "engine.nms_readback")
READBACK_SYNCS = 14  # three per-image lists, seven scalars, four lattices


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


def world(canvas, objects):
    """ch0 the object mask (1.0 even objects, 0.6 odd), ch1/ch2 each
    object's outward centre field encoded into [0, 1]."""
    img = np.zeros((canvas, canvas, 3), np.float32)
    img[..., 1:] = 0.5
    yy, xx = np.meshgrid(np.arange(canvas), np.arange(canvas), indexing="ij")
    for k, (x1, y1, x2, y2) in enumerate(objects):
        sel = (yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2)
        dy, dx = yy - (y1 + y2) / 2, xx - (x1 + x2) / 2
        n = np.maximum(np.sqrt(dy**2 + dx**2), 1e-6)
        img[..., 0][sel] = 1.0 if k % 2 == 0 else 0.6
        img[..., 1][sel] = (0.5 + 0.5 * dy / n)[sel]
        img[..., 2][sel] = (0.5 + 0.5 * dx / n)[sel]
    return img


class Models:
    """Fake models that count their calls: the SDF of a crop's dominant
    painted object, box-blurred, and its painted centre field."""

    def __init__(self):
        self.calls = {"objectness": 0, "classifier": 0}

    def objectness(self, crops, compute_center=True):
        self.calls["objectness"] += 1
        m = crops[..., 0]
        a = m > 0.8
        b = (m > 0.3) & ~a
        mask = torch.where(a.sum((1, 2), keepdim=True) >= b.sum((1, 2), keepdim=True), a, b)
        sdf = torch.nn.functional.avg_pool2d((mask.float() * 2 - 1)[:, None], 9, 1, 4, count_include_pad=False)
        out = {"sdf_maps": sdf[:, 0]}
        if compute_center:
            out["center_fields"] = crops[..., 1:3] * 2.0 - 1.0
        return out

    def classifier(self, crops):
        self.calls["classifier"] += 1
        return crops[..., 0].amax(dim=(1, 2))


CFG = ReasoningConfig(canvas_size=96, crop_size=32, image_batch=2, max_proposals=128, max_splits=128,
                      max_active=128, crop_chunk=16, crop_chunk_tail=8, exist_chunk=16, n_round=12,
                      analyze_cc=True, class_score_thres=0.5)
IMAGES = [world(96, [(10, 10, 40, 40), (50, 30, 90, 80)]), world(80, [(5, 20, 60, 70)])[:72]]


def run_group():
    models = Models()
    engine = ObjectDiscoveryEngine(models.objectness, models.classifier, CFG, device="cpu")
    return engine.discover_batch(IMAGES), models.calls


def test_recording_off_records_nothing_and_keeps_the_jax_stats():
    assert tracing.span("engine.existence") is tracing.span("x")  # the one shared null context
    before = tracing.summary()
    with tracing.span("x"):
        pass
    assert tracing.summary() == before
    syncs = tracing.counter(tracing.HOST_SYNCS)
    results, _ = run_group()
    keys = {"n_seed", "n_exist", "n_center_in", "n_split", "split_overflow", "n_recheck_center_in",
            "n_boundary_in", "active_overflow", "boundary_rounds", "boundary_active_trace", "n_converged",
            "n_final", "cc_overflow"}
    assert [set(r["stats"]) for r in results] == [keys, keys]
    assert tracing.counter(tracing.HOST_SYNCS) > syncs  # counters count with recording off too


def test_a_profiled_group_carries_its_spans_and_syncs(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results, calls = run_group()
    trace = results[0]["stats"]["trace"]
    assert all(r["stats"]["trace"] is trace for r in results)  # one value for the group's images
    spans, counters = trace["spans"], trace["counters"]
    stats = results[0]["stats"]
    rounds = stats["boundary_rounds"]
    assert rounds > 0 and stats["n_converged"] + results[1]["stats"]["n_converged"] > 0
    assert spans["engine.discover_batch"]["count"] == 1
    assert all(spans[p]["count"] == 1 for p in PHASES)
    assert spans["engine.boundary.round"]["count"] == len(stats["boundary_active_trace"]) == rounds
    assert spans["models.objectness"]["count"] == calls["objectness"]
    assert spans["models.classifier"]["count"] == calls["classifier"]
    syncs = {name: t["count"] for name, t in spans.items() if name.startswith("sync.")}
    assert counters[tracing.HOST_SYNCS] == sum(syncs.values())
    assert syncs["sync.existence.n_live"] == syncs["sync.center.n_live"] == 2
    assert syncs["sync.boundary.n_active"] == rounds
    assert syncs["sync.boundary.any_live"] == rounds + (rounds < CFG.n_round)
    assert sum(n for name, n in syncs.items() if name.startswith("sync.readback.")) == READBACK_SYNCS
    assert syncs["sync.cc.changed"] > 0 and syncs["sync.nms.undecided"] == counters["ops.nms.rounds"]
    root = spans["engine.discover_batch"]
    for name, t in spans.items():
        assert 0 <= t["host_s"] <= root["host_s"] and t["device_s"] == t["host_s"]  # the CPU's device is the host
    assert sum(spans[p]["device_s"] for p in PHASES) <= root["device_s"]

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(spans) <= annotated


def test_self_time_is_a_span_less_its_children():
    tracing.enable()
    with tracing.group("root", "cpu") as out:
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.read("b.sum", float, torch.ones(3).sum())
            with tracing.span("b"):
                pass
    spans = out["spans"]
    for name, children in (("root", ("a",)), ("a", ("b",)), ("b", ("sync.b.sum",))):
        want = spans[name]["device_s"] - sum(spans[c]["device_s"] for c in children)
        assert spans[name]["self_device_s"] == pytest.approx(want, abs=1e-12)
    assert spans["b"]["count"] == 2 and out["counters"] == {tracing.HOST_SYNCS: 1}


def test_enabled_recording_dumps_stage_timings(tmp_path):
    tracing.enable()
    with tracing.span("load"):
        pass
    with tracing.span("discover"):
        results, _ = run_group()
    assert "trace" in results[0]["stats"]
    path = tmp_path / "stage_timings.json"
    tracing.dump(str(path))
    tracing.disable()
    timings = json.loads(path.read_text())
    for name in ("load", "discover"):  # outside a group: the host clock only
        assert set(timings[name]) == {"total_s", "count", "mean_s"} and timings[name]["count"] == 1
    assert set(timings["engine.discover_batch"]) == {"total_s", "count", "mean_s", "device_s"}
    assert timings["engine.boundary.round"]["count"] == results[0]["stats"]["boundary_rounds"]
    assert timings["counters"][tracing.HOST_SYNCS] == results[0]["stats"]["trace"]["counters"][tracing.HOST_SYNCS]
    results, _ = run_group()  # recording stops with disable()
    assert "trace" not in results[0]["stats"]


@pytest.mark.parametrize("boxes,valid,rounds", [
    ([[0, 0, 10, 10], [0, 0, 10, 10]], [False, False], 1),  # nothing undecided: one round, to see that
    ([[0, 0, 10, 10], [20, 20, 30, 30]], [True, True], 2),  # both kept at once
    ([[0, 0, 10, 10], [1, 0, 11, 10], [2, 0, 12, 10]], [True, True, True], 3),  # the first suppresses the rest
    ([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]], [True, True, True], 4),  # keep, then suppress, then keep
])
def test_nms_rounds_count_each_round(boxes, valid, rounds):
    before = tracing.counter("ops.nms.rounds"), tracing.counter(tracing.HOST_SYNCS)
    nms_mask(torch.tensor(boxes, dtype=torch.float32), torch.tensor([3.0, 2.0, 1.0][: len(boxes)]),
             torch.tensor(valid))
    assert (tracing.counter("ops.nms.rounds") - before[0], tracing.counter(tracing.HOST_SYNCS) - before[1]) == (
        rounds, rounds)


def test_the_plain_decode_counts_no_launch():
    before = tracing.counter("ops.decode.launches")
    decode.fused_center_decode(torch.zeros(2, 16, 16), torch.zeros(2, 16, 16, 2))
    assert tracing.counter("ops.decode.launches") == before


@pytest.mark.cuda
def test_each_kernel_call_counts_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    before = tracing.counter("ops.decode.launches")
    for _ in range(3):
        decode.fused_center_decode(torch.zeros(2, 16, 16, device="cuda"), torch.zeros(2, 16, 16, 2, device="cuda"))
    torch.cuda.synchronize()
    assert tracing.counter("ops.decode.launches") == before + 3
