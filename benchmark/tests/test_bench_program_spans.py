"""The per-layer metrics that read the program's own spans and counters
(``stats["trace"]`` of the traced groups) at toy size on the CPU, where a
span's device time is its host time.

    python3 -m pytest benchmark/tests/test_bench_program_spans.py -q -p no:cacheprovider
"""

from __future__ import annotations

import time

import pytest

from benchmark import run, spec
from benchmark.tests import toy

SPANS = ("engine.host_syncs_per_group", "engine.boundary_time_share", "engine.boundary_round_self_ms",
         "models.objectness_span_share")
SEED = 2**31 + 91


@pytest.fixture(scope="module")
def toy_spec(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("toy"))


def test_a_traced_run_reports_the_program_span_metrics(toy_spec):
    r = run.measure(["--workload", "discover.toy", "--seed", str(SEED), "--seconds", "1", "--trace", "1"],
                    spec_path=toy_spec, root=toy_spec.parent / "bench", device="cpu", t_start=time.time())
    assert r["correct"] is True
    got = {name: r["metrics"][name]["value"] for name in SPANS}
    assert got["engine.host_syncs_per_group"] >= 4 + 14  # the phases' live counts and the readback at least
    assert 0 < got["engine.boundary_time_share"] < 100
    assert 0 < got["models.objectness_span_share"] < 100
    assert got["engine.boundary_round_self_ms"] > 0


@pytest.mark.parametrize("name", SPANS)
def test_a_program_without_spans_gives_no_reading(name):
    """The parent's program keeps no ``trace`` in its stats: the reader
    finds nothing and says so, without raising."""
    read = spec.reader(spec.HERE, name)
    stats = {"boundary_active_trace": [3, 1], "n_seed": 10}
    assert read({"kind": "discovery", "traced_groups": [{"stats": stats}]}) is None
    assert read({"kind": "discovery", "traced_groups": []}) is None
