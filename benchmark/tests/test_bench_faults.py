"""The check must come out not correct when the timed path is broken
underneath, and when the plain reference with fp8 products is put in the
system's place (the control). The harness's look for a card is skipped;
the rest of a run is driven at toy sizes on the CPU, float32 on both sides.

The faults are those a discovery cell can have: a round that returns its
boxes unchanged, half of each chunk left out, and an answer altered where
it is produced. (No cell runs over several chips, so there is no exchange
between chips to leave out.)
"""

from __future__ import annotations

import time

import pytest

from benchmark import control, faults, run
from benchmark.tests import toy


@pytest.fixture(scope="module")
def toy_spec(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("toy"))


def correct(toy_spec, cell, system=None, seed=2**31 + 5):
    r = run.measure(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"],
                    spec_path=toy_spec, root=toy_spec.parent / "bench", device="cpu", system=system,
                    t_start=time.time())
    return r["correct"], {k: v["value"] for k, v in r["checks"].items()}


@pytest.mark.parametrize("cell", ["discover.toy", "discover.toy_hybrid"])
def test_sound_runs_are_correct(toy_spec, cell):
    ok, numbers = correct(toy_spec, cell)
    assert ok, numbers


@pytest.mark.parametrize("fault", list(faults.DISCOVERY))
def test_a_planted_fault_comes_out_not_correct(toy_spec, monkeypatch, fault):
    faults.DISCOVERY[fault](monkeypatch)
    ok, numbers = correct(toy_spec, "discover.toy")
    assert not ok, numbers


@pytest.mark.parametrize("cell", ["discover.toy", "discover.toy_hybrid"])
def test_the_fp8_control_comes_out_not_correct(toy_spec, cell):
    ok, numbers = correct(toy_spec, cell, control.Fp8Discovery)
    assert not ok, numbers
