"""CPU tests of the benchmark's harness: lookup by name, the frozen counts,
the result line, seeds, the import guard, and the check's control and
planted faults at toy sizes (float32 on both sides).

    python3 -m pytest benchmark/tests -q -p no:cacheprovider

Tests marked ``cuda`` need a card; they decide inside the test whether one
is there.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import guard, run, spec, weights, world, yardstick
from benchmark.reference import models
from benchmark.tests import toy

REPO = Path(__file__).resolve().parents[2]
SPEC = REPO / "BENCHMARK.json"
SEED = 2**31 + 77  # the driver's seeds pass 32 signed bits


def measure(root_spec, cell, trace=0, seconds=1, system=None, seed=SEED):
    return run.measure(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                       spec_path=root_spec, root=root_spec.parent / "bench", device="cpu", system=system,
                       t_start=time.time())


@pytest.fixture(scope="module")
def toy_spec(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("toy"))


# ---------------------------------------------------------------- lookup
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(SPEC.read_text())["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = spec.load_cell(cell, SPEC)
    assert c.config["name"] == c.entry["config"]
    assert spec.driver(c.traffic["kind"]).run
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(spec.HERE, m["name"]))


def test_a_traffic_and_a_metric_added_as_files_are_picked_up(toy_spec):
    bench = toy_spec.parent / "bench"
    traffic = dict(toy.TRAFFIC["toy_pairs"], group_sizes=[[64, 96], [96, 64]])
    (bench / "traffic" / "toy_tall.json").write_text(json.dumps(traffic))
    (bench / "limits" / "discover.toy_tall.json").write_text(json.dumps(toy.LIMITS))
    (bench / "metrics" / "engine.images_in_window.py").write_text(
        "def read(run):\n    return float(run['images']) if run['kind'] == 'discovery' else None\n")
    s = json.loads(toy_spec.read_text())
    s["workloads"].append({"name": "discover.toy_tall", "config": "toy", "traffic": "toy_tall", "chips": 1, "why": "t"})
    s["per_layer"].append({"name": "engine.images_in_window", "unit": "images", "better": "higher",
                           "source": "program_counter", "layer": "discovery engine", "moves": "infer_images_per_s",
                           "workloads": ["discover.toy_tall"]})
    path = toy_spec.parent / "BENCHMARK_extra.json"
    path.write_text(json.dumps(s))
    r = measure(path, "discover.toy_tall", trace=1)
    assert r["correct"] is True
    assert r["metrics"]["engine.images_in_window"]["value"] == r["attempted"] >= 2


# --------------------------------------------------------- frozen counts
def test_executed_crops_and_decode_bytes_by_hand():
    assert yardstick.executed_crops(300, 256, 32) == 256 + 2 * 32
    assert yardstick.executed_crops(256, 256, 32) == 256
    assert yardstick.executed_crops(0, 256, 32) == 0
    assert yardstick.decode_bytes(256, 128) == 67_111_936
    least_ms = yardstick.decode_bytes(256, 128) / yardstick.H100_HBM_BYTES_PER_S * 1e3
    assert math.isclose(least_ms, 0.020033, rel_tol=1e-4)


def test_vit_l_block_and_dpt_large_crop_flops_by_hand():
    n, d = 65, 1024  # 64 patches of a 128^2 crop and the class token
    block = 2 * n * d * 3 * d + 2 * (2 * n * n * d) + 2 * n * d * d + 2 * (2 * n * d * 4096)
    assert yardstick.vit_block(n, d, 4096) == block
    config = json.loads((spec.HERE / "configs" / "dpt_large.json").read_text())
    both, sdf_only, cls = yardstick.crop_flops(config)
    head_sdf = 2 * 128 * 128 * (256 * 512 + 9 * 512 * 512 + 512 * 1024 + 1024 * 1)
    head_center = head_sdf + 2 * 128 * 128 * 1024 * 1
    assert both - sdf_only == head_center
    assert (both, sdf_only, cls) == (248_739_102_720, 149_887_746_048, 2_673_248_208)


@pytest.mark.parametrize("name", ["toy", "toy_hybrid"])
def test_crop_flops_equal_a_flop_counter_over_the_reference(name):
    from torch.utils.flop_counter import FlopCounterMode

    config = {"toy": toy.TOY, "toy_hybrid": toy.TOY_HYBRID}[name]
    obj, cls = models.build_objectness(config).eval(), models.build_classifier(config).eval()
    x = torch.zeros(1, config["crop_size"], config["crop_size"], 3)
    counted = []
    for fn in (lambda: obj(x), lambda: obj(x, False), lambda: cls(x)):
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn()
        counted.append(counter.get_total_flops())
    assert tuple(counted) == yardstick.crop_flops(config)


# ----------------------------------------------------------- seeds, weights
def test_the_seed_changes_the_scenes_and_not_the_weights():
    sizes = [(96, 96), (80, 90)]
    a, b = world.scenes(SEED, 0, sizes), world.scenes(SEED + 1, 0, sizes)
    assert all(np.array_equal(x, y) for x, y in zip(a, world.scenes(SEED, 0, sizes)))
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
    w1, w2 = weights.for_config(toy.TOY, "cpu"), weights.for_config(toy.TOY, "cpu")
    for part in ("objectness", "classifier"):
        assert all(torch.equal(w1[part][k], w2[part][k]) for k in w1[part])


def test_weights_load_strict_into_the_system_and_the_reference():
    from benchmark.drivers.discovery import PortSystem

    sd = weights.for_config(toy.TOY_HYBRID, "cpu")
    system = PortSystem(toy.TOY_HYBRID, sd, torch.device("cpu"))
    ref = models.build_objectness(toy.TOY_HYBRID)
    ref.load_state_dict(sd["objectness"], strict=True)
    assert set(system.obj.state_dict()) == set(ref.state_dict())
    w = sd["objectness"]["backbone.pretrained.model.blocks.0.mlp.fc1.weight"]
    assert math.isclose(float(w.std()), 1 / math.sqrt(w.shape[1]), rel_tol=0.1)


# -------------------------------------------------------------- the line
def test_result_line_keys_and_checks_last(toy_spec):
    r = measure(toy_spec, "discover.toy")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "infer_images_per_s", "peak_memory_gib"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert set(r["checks"]) == set(toy.LIMITS)


def test_the_window_holds_whole_passes_over_the_pool(toy_spec):
    pool = toy.TRAFFIC["toy_pairs"]["pool_groups"]
    images = 2 * pool  # two scenes a group
    assert measure(toy_spec, "discover.toy", seconds=0)["attempted"] == images
    assert measure(toy_spec, "discover.toy_hybrid", seconds=0)["attempted"] == images


def test_traced_run_reports_per_layer_metrics(toy_spec):
    r = measure(toy_spec, "discover.toy", trace=1)
    assert r["correct"] is True
    assert {"engine.boundary_crops_per_image", "engine.padded_crop_share", "mfu.infer"} <= set(r["metrics"])
    assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
    assert list(r)[-1] == "checks"


def test_without_a_card_the_run_is_refused_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is for machines without one")
    rc = run.main(["--workload", "discover.dpt_large", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


# ----------------------------------------------------------------- guard
def test_import_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded({"jax": 0, "jax.numpy": 0, "flax.linen": 0, "unmore_tpu.ops": 0}) == [
        "flax.linen", "jax", "jax.numpy", "unmore_tpu.ops"]
    assert guard.forbidden_loaded({"unmore_tpu_torch": 0, "unmore_tpu_torch.ops": 0, "jaxtyping": 0}) == []


def test_no_benchmark_file_imports_jax_and_the_reference_imports_no_system():
    assert guard.source_problems() == []


def test_a_run_loads_neither_jax_nor_the_jax_package(toy_spec):
    measure(toy_spec, "discover.toy")
    assert guard.forbidden_loaded() == []


def test_a_reader_that_loads_a_forbidden_module_refuses_the_run(toy_spec):
    # a per-layer reader is loaded after the window: what it imports counts too
    bench = toy_spec.parent / "bench"
    (bench / "metrics" / "engine.loads_the_jax_package.py").write_text(
        "import sys, types\n\n\ndef read(run):\n"
        "    sys.modules.setdefault('unmore_tpu', types.ModuleType('unmore_tpu'))\n    return 1.0\n")
    s = json.loads(toy_spec.read_text())
    s["per_layer"].append({"name": "engine.loads_the_jax_package", "unit": "images", "better": "higher",
                           "source": "program_counter", "layer": "discovery engine", "moves": "infer_images_per_s",
                           "workloads": ["discover.toy"]})
    path = toy_spec.parent / "BENCHMARK_forbidden.json"
    path.write_text(json.dumps(s))
    assert "unmore_tpu" not in sys.modules
    try:
        with pytest.raises(run.Refused, match="unmore_tpu"):
            measure(path, "discover.toy", trace=1)
    finally:
        sys.modules.pop("unmore_tpu", None)


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.measure(["--workload", "discover.dpt_large", "--seed", str(SEED), "--seconds", "2", "--trace", "0"])
    assert r["correct"] is True
