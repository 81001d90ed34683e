"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell's
configuration is ``configs/<config>.json`` (the ``file`` of its entry), its
traffic ``traffic/<traffic>.json``, its limits ``limits/<cell>.json`` and
each per-layer metric's reader ``metrics/<metric>.py``, all under the
benchmark's folder. A later cell, traffic mix or metric is a new file and a
new entry; no code names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # number compared -> its limit
    end_to_end: list  # the BENCHMARK.json metrics this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path, root: Path = HERE) -> Cell:
    spec = json.loads(Path(spec_path).read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((Path(spec_path).parent / conf["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{name}.json").read_text())
    return Cell(name, entry, config, traffic, limits,
                [m for m in spec["end_to_end"] if applies(m, name)],
                [m for m in spec["per_layer"] if applies(m, name)])


def reader(root: Path, metric: str):
    """The ``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The module that runs traffic of ``kind`` (``drivers/<kind>.py``)."""
    return importlib.import_module(f"benchmark.drivers.{kind}")
