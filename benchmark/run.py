"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``unmore_tpu_torch``. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics of
``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, read from a
profiled stretch of the window by ``benchmark/metrics/<metric>.py``.
After the window the run checks what the timed path produced against the
plain reference (:mod:`benchmark.check`), prints each number compared
beside its limit as the last lines of standard error, and prints the
result as one JSON object, the last line of standard output. It exits
non-zero, printing no result, without the CUDA cards the cell asks for,
without the system's package, or if JAX, flax or the JAX package were
loaded.
"""

from __future__ import annotations

import time

T_START = time.time()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# every build and kernel cache of a run lives at a fixed place inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


class Refused(Exception):
    """The run cannot be made here; nothing is printed on standard output."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(argv, spec_path=CHECKOUT / "BENCHMARK.json", root=HERE, device=None, system=None,
            t_start=T_START, until_checked=False) -> dict:
    """One run; returns the result object. ``device`` and ``system`` are for
    the harness's own tests (the CPU at toy sizes, planted faults);
    ``until_checked`` closes the window once the checked group has run, for
    the control's short runs."""
    args = parse(argv)
    from benchmark import guard, spec

    cell = spec.load_cell(args.workload, spec_path, root)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(CHECKOUT / rel)
    try:
        import unmore_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise Refused(f"the system under test is not in this checkout: {exc}") from exc
    import torch

    from benchmark.runtime import Ctx

    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32, in the reference above all
    torch.backends.cudnn.allow_tf32 = False
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), device, t_start, system, until_checked)
    out = spec.driver(cell.traffic["kind"]).run(ctx)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(root, m["name"])(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if args.trace and out["trace"]:
        dev.update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = out["trace"]["breakdown"]
    from benchmark.check import verdict

    result["correct"], result["checks"] = verdict(out["numbers"], cell.limits)
    # last, once the readers and the check have run: whatever they loaded counts too
    loaded = guard.forbidden_loaded()
    if loaded:
        raise Refused(f"loaded in this process: {', '.join(loaded)}")
    return result


def main(argv=None):
    try:
        result = measure(sys.argv[1:] if argv is None else argv)
    except Refused as exc:
        print(f"benchmark: refused: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
