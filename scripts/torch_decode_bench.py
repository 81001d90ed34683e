#!/usr/bin/env python3
"""Time one checkout's fused center decode on one CUDA card.

    python3 scripts/torch_decode_bench.py [--root DIR] [--band-rows 8,16,32]

Imports ``unmore_tpu_torch`` from DIR (default: this checkout) and times
its ``fused_center_decode`` on the inputs of ``chip_smoke.py``'s phase 2
(random fields at [256,128,128] and [32,128,128], the dense input at
[256,128,128]), with that script's measures: ``ms`` from events around
back-to-back wrapper calls, ``device_ms`` from the kernels' own time in
``torch.profiler``. Every version of the wrapper has the same signature, so
two versions are compared in one command on one card: unpack the other
commit with ``git archive`` into a gitignored directory and run the script
once per root, in turns (A, B, B, A). ``--band-rows`` times the kernel at
each listed band height of its scoring pass (where the wrapper has
``BAND_ROWS``). Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose unmore_tpu_torch is timed")
    ap.add_argument("--band-rows", default="", help="comma-separated band heights to time (default: the wrapper's)")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    # this checkout's measures, whatever chip_smoke.py the timed root holds
    spec = importlib.util.spec_from_file_location("chip_smoke_measures", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from unmore_tpu_torch.ops import decode
    from unmore_tpu_torch.ops.decode import fused_center_decode

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the card")
    if not Path(fused_center_decode.__code__.co_filename).resolve().is_relative_to(root):
        sys.exit(f"unmore_tpu_torch was not imported from {root}")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    inputs = {
        "random_256": smoke.decode_inputs(256, 128, 256, device),
        "random_32": smoke.decode_inputs(32, 128, 32, device),
        "dense_256": smoke.dense_decode_inputs(256, 128, 7, device),
    }
    results = {}
    for band_rows in [int(r) for r in args.band_rows.split(",") if r] or [getattr(decode, "BAND_ROWS", None)]:
        if band_rows is not None:
            decode.BAND_ROWS = band_rows
        rows = {}
        for name, (sdf, center) in inputs.items():
            call = lambda: fused_center_decode(sdf, center)  # noqa: E731
            dev_ms, by_kernel = smoke.device_ms(call)
            rows[name] = {"ms": smoke.time_ms(call), "device_ms": dev_ms, "device_ms_by_kernel": by_kernel}
        results[f"band_rows={band_rows}"] = rows
    print(json.dumps({"root": str(root), "card": smi, "results": results}), flush=True)


if __name__ == "__main__":
    main()
