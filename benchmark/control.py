"""The control of each cell's check: the plain reference put in the system's
place, in the precision below the configuration's (fp8 products for the
bf16 system), must come out not correct. And the readings of the system
itself over many seeds, from which the limits are set.

    python3 -m benchmark.control --workload discover.dpt_large --control-seeds 1,2,3 --program-seeds 4,5,6
    python3 -m benchmark.control --workload discover.dpt_large --fault half_batch --fault-seeds 7,8,9

Each seed is one short run of the cell (its window closes once the checked
group has run, then the check), in this one process. One
JSON line a run: the seed, which side ran, and every number compared. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from benchmark import faults, run
from benchmark.reference import models

BLOCK = 64  # crops a forward of the float32 reference holds at once


class Fp8Discovery:
    """The reference's models with fp8 products, in the engine's calling
    convention."""

    def __init__(self, config, sd, device):
        self.obj = models.set_precision(models.build_objectness(config, device), "fp8").eval()
        self.obj.load_state_dict(sd["objectness"], strict=True)
        self.cls = models.set_precision(models.build_classifier(config, device), "fp8").eval()
        self.cls.load_state_dict(sd["classifier"], strict=True)

    def objectness_fn(self, crops, compute_center=True):
        outs = [self.obj(crops[s : s + BLOCK], compute_center) for s in range(0, len(crops), BLOCK)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def classifier_fn(self, crops):
        return torch.cat([self.cls(crops[s : s + BLOCK]) for s in range(0, len(crops), BLOCK)])


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--fault-seeds", default="", help="seeds of runs with --fault planted in the system")
    p.add_argument("--fault", default="", help="a name in benchmark.faults.DISCOVERY")
    args = p.parse_args()
    for side, seeds in (("control", args.control_seeds), ("program", args.program_seeds),
                        (args.fault, args.fault_seeds)):
        for seed in filter(None, seeds.split(",")):
            system = None
            patch = faults.Patches()
            if side == "control":
                system = Fp8Discovery
            elif side != "program":
                faults.DISCOVERY[side](patch)
            t = time.time()
            torch.cuda.reset_peak_memory_stats()
            result = run.measure(["--workload", args.workload, "--seed", seed, "--seconds", "1"],
                                 system=system, t_start=t, until_checked=True)
            patch.undo()
            print(json.dumps({"workload": args.workload, "side": side, "seed": int(seed),
                              "correct": result["correct"], "seconds": time.time() - t,
                              "numbers": {k: c["value"] for k, c in result["checks"].items()}}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
