"""Measure a configuration's ``center_score_max_thres`` for its seeded
weights on the card, once, by the discovery smoke's rule:

    python3 -m benchmark.calibrate --config dpt_large

Random weights give singularity scores far above a trained model's, so at
the published 0.009 every proposal would split and none would reach the
boundary rounds. The rule takes the median score over one chunk of a
calibration scene's seed crops (scene 0 of group 0 of the discovery
traffic at seed 0), so that about half the proposals split and half go on.
The value is written into the configuration file by hand, with the card's
name beside it in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from benchmark import weights, world
from benchmark.drivers.discovery import PortSystem
from benchmark.reference import ops

HERE = Path(__file__).resolve().parent


def threshold(config, traffic, device):
    system = PortSystem(config, weights.for_config(config, device), device)
    image = world.scenes(0, 0, [tuple(s) for s in traffic["group_sizes"]], traffic["shapes_per_scene"])[0]
    seeds = ops.seed_proposals(*image.shape[:2]).astype(np.float32)[: config["crop_chunk"]]
    canvas = torch.from_numpy(image).to(device).float()[None] / 255.0
    idx = torch.zeros(len(seeds), dtype=torch.long, device=device)
    crops = ops.crop_and_resize(canvas, torch.from_numpy(seeds).to(device), config["crop_size"],
                                config["gather_chunk"], idx)
    with torch.inference_mode():
        out = system.objectness_fn(crops, True)
    sing = ops.decode(out["sdf_maps"].float().contiguous(), out["center_fields"].float().contiguous())[0]
    return float(sing.median())


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="scene_pairs")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{args.traffic}.json").read_text())
    print(json.dumps({"config": args.config, "center_score_max_thres": threshold(config, traffic, torch.device("cuda")),
                      "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
