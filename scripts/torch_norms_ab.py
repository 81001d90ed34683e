#!/usr/bin/env python3
"""Discovery on the smoke chain's trained weights with the norms three ways.

    python3 scripts/torch_norms_ab.py [--work build/norms_ab]

Runs ``scale_chain``'s world, stage1 and existence steps at the knobs of
``chip_smoke.py``'s phase ``chain`` (``CHAIN_ARGS``: 8 scenes at 320^2, 200
steps of each trainer), then the discovery CLI over the 8 scenes on those
checkpoints, once for each way of holding the norms (the ViT's LayerNorms
and the ResNet-50's BatchNorms):

* ``bf16``: bf16 models whose norms keep float32 leaves and normalise in
  float32, as flax's norms at ``dtype=bfloat16`` do (the port);
* ``bf16_rounded_norms``: the same models with the norms' leaves rounded to
  bf16 (the port before it kept them in float32);
* ``float32``: float32 models (TF32 off).

Prints one JSON line: for each way, the images with boxes, the boxes and
the wall, beside the card's name and power limit. Runs on the card (no
``--device`` flag: the CLIs' default).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from unmore_tpu_torch.cli import common, object_reasoning  # noqa: E402
from unmore_tpu_torch.models.hybrid import StdConv2dSame  # noqa: E402
from unmore_tpu_torch.models.norms import KeepsFloat32  # noqa: E402

WAYS = ("bf16", "bf16_rounded_norms", "float32")


def rounded_norms(build):
    """``build`` whose model has its norms' floating leaves rounded to bf16."""
    def wrapped(*args, **kwargs):
        model = build(*args, **kwargs)
        for m in model.modules():
            if isinstance(m, KeepsFloat32) and not isinstance(m, StdConv2dSame):
                for t in (*m.parameters(recurse=False), *m.buffers(recurse=False)):
                    if t.is_floating_point():
                        t.data = t.data.to(torch.bfloat16)
        return model
    return wrapped


def discover(work: Path, chain, way: str) -> dict:
    argv = chain.discovery_argv(0, chain.a.disc_scenes) + ["--run_name", way]
    argv += ["--dtype", "float32" if way == "float32" else "bfloat16"]
    patched = {}
    if way == "bf16_rounded_norms":  # the CLI takes its builders from cli/common.py when it runs
        patched = {n: getattr(common, n) for n in ("build_objectness", "build_classifier")}
        for n, fn in patched.items():
            setattr(common, n, rounded_norms(fn))
    t0 = time.perf_counter()
    try:
        with contextlib.chdir(work):
            object_reasoning.main(argv)
    finally:
        for n, fn in patched.items():
            setattr(common, n, fn)
    wall = time.perf_counter() - t0
    folder = work / "results_reasoning" / f"{way}_0_{chain.a.disc_scenes}"
    found = json.loads((folder / "discovery_results.json").read_text())
    return {"images_with_boxes": len(found), "boxes": sum(len(v) for v in found.values()),
            "boxes_per_image": {k: len(v) for k, v in sorted(found.items())}, "wall_s": wall}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", default=str(ROOT / "build" / "norms_ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_norms_ab.py runs on a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-m", "unmore_tpu_torch.scripts.scale_chain", "--work", str(work),
                         *chip_smoke.CHAIN_ARGS, "--steps", "world", "stage1", "existence"], cwd=ROOT).returncode
    if rc:
        sys.exit(f"the chain's first steps exited {rc}")
    train_s = time.perf_counter() - t0
    chain = chip_smoke.chain_knobs(work)
    out = {way: discover(work, chain, way) for way in WAYS}
    print(json.dumps({"nvidia_smi": smi, "chain_train_s": train_s, "scenes": chain.a.disc_scenes, **out}),
          flush=True)


if __name__ == "__main__":
    main()
