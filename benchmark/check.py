"""The comparisons that decide ``correct``, and how they are printed.

Every number compared is a gap between the system and the plain reference,
and passes while it is at or below its limit (``benchmark/limits/<cell>.json``,
set from the system's readings over many seeds and the control's, as
``PERF.md`` records).

Discovery: the reference follows the system step by step
(:mod:`benchmark.reference.engine`) on the model outputs that the system
produced for the checked group, and its final boxes must equal the
system's (``box_mismatch``: boxes that differ, plus calls the reference
asked for that the system did not make). On a sample of those calls, drawn
from the seed with the largest of each kind in it, the reference's float32
models run on the reference's own crops: ``sdf_gap_pooled`` is the
relative L2 gap of the system's SDF maps over all the sampled crops at once
(steadier than the largest of one block of 64), ``center_gap`` the largest
relative L2 gap of its centre fields in a block of 64 crops, ``exist_gap``
the largest absolute gap of its existence scores.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark.reference import engine as ref_engine
from benchmark.reference import models

REPLAY_BROKEN = 1e9  # box_mismatch when the reference asked for a call the system never made


def rel_l2(got, want):
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want).clamp(min=1e-30))


def sample_calls(calls, counts, rng):
    """Indices of the calls whose model outputs are checked: for each kind,
    the call with the most crops and a seeded draw of the rest."""
    chosen = set()
    for kind, n in counts.items():
        mine = [i for i, (k, _) in enumerate(calls) if k == kind]
        if not mine or n <= 0:
            continue
        largest = max(mine, key=lambda i: len(next(iter(calls[i][1].values()))))
        rest = [i for i in mine if i != largest]
        picks = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
        chosen |= {largest, *(rest[int(p)] for p in picks)}
    return chosen


def discovery_gaps(config, calls, images, boxes, seed, device, weights_sd, counts, block=64):
    """The numbers compared for one checked group: the reference replays
    ``calls`` (the system's model outputs in order) over ``images`` and
    checks a sample of them against its float32 models."""
    obj = models.build_objectness(config, device)
    obj.load_state_dict(weights_sd["objectness"], strict=True)
    cls = models.build_classifier(config, device)
    cls.load_state_dict(weights_sd["classifier"], strict=True)
    obj.eval()
    cls.eval()
    rng = np.random.default_rng([seed % 2**64, 7])
    checked = sample_calls(calls, counts, rng)
    gaps = {"center_gap": 0.0, "exist_gap": 0.0}
    sdf = [0.0, 0.0]  # sums of squared gaps and of squared reference values

    @torch.no_grad()
    def on_call(kind, index, crops, recorded):
        if index not in checked:
            return
        for s in range(0, len(crops), block):
            c = crops[s : s + block]
            if kind == "exist":
                gap = float((recorded["scores"][s : s + block].double() - cls(c).double()).abs().max())
                gaps["exist_gap"] = max(gaps["exist_gap"], gap)
                continue
            out = obj(c, compute_center=kind == "center")
            want = out["sdf_maps"].double()
            sdf[0] += float(((recorded["sdf_maps"][s : s + block].double() - want) ** 2).sum())
            sdf[1] += float((want**2).sum())
            if kind == "center":
                gaps["center_gap"] = max(gaps["center_gap"],
                                         rel_l2(recorded["center_fields"][s : s + block], out["center_fields"]))

    replay = ref_engine.Replay(calls, on_call)
    try:
        with torch.no_grad():
            want = ref_engine.Discovery(config, replay, device).discover(images)
        unused = len(calls) - replay.pos
        mismatch = unused + sum(_box_mismatch(g, w) for g, w in zip(boxes, want))
        if unused:
            print(f"check: the system made {unused} model calls that the reference did not ask for", file=sys.stderr)
    except ref_engine.ReplayMismatch as exc:
        print(f"check: {exc}", file=sys.stderr)
        mismatch = REPLAY_BROKEN
    return {"box_mismatch": float(mismatch), "sdf_gap_pooled": math.sqrt(sdf[0] / max(sdf[1], 1e-30)), **gaps}


def _box_mismatch(got, want):
    if got.shape != want.shape:
        return max(len(got), len(want))
    return int((got != want).any(axis=1).sum())


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or below its limit."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in table.values())
    return ok, table
