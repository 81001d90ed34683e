"""Stage-2 discovery traffic: groups of seeded scenes through
``ObjectDiscoveryEngine.discover_batch``, back to back: a fixed pool of
groups (the traffic's ``pool_seed``) in an order drawn from ``--seed``,
round and round.

Set-up builds the configuration's models in its dtype, loads the
benchmark's weights, and runs one warm-up group (every chunk shape of the
cell, the decode kernel's build or load). The window opens at a
``synchronize()`` and closes at the first end of a pass over the whole
pool at or after ``--seconds``: every run does the same work, every image
counted is whole, and the time counted is all the time its groups took.
The model calls of one group, drawn from the seed, are kept as the system
made them, each copied to the host as it comes so that the peak of device
memory is the deployment's; after the window the reference replays that
group (:func:`benchmark.check.discovery_gaps`).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark import check, weights, world, yardstick
from benchmark.trace import traced

WARMUP_GROUP = -1  # the warm-up group: the pool's next, outside the window's


def port_objectness(config, sd, device):
    """The port's ObjectnessNet of ``config`` in float32 on ``device``,
    holding ``sd``."""
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.vit import ViTConfig

    trunk = config.get("trunk")
    kw = {} if trunk is None else {"hybrid_resnet_kwargs": {
        k: tuple(map(tuple, v)) if k == "stage_widths" else (tuple(v) if isinstance(v, list) else v)
        for k, v in trunk.items()}}
    with torch.device("meta"):  # no host init: every leaf comes from ``sd``
        model = ObjectnessNet(config["backbone_type"], config["sdf_activation"], config["use_bg_sdf"],
                              features=config["features"], vit_config=ViTConfig(**config["vit"]),
                              hooks=tuple(config["hooks"]), widths=tuple(config["widths"]), **kw)
    return load(model, sd, device)


def load(model, sd, device):
    """``model``, built on the meta device, on ``device`` holding ``sd``."""
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model


class PortSystem:
    """The system under test: the port's ObjectnessNet and existence
    classifier in the configuration's dtype, as the discovery CLI builds
    them, behind the engine's calling convention."""

    def __init__(self, config, sd, device):
        from unmore_tpu_torch.models.resnet import BinaryClassifier

        dtype = getattr(torch, config["dtype"])
        with torch.device("meta"):
            cls = BinaryClassifier(tuple(config["classifier_stage_blocks"]))
        self.obj = port_objectness(config, sd["objectness"], device).to(dtype).eval()
        self.cls = load(cls, sd["classifier"], device).to(dtype).eval()

    def objectness_fn(self, crops, compute_center=True):
        return self.obj(crops, compute_center=compute_center)

    def classifier_fn(self, crops):
        return self.cls(crops)[:, 0]


class Recorder:
    """The engine's model functions: the system's, with each call's outputs
    kept on the host while ``calls`` is a list and the objectness calls
    marked on the device's timeline while ``marks`` is."""

    def __init__(self, system, ctx):
        self.system, self.ctx = system, ctx
        self.calls = None
        self.marks = None

    def objectness_fn(self, crops, compute_center=True):
        if self.marks is not None:
            self.marks.append(self.ctx.mark())
        out = self.system.objectness_fn(crops, compute_center)
        if self.marks is not None:
            self.marks.append(self.ctx.mark())
        if self.calls is not None:
            self.calls.append(("center" if compute_center else "boundary", {k: v.cpu() for k, v in out.items()}))
        return out

    def classifier_fn(self, crops):
        scores = self.system.classifier_fn(crops)
        if self.calls is not None:
            self.calls.append(("exist", {"scores": scores.cpu()}))
        return scores


def engine_config(config):
    from unmore_tpu_torch.reasoning.engine import ReasoningConfig

    names = {f.name for f in dataclasses.fields(ReasoningConfig)}
    return ReasoningConfig(**{k: config[k] for k in names if k in config})


def group_record(results, cfg):
    stats = results[0]["stats"]
    seeds = [r["stats"]["n_seed"] for r in results]
    live, executed = yardstick.crop_counts(stats, seeds, cfg)
    return {"stats": stats, "images": len(results), "live": live, "executed": executed}


def run(ctx):
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    sizes = [tuple(s) for s in traffic["group_sizes"]]
    sd = weights.for_config(cfg, ctx.device)
    system = ctx.system(cfg, sd, ctx.device) if ctx.system else PortSystem(cfg, sd, ctx.device)
    del sd
    ctx.free()
    rec = Recorder(system, ctx)
    engine = ObjectDiscoveryEngine(rec.objectness_fn, rec.classifier_fn, engine_config(cfg), device=ctx.device)

    # every seed runs the same pool of groups, in its own order: the scenes'
    # content sets a group's work, so drawing new scenes from each seed would
    # change the work from run to run
    pool = traffic["pool_groups"]
    assert traffic["checked_among"] <= pool, "the checked group has to lie in the window's first pass"
    order = np.random.default_rng(world.key(ctx.seed, 5)).permutation(pool)

    def scenes(i):
        group = pool if i == WARMUP_GROUP else int(order[i % pool])
        return world.scenes(traffic["pool_seed"], group, sizes, traffic["shapes_per_scene"])

    engine.discover_batch(scenes(WARMUP_GROUP))
    ctx.sync()
    setup_s = time.time() - ctx.t_start

    checked = int(np.random.default_rng(world.key(ctx.seed, 3)).integers(0, traffic["checked_among"]))
    groups, trace, kept = [], {}, None
    rec.marks = [] if ctx.trace else None
    t0 = time.perf_counter()
    i = 0
    while True:
        images = scenes(i)
        rec.calls = [] if i == checked else None
        results = engine.discover_batch(images)
        groups.append(group_record(results, cfg))
        if i == checked:
            kept = (images, [r["boxes"] for r in results], rec.calls)
        i += 1
        if (ctx.until_checked and kept is not None) or (i % pool == 0 and time.perf_counter() - t0 >= ctx.seconds):
            break
    window_s = time.perf_counter() - t0
    peak = ctx.peak_bytes()
    marks, rec.marks, rec.calls = rec.marks, None, None
    traced_groups = []
    if ctx.trace:  # one more group under the profiler, after the window
        with traced(ctx.sync, trace):
            results = engine.discover_batch(scenes(i))
        traced_groups.append(group_record(results, cfg))
    objectness_ms = None
    if marks:
        ctx.sync()
        objectness_ms = sum(ctx.elapsed_ms(a, b) for a, b in zip(marks[0::2], marks[1::2]))
    del engine, rec, system
    ctx.free()

    images, boxes, calls = kept
    numbers = check.discovery_gaps(cfg, calls, images, boxes, ctx.seed, ctx.device, weights.for_config(cfg, ctx.device),
                                   traffic["checked_calls"])
    n_images = sum(g["images"] for g in groups)
    print(f"discovery: {len(groups)} groups, {n_images} images in {window_s:.3f} s; checked group {checked}",
          file=sys.stderr)
    for j, g in enumerate(groups[:pool]):  # the pool's load, group by group
        print(f"load: pool group {int(order[j])} live {g['live']} executed {g['executed']} "
              f"boundary_trace {g['stats']['boundary_active_trace']}", file=sys.stderr)
    return {
        "attempted": n_images, "failed": 0, "numbers": numbers, "peak_bytes": peak, "trace": trace,
        "end_to_end": {"setup_s": setup_s, "infer_images_per_s": n_images / window_s,
                       "peak_memory_gib": peak / 2**30},
        "run": {"kind": "discovery", "config": cfg, "groups": groups, "images": n_images,
                "window_s": window_s, "trace": trace, "traced_groups": traced_groups,
                "objectness_ms": objectness_ms, "crop_flops": yardstick.crop_flops(cfg)},
    }
