"""A/B of sticky convergence against the reference's re-predicted rounds, for
AP (the port of ``scripts/sticky_ab.py``).

    python -m unmore_tpu_torch.scripts.sticky_ab --synth WORLD \\
        --objectness OBJ.ckpt --classifier CLS.ckpt \\
        [--canvas_size 512 --image_batch 4 --start_idx 0 --end_idx 40] [--device cpu --dtype float32]

The engine's default freezes converged boxes (``sticky_convergence``): they
stop costing model FLOPs. The reference re-predicts every surviving box in
all ``n_round`` rounds. This runs discovery in both modes with trained
weights over the synthetic shape world (exact GT), scores and evaluates each
leg, and records its AP / AP50, the boundary crops it ran, the lattice
overflows and its discovery wall; then the AP deltas, the boundary-crop
ratio and the speedup of sticky over the reference.

Each leg is written as soon as it is done, merged into an existing ``--out``
(so a crashed leg can be run again alone with ``--modes``), and stamped with
``meta`` (world, subset, lattices, UTC time, backend): ``delta`` is computed
over legs of one world only (``delta_legs_comparable``). The models run in
``--dtype`` (``bfloat16``, as the JAX script; ``float32`` for runs on the
CPU) on ``--device`` (default: the card). The default ``--out`` is
``scripts/torch_sticky_ab_results.json`` on the card and
``scripts/torch_sticky_ab_results_cpu.json`` elsewhere: never a record of
the JAX package. ``--boundary_segment`` is accepted and ignored, as in the
discovery CLI.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CROP_KEYS = ("boundary", "existence", "center", "split_overflow", "active_overflow", "cc_overflow")
AP_KEYS = ("bbox_AP", "bbox_AP50", "segm_AP", "segm_AP50")


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The flags both A/B scripts share with the JAX scripts, and the port's
    ``--device`` and ``--dtype``."""
    ap.add_argument("--synth", required=True)
    ap.add_argument("--objectness", required=True)
    ap.add_argument("--classifier", required=True)
    ap.add_argument("--canvas_size", type=int, default=512)
    ap.add_argument("--image_batch", type=int, default=4)
    ap.add_argument("--sdf_activation", default=None)
    ap.add_argument("--backbone_type", default="dpt_large")
    ap.add_argument("--use_bg_sdf", action="store_true", default=True)
    ap.add_argument("--boundary_segment", type=int, default=5,
                    help="accepted and ignored: the port runs the boundary rounds in one call")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu for runs on the CPU)")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_flags(ap)
    ap.add_argument("--max_active", type=int, default=None,
                    help="override ReasoningConfig.max_active (the boundary lattice per image)")
    ap.add_argument("--max_splits", type=int, default=None,
                    help="override ReasoningConfig.max_splits (the split lattice per image)")
    ap.add_argument("--start_idx", type=int, default=-1,
                    help="scene-index subset (with --end_idx); GT is filtered to the subset for evaluation")
    ap.add_argument("--end_idx", type=int, default=-1)
    ap.add_argument("--modes", default="sticky,reference_rounds",
                    help="comma list; a partial run merges into an existing results file")
    return ap.parse_args(argv)


def setup_device(name):
    """``--device`` (default: card 0) as the CLIs resolve it: a missing card
    raises; the card is made current and TF32 turned off."""
    from types import SimpleNamespace

    from unmore_tpu_torch.cli.common import setup_device as setup

    return setup(SimpleNamespace(device=name, gpu_index=0))


def backend_of(device) -> str:
    """The torch device type, with the card's name where there is one."""
    import torch

    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def default_out(name: str, device) -> str:
    """``scripts/torch_<name>.json`` on the card, ``..._cpu.json`` elsewhere."""
    return str(REPO / "scripts" / (f"torch_{name}.json" if device.type == "cuda" else f"torch_{name}_cpu.json"))


def load_models(args, device):
    """(objectness_fn, classifier_fn) of the two checkpoints in ``--dtype``."""
    from unmore_tpu_torch.cli import common

    objectness = common.build_objectness(args, args.dtype, device)
    classifier = common.build_classifier(args.dtype, device)
    common.load_objectness_weights(objectness, args.objectness)
    common.load_classifier_weights(classifier, args.classifier)
    return common.make_apply_fns(objectness, classifier)


def load_world(synth: str, start_idx: int, end_idx: int, subset: bool):
    """(the world's scenes in [start_idx, end_idx), their GT), the GT
    filtered to those scenes when ``subset``."""
    from unmore_tpu_torch.data.coco import COCOImages

    gt_path = os.path.join(synth, "coco", "instances.json")
    dataset = COCOImages(os.path.join(synth, "coco", "images"), gt_path, start_idx, end_idx)
    with open(gt_path) as f:
        gt = json.load(f)
    if subset:
        keep = {int(dataset.image_id(i)) for i in range(len(dataset))}
        gt = dict(gt, images=[im for im in gt["images"] if im["id"] in keep],
                  annotations=[a for a in gt["annotations"] if a["image_id"] in keep])
        print(f"subset: {len(gt['images'])} images, {len(gt['annotations'])} GT anns")
    return dataset, gt


def run_mode(engine_cfg, objectness_fn, classifier_fn, dataset, image_batch, device):
    """Discovery over ``dataset`` in groups of ``image_batch``: (boxes by
    image id, crop and overflow counters, wall seconds). The trace and the
    ``n_*`` counters are of the group's shared lattice: counted once a group."""
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine

    engine = ObjectDiscoveryEngine(objectness_fn, classifier_fn, engine_cfg, device=device)
    results = {}
    crops = dict.fromkeys(CROP_KEYS, 0)
    t0 = time.time()
    n = len(dataset)
    for base in range(0, n, image_batch):
        group = [dataset.get(i) for i in range(base, min(base + image_batch, n))]
        outs = engine.discover_batch([g[0] for g in group])
        for (_, image_id), out in zip(group, outs):
            results[int(image_id)] = np.asarray(out["boxes"], np.float32)
        s = outs[0]["stats"]
        crops["boundary"] += sum(s.get("boundary_active_trace", []))
        crops["existence"] += sum(o["stats"]["n_seed"] for o in outs) + s.get("n_split", 0)
        crops["center"] += s.get("n_center_in", 0) + s.get("n_recheck_center_in", 0)
        for k in ("split_overflow", "active_overflow", "cc_overflow"):
            crops[k] += int(s.get(k, 0))
        print(f"  [{min(base + image_batch, n)}/{n}]", flush=True)
    return results, crops, time.time() - t0


def make_scorer(args, objectness_fn, classifier_fn, device):
    from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig

    cfg = ScoringConfig(canvas_size=args.canvas_size, image_batch=args.image_batch)
    return ObjectScoringEngine(objectness_fn, classifier_fn, cfg, device=device)


def score_leg(scorer, dataset, boxes_by_img: dict, image_batch: int) -> list:
    """The scored annotations of one leg's boxes, in image-id order."""
    anns = []
    ids = sorted(boxes_by_img)
    for base in range(0, len(ids), image_batch):
        chunk = ids[base : base + image_batch]
        images = [dataset.get_by_id(i)[0] for i in chunk]
        for a in scorer.score_batch(images, [boxes_by_img[i].reshape(-1, 4) for i in chunk], chunk):
            anns.extend(a)
    return anns


def ap_figures(gt: dict, anns: list) -> dict:
    """bbox and segm AP and AP50 of ``anns``, rounded as the JAX script rounds them."""
    from unmore_tpu_torch.evaluation.coco_eval import evaluate_ap

    m = evaluate_ap(gt, anns, iou_types=("bbox", "segm"))
    return {k: round(m[k.split("_")[0]][k.split("_")[1]], 4) for k in AP_KEYS}


def leg_report(meta: dict, gt: dict, anns: list, crops: dict, wall: float) -> dict:
    return {"meta": dict(meta), **ap_figures(gt, anns), "boundary_crops": int(crops["boundary"]),
            "split_overflow": crops["split_overflow"], "active_overflow": crops["active_overflow"],
            "cc_overflow": crops["cc_overflow"], "discovery_wall_s": round(wall, 1), "n_annotations": len(anns)}


def add_delta(report: dict) -> None:
    """``delta_legs_comparable`` and ``delta`` (sticky minus reference) when
    ``report`` holds both legs. A merged file can pair legs of different
    worlds: they are comparable only when both saw the same images."""
    if "sticky" not in report or "reference_rounds" not in report:
        return
    s, r = report["sticky"], report["reference_rounds"]
    sm, rm = s.get("meta", {}), r.get("meta", {})
    same_world = all(sm.get(k) == rm.get(k) for k in ("n_images", "start_idx", "end_idx", "synth", "max_active"))
    report["delta_legs_comparable"] = bool(same_world and sm and rm)
    report["delta"] = {
        "bbox_AP50": round(s["bbox_AP50"] - r["bbox_AP50"], 4),
        "segm_AP50": round(s["segm_AP50"] - r["segm_AP50"], 4),
        "bbox_AP": round(s["bbox_AP"] - r["bbox_AP"], 4),
        "boundary_crop_ratio": round(r["boundary_crops"] / max(s["boundary_crops"], 1), 2),
        "speedup": round(r["discovery_wall_s"] / max(s["discovery_wall_s"], 1e-9), 2),
    }


def utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d %H:%M")


def main(argv=None):
    args = parse_args(argv)
    device = setup_device(args.device)

    from unmore_tpu_torch.reasoning.engine import ReasoningConfig

    objectness_fn, classifier_fn = load_models(args, device)
    dataset, gt = load_world(args.synth, args.start_idx, args.end_idx, args.start_idx != -1 or args.end_idx != -1)
    scorer = make_scorer(args, objectness_fn, classifier_fn, device)
    # provenance: a fresh A/B is told from a stale merge of another world by it
    run_meta = {"n_images": len(dataset), "start_idx": args.start_idx, "end_idx": args.end_idx, "synth": args.synth,
                "max_active": args.max_active, "max_splits": args.max_splits, "recorded_utc": utc_now(),
                "backend": backend_of(device)}
    out_path = args.out or default_out("sticky_ab_results", device)
    report = {}
    if os.path.isfile(out_path):
        with open(out_path) as f:
            report.update(json.load(f))
    wanted = {m.strip() for m in args.modes.split(",")}
    for mode, sticky in (("sticky", True), ("reference_rounds", False)):
        if mode not in wanted:
            continue
        print(f"== discovery [{mode}]", flush=True)
        lattices = {k: getattr(args, k) for k in ("max_active", "max_splits") if getattr(args, k) is not None}
        cfg = ReasoningConfig(canvas_size=args.canvas_size, image_batch=args.image_batch,
                              sticky_convergence=sticky, **lattices)
        boxes_by_img, crops, wall = run_mode(cfg, objectness_fn, classifier_fn, dataset, args.image_batch, device)
        print(f"== scoring [{mode}]", flush=True)
        anns = score_leg(scorer, dataset, boxes_by_img, args.image_batch)
        report[mode] = leg_report(run_meta, gt, anns, crops, wall)
        print(json.dumps(report[mode], indent=2), flush=True)
        with open(out_path, "w") as f:  # each leg as it is done: a crash keeps the legs before it
            json.dump(report, f, indent=2)
    add_delta(report)
    if "delta" in report:
        print(json.dumps(report["delta"], indent=2))
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
