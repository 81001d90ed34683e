"""A/B of the boundary lattice's capacity for AP on the dense tail (the port
of ``scripts/max_active_ab.py``).

    python -m unmore_tpu_torch.scripts.max_active_ab --synth WORLD \\
        --objectness OBJ.ckpt --classifier CLS.ckpt \\
        --main_scored WORK/results_reasoning/disc_r5/object_discovery_with_scores.json \\
        --main_max_active 1536 --max_active 1024 --start_idx 0 --end_idx 40 [--device cpu --dtype float32]

The boundary phase runs on a lattice of ``max_active`` boxes per image; the
reference keeps unbounded candidate lists and never truncates. Two legs on
the same dense-tail subset, with one scorer and one evaluation:

* ``main``: the main run's scored annotations (made at ``--main_max_active``,
  sized so that nothing overflows), filtered to the subset;
* ``truncated``: discovery and scoring again at ``--max_active``, where the
  engine sheds the lowest-scored boxes past the lattice.

``delta_main_minus_truncated`` is what the truncation costs in AP. The
discovery and scoring of the truncated leg are ``sticky_ab``'s; the models,
``--device``, ``--dtype`` and the default ``--out`` follow it
(``scripts/torch_max_active_ab_results.json`` on the card,
``..._cpu.json`` elsewhere).
"""

from __future__ import annotations

import argparse
import json

from unmore_tpu_torch.scripts.sticky_ab import (
    add_model_flags, ap_figures, backend_of, default_out, load_models, load_world, make_scorer, run_mode, score_leg,
    setup_device, utc_now,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_flags(ap)
    ap.add_argument("--main_scored", required=True,
                    help="object_discovery_with_scores.json of the main run (the leg that is not truncated)")
    ap.add_argument("--main_max_active", type=int, required=True,
                    help="max_active the main run used (provenance only)")
    ap.add_argument("--max_active", type=int, default=1024, help="the truncated leg's boundary-lattice capacity")
    ap.add_argument("--start_idx", type=int, default=0)
    ap.add_argument("--end_idx", type=int, default=40)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = setup_device(args.device)

    from unmore_tpu_torch.reasoning.engine import ReasoningConfig

    objectness_fn, classifier_fn = load_models(args, device)
    dataset, gt = load_world(args.synth, args.start_idx, args.end_idx, subset=True)
    subset_ids = {im["id"] for im in gt["images"]}
    meta = {"n_images": len(dataset), "start_idx": args.start_idx, "end_idx": args.end_idx, "synth": args.synth,
            "recorded_utc": utc_now(), "backend": backend_of(device)}
    report = {"meta": meta}

    # leg A: the main run's annotations, filtered to the subset
    with open(args.main_scored) as f:
        main_anns = [a for a in json.load(f) if int(a["image_id"]) in subset_ids]
    report["main"] = {"max_active": args.main_max_active, **ap_figures(gt, main_anns),
                      "n_annotations": len(main_anns)}
    print(json.dumps(report["main"], indent=2), flush=True)

    # leg B: discovery again at the truncated lattice
    cfg = ReasoningConfig(canvas_size=args.canvas_size, image_batch=args.image_batch, max_active=args.max_active)
    boxes_by_img, crops, wall = run_mode(cfg, objectness_fn, classifier_fn, dataset, args.image_batch, device)
    scorer = make_scorer(args, objectness_fn, classifier_fn, device)
    anns = score_leg(scorer, dataset, boxes_by_img, args.image_batch)
    report["truncated"] = {"max_active": args.max_active, **ap_figures(gt, anns), "n_annotations": len(anns),
                           "active_overflow": int(crops["active_overflow"]),
                           "split_overflow": int(crops["split_overflow"]), "discovery_wall_s": round(wall, 1)}
    print(json.dumps(report["truncated"], indent=2), flush=True)

    a, b = report["main"], report["truncated"]
    report["delta_main_minus_truncated"] = {k: round(a[k] - b[k], 4)
                                            for k in ("bbox_AP", "bbox_AP50", "segm_AP", "segm_AP50")}
    print(json.dumps(report["delta_main_minus_truncated"], indent=2))
    out_path = args.out or default_out("max_active_ab_results", device)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
