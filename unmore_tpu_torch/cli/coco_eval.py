"""Standalone COCO evaluator CLI (port of ``COCO_evaluator/main.py``).

    python -m unmore_tpu_torch.cli.coco_eval --pred_annotations_path preds.json \\
        --gt_annotations_path instances.json [--tasks bbox segm] [--out_path ap_score.json]

Evaluates a prediction JSON (stage-2 scored discoveries, post-processed
training labels, or detector dumps) against a GT instances JSON without a
model in the loop, and writes ``ap_score.json`` next to the predictions.
Class-agnostic by default, like every reference eval. Predictions missing
``score`` fall back to ``weight`` then 1.0. Runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import os

from unmore_tpu_torch.evaluation.coco_eval import evaluate_ap


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pred_annotations_path", type=str, required=True)
    p.add_argument("--gt_annotations_path", type=str, required=True)
    p.add_argument("--tasks", nargs="+", default=["bbox"], choices=["bbox", "segm"])
    p.add_argument("--class_agnostic", action="store_true", default=True)
    p.add_argument("--out_path", type=str, default=None)
    args = p.parse_args(argv)

    with open(args.pred_annotations_path) as f:
        preds = json.load(f)
    if isinstance(preds, dict) and "annotations" in preds:
        preds = preds["annotations"]

    results = evaluate_ap(
        args.gt_annotations_path, preds, iou_types=tuple(args.tasks), class_agnostic=args.class_agnostic,
    )
    for task, metrics in results.items():
        print(f"== {task} ==")
        for k, v in metrics.items():
            print(f"  {k}: {v:.4f}")

    out_path = args.out_path or os.path.join(os.path.dirname(args.pred_annotations_path) or ".", "ap_score.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
