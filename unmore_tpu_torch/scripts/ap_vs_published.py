"""Stage-2 AP against the published reference results (the port of
``scripts/parity/ap_vs_published.py``).

    python -m unmore_tpu_torch.scripts.ap_vs_published --published unMORE_disc_coco_val17.json \\
        --ours results_reasoning/<run>/object_discovery_with_scores.json \\
        --gt coco_cls_agnostic_instances_val2017.json [--segm]

Both prediction sets go through the port's evaluator
(``evaluation/coco_eval.py``) and print side by side, with the AP50 gap
(published minus ours) against ``--ap50_tolerance`` points. With only
``--published`` it reports the published numbers: a check that the
evaluator reproduces the paper's table on the paper's own predictions.
"""

from __future__ import annotations

import argparse
import json


def load_preds(path):
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "annotations" in data:
        data = data["annotations"]
    return data


def main(argv=None):
    from unmore_tpu_torch.evaluation.coco_eval import evaluate_ap

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--published", required=True)
    ap.add_argument("--ours", default=None)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--segm", action="store_true")
    ap.add_argument("--ap50_tolerance", type=float, default=0.5, help="largest AP50 gap (points) that passes")
    args = ap.parse_args(argv)

    tasks = ("bbox", "segm") if args.segm else ("bbox",)
    rows = {"published": evaluate_ap(args.gt, load_preds(args.published), iou_types=tasks)}
    if args.ours:
        rows["ours"] = evaluate_ap(args.gt, load_preds(args.ours), iou_types=tasks)
    for task in tasks:
        print(f"[{task}]")
        keys = list(next(iter(rows.values()))[task])
        print("          " + "".join(f"{k:>8s}" for k in keys))
        for name, metrics in rows.items():
            print(f"{name:>10s}" + "".join(f"{100 * metrics[task][k]:8.2f}" for k in keys))
        if "ours" in rows:
            gap = 100 * (rows["published"][task]["AP50"] - rows["ours"][task]["AP50"])
            status = "PASS" if gap <= args.ap50_tolerance else "FAIL"
            print(f"AP50 gap (published - ours): {gap:+.2f} points -> {status}")


if __name__ == "__main__":
    main()
