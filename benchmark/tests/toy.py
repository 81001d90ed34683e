"""A toy copy of the benchmark's data for the CPU tests: tiny models (the
published layouts at toy widths), small scenes, float32 on both sides,
under a scratch root that holds its own ``BENCHMARK.json``,
configurations, traffic, limits and metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TOY = {
    "name": "toy", "source": "https://arxiv.org/abs/2103.13413",
    "backbone_type": "dpt_base", "sdf_activation": "tanh", "use_bg_sdf": True, "features": 32,
    "vit": {"depth": 4, "dim": 64, "heads": 4, "mlp_dim": 128, "patch": 16, "pretrain_grid": 8},
    "hooks": [0, 1, 2, 3], "widths": [16, 32, 64, 64], "classifier_stage_blocks": [1, 1, 1, 1],
    "dtype": "float32", "weights_seed": 11,
    "crop_size": 32, "canvas_size": 96, "image_batch": 2, "max_proposals": 64, "max_splits": 64, "max_active": 64,
    "crop_chunk": 16, "crop_chunk_tail": 8, "exist_chunk": 16, "gather_chunk": 32,
    "class_score_thres": 0.0, "center_score_max_thres": 0.05, "analyze_cc": True, "cc_max_components": 8,
    "cc_enlarge_ratio": 1.5, "max_sdf_thres": 0.5, "max_shrink_threshold": 16.0, "delta_ratio": 0.5, "n_round": 3,
    "proposal_area_thres": 50.0, "nms_iou": 0.5, "sticky_convergence": True,
}
TOY_HYBRID = dict(TOY, name="toy_hybrid", backbone_type="dpt_hybrid", hooks=[0, 1], widths=[16, 32, 64, 64],
                  trunk={"stem_width": 8, "stage_widths": [[8, 16], [8, 32], [16, 64]], "stage_blocks": [1, 1, 1],
                         "groups": 4})
TRAFFIC = {
    "toy_pairs": {"kind": "discovery", "group_sizes": [[96, 96], [80, 90]], "shapes_per_scene": 3, "pool_seed": 3,
                  "pool_groups": 2, "checked_among": 2,
                  "checked_calls": {"exist": 2, "center": 2, "boundary": 2}},
}
# float32 on both sides: the gaps are rounding, and a fault moves them by far more
LIMITS = {"box_mismatch": 0, "sdf_gap_pooled": 1e-3, "center_gap": 1e-3, "exist_gap": 1e-4}
CELLS = {"discover.toy": ("toy", "toy_pairs"), "discover.toy_hybrid": ("toy_hybrid", "toy_pairs")}


def make_root(tmp: Path) -> Path:
    """A scratch benchmark root with the toy cells; returns its spec path."""
    root = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", root / "metrics")
    for cfg in (TOY, TOY_HYBRID):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    workloads = []
    for cell, (config, traffic) in CELLS.items():
        (root / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
        workloads.append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "toy"})

    def retarget(metric):
        return dict(metric, workloads=list(CELLS)) if "workloads" in metric else dict(metric)

    spec = {**real, "configs": [{"name": c["name"], "source": c["source"], "file": f"bench/configs/{c['name']}.json",
                                 "reduced": [], "why": "toy"} for c in (TOY, TOY_HYBRID)],
            "workloads": workloads, "end_to_end": [retarget(m) for m in real["end_to_end"]],
            "per_layer": [retarget(m) for m in real["per_layer"]]}
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
