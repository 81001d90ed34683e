"""The chain's report (the port's copy of ``scripts/scale_report.py``).

    python -m unmore_tpu_torch.scripts.scale_report --work WORK [--out WORK/scale_report.json]

``scale_chain`` leaves its evidence across ``--work``: stage walls in
``scale_timings.txt``, per-image discovery stats in
``discovery_stats_<tag>.json`` (``parse_discovery_stats``), the scoring
CLI's device / host split in ``scoring_<tag>.log``, the pseudo-labels' AP
in ``ap_score_pseudo.json``, the CAD's metrics files and its ``'ips'`` and
``'data_starved'`` log lines, the supervisors' restarts in the step logs,
and the dense-tail A/Bs (``max_active_ab_results.json``,
``sticky_ab_results.json``). This folds them into one JSON. The parsers and
the A/B sections are the JAX script's, read from ``--work`` where the JAX
script reads its repository's ``scripts/``. The sticky A/B counts as dense
(``sticky_ab_dense``) only when it is fresh; else it goes under
``sticky_ab_stale`` with the first reason of: a byte copy of the round-3
sparse archive ``scripts/sticky_ab_results_r3_sparse.json`` (read only), a
``sticky`` step in ``failed_steps.txt``, a leg without ``meta``, or legs of
different worlds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from pathlib import Path

R3_SPARSE_ARCHIVE = str(Path(__file__).resolve().parents[2] / "scripts" / "sticky_ab_results_r3_sparse.json")


def parse_timings(path: str) -> dict:
    """``HH:MM:SS [@epoch] label ... start|done`` pairs -> stage wall seconds.

    The optional ``@<epoch-seconds>`` field (written by the chain's T()
    since round 5) is exact across any number of midnights; the
    clock-only fallback handles one wrap (ADVICE r4).
    """
    if not os.path.isfile(path):
        return {}
    starts, out = {}, {}
    with open(path) as f:
        for line in f:
            m = re.match(r"(\d\d):(\d\d):(\d\d) (?:@(\d+) )?(.+)", line.strip())
            if not m:
                continue
            if m.group(4):
                t, exact = int(m.group(4)), True
            else:
                t = int(m.group(1)) * 3600 + int(m.group(2)) * 60 + int(m.group(3))
                exact = False
            label = m.group(5)
            if label.endswith(" start"):
                starts[label[:-6]] = (t, exact)
            elif label.endswith(" done"):
                stage = label[:-5]
                # "post start" pairs with "post+eval done"
                key = "post" if stage == "post+eval" else stage
                if key in starts:
                    t0, exact0 = starts.pop(key)
                    dt = t - t0
                    if dt < 0 and not (exact and exact0):  # midnight wrap
                        dt += 24 * 3600
                    out[stage] = dt
    return out


def parse_scoring_log(path: str) -> dict:
    """Pull the timing split + throughput from the scoring CLI log.

    A multi-process sharded run interleaves one final split line per
    shard: device/host seconds are SUMMED across shards and
    ``n_scoring_shards`` reports how many were seen (ADVICE r4 —
    previously only the last shard's split survived).
    """
    if not os.path.isfile(path):
        return {}
    out: dict = {}
    split = re.compile(
        r"timing split: device ([\d.]+)s, host tail ([\d.]+)s \(host/device ([\d.]+)\)"
    )
    rate = re.compile(r"\[(\d+)/(\d+)\] images .*?\(([\d.]+) img/s\)")
    device_s, host_s, shards = 0.0, 0.0, 0
    with open(path) as f:
        for line in f:
            m = split.search(line)
            if m:
                device_s += float(m.group(1))
                host_s += float(m.group(2))
                shards += 1
            m = rate.search(line)
            if m:
                out["images_done"] = int(m.group(1))
                out["images_total"] = int(m.group(2))
                out["images_per_sec"] = float(m.group(3))
            if line.startswith("# of final annotations"):
                out["final_annotations"] = int(line.rsplit(None, 1)[-1])
    if shards:
        out["device_s"] = round(device_s, 1)
        out["host_tail_s"] = round(host_s, 1)
        out["host_over_device"] = round(host_s / max(device_s, 1e-9), 3)
        out["n_scoring_shards"] = shards
        if shards > 1:
            # the [k/n] progress rate is per-shard; flag it
            out["images_per_sec_is_per_shard"] = True
    return out


def parse_cad_log(path: str) -> dict:
    """Sustained throughput + starvation from the CAD train log tail."""
    if not os.path.isfile(path):
        return {}
    rates, starved = [], []
    # the CAD trainer prints one metrics dict per log window, e.g.
    # {'total_loss': ..., 'iteration': 500, 'ips': 7.93, 'data_starved': 0.27}
    ips = re.compile(r"'ips': ([\d.]+)")
    starve = re.compile(r"'data_starved': ([\d.]+)")
    with open(path) as f:
        for line in f:
            m = ips.search(line)
            if m:
                rates.append(float(m.group(1)))
            m = starve.search(line)
            if m:
                starved.append(float(m.group(1)))
    out: dict = {}
    if rates:
        tail = rates[-20:]
        out["img_per_sec_tail_mean"] = round(sum(tail) / len(tail), 2)
        out["img_per_sec_min"] = min(tail)
        out["img_per_sec_max"] = max(tail)
    if starved:
        out["data_starved_frac_last"] = starved[-1]
    return out


def parse_supervisor_events(work: str) -> dict:
    """Count supervisor interventions per stage log.

    The r5 resilience story is events + recovery, not just final
    outcomes: watchdog kills (output-silence and busy-wedge),
    relaunches, and how many already-processed images each restarted
    stage-2 CLI skipped via its partial-results file.
    """
    pats = {
        "hang_kills": re.compile(r"supervisor: no child output for"),
        "busy_wedge_kills": re.compile(r"relay wedge, not a compile"),
        "relaunches": re.compile(r"supervisor: restart \d+/"),
        "resumed_images": re.compile(r"resuming: (\d+) images already"),
    }
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(work, "*.log"))):
        counts: dict = {}
        with open(path, errors="replace") as f:
            for line in f:
                for key, pat in pats.items():
                    m = pat.search(line)
                    if not m:
                        continue
                    inc = int(m.group(1)) if pat.groups else 1
                    counts[key] = counts.get(key, 0) + inc
        if counts:
            out[os.path.basename(path)] = counts
    return out


def newest_json(pattern: str):
    paths = glob.glob(pattern)
    if not paths:
        return None, None
    p = max(paths, key=os.path.getmtime)
    with open(p) as f:
        # keep the parent dir in the name: variant output dirs
        # (cad_r5 vs cad_r5_scenes) share metric file names
        return os.path.join(os.path.basename(os.path.dirname(p)), os.path.basename(p)), json.load(f)


def sticky_section(path: str, failed_steps: list) -> dict:
    """``{"sticky_ab_dense": results}`` when the sticky A/B at ``path`` is
    fresh, else ``{"sticky_ab_dense": None, "sticky_ab_stale": {"reason",
    "results"}}``, the staleness rules tried in the JAX report's order."""
    with open(path) as f:
        raw = f.read()
    sticky = json.loads(raw)
    stale_reason = None
    if os.path.isfile(R3_SPARSE_ARCHIVE):
        with open(R3_SPARSE_ARCHIVE) as f:
            if f.read() == raw:
                stale_reason = "byte-identical to the r3 sparse archive"
    if any("sticky" in s for s in failed_steps):
        stale_reason = stale_reason or "step_sticky_ab in failed_steps"
    metas = [sticky.get(m, {}).get("meta") for m in ("sticky", "reference_rounds")]
    if stale_reason is None and not all(metas):
        stale_reason = "legs lack a provenance stamp (pre-r5 run)"
    if stale_reason is None and sticky.get("delta_legs_comparable") is False:
        stale_reason = "legs ran on different worlds (meta mismatch)"
    if stale_reason is None:
        return {"sticky_ab_dense": sticky}
    return {"sticky_ab_dense": None, "sticky_ab_stale": {"reason": stale_reason, "results": sticky}}


def report(work: str, tag: str = "r5") -> dict:
    """The report of the chain run in ``work``."""
    out: dict = {"work_dir": work, "tag": tag}
    card = os.path.join(work, "card.txt")
    if os.path.isfile(card):
        with open(card) as f:
            out["card"] = f.read().strip()
    out["stage_wall_s"] = parse_timings(os.path.join(work, "scale_timings.txt"))
    disc_path = os.path.join(work, f"discovery_stats_{tag}.json")
    if os.path.isfile(disc_path):
        with open(disc_path) as f:
            out["discovery"] = json.load(f)
    out["scoring"] = parse_scoring_log(os.path.join(work, f"scoring_{tag}.log"))
    ap_path = os.path.join(work, "ap_score_pseudo.json")
    if os.path.isfile(ap_path):
        with open(ap_path) as f:
            out["pseudo_label_ap"] = json.load(f)
    cad_name, cad_metrics = newest_json(os.path.join(work, f"cad_{tag}*", "metrics_*.json"))
    if cad_metrics:
        out["cad_final_eval"] = {"file": cad_name, "metrics": cad_metrics}
    out["cad_train"] = parse_cad_log(os.path.join(work, f"cad_{tag}.log"))
    ma_path = os.path.join(work, "max_active_ab_results.json")
    if os.path.isfile(ma_path):
        with open(ma_path) as f:
            out["max_active_ab"] = json.load(f)
    events = parse_supervisor_events(work)
    if events:
        out["supervisor_events"] = events
    failed = os.path.join(work, "failed_steps.txt")
    failed_steps = []
    if os.path.isfile(failed):
        with open(failed) as f:
            failed_steps = out["failed_steps"] = [line.strip() for line in f if line.strip()]
    sticky_path = os.path.join(work, "sticky_ab_results.json")
    if os.path.isfile(sticky_path):
        out.update(sticky_section(sticky_path, failed_steps))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--tag", default="r5")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    text = json.dumps(report(args.work, args.tag), indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
