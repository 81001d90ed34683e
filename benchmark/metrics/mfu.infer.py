"""The discovery window's model FLOP rate as a share of the card's dense
bf16 peak (989 TFLOP/s, H100 SXM), in %: the FLOPs that the window's live
crops need (the classifier on existence crops, both heads on centre and
recheck crops, the SDF head on boundary crops; ``benchmark.yardstick``'s
count) over the window's wall time."""

from benchmark import yardstick


def read(run):
    if run["kind"] != "discovery":
        return None
    both, sdf_only, cls = run["crop_flops"]
    flops = sum(yardstick.group_flops(g["live"], both, sdf_only, cls) for g in run["groups"])
    return 100.0 * flops / run["window_s"] / yardstick.H100_BF16_FLOPS
