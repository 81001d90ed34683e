"""The centre decode kernel's share of its roofline, in %: the least time
for the crops it decoded in the traced groups (the centre and recheck
chunks as executed; their bytes over the HBM bandwidth, which bounds this
kernel) over the device time of its launches in the trace (``union_pack``,
``erode_score``, ``decode_keys`` of ``csrc/decode.cu``)."""

from benchmark import yardstick

KERNELS = ("union_pack", "erode_score", "decode_keys")


def read(run):
    trace = run.get("trace") or {}
    if run["kind"] != "discovery" or not trace.get("kernel_s") or not run["traced_groups"]:
        return None
    device_s = sum(t for name, t in trace["kernel_s"].items() if any(k in name for k in KERNELS))
    crops = sum(g["executed"]["center"] + g["executed"]["recheck_center"] for g in run["traced_groups"])
    if device_s <= 0 or crops == 0:
        return None
    least = yardstick.decode_bytes(crops, run["config"]["crop_size"]) / yardstick.H100_HBM_BYTES_PER_S
    return 100.0 * least / device_s
