"""Share of the traced window in which no kernel, copy or memset ran on
the device (the union of the profiler's device intervals), in %."""

KIND = "discovery"


def read(run):
    trace = run.get("trace") or {}
    if run["kind"] != KIND or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
