"""Share of the discovery window that the objectness net takes on the
device: the summed times between the CUDA events recorded around each
objectness call, over the window's wall time, in %."""


def read(run):
    if run["kind"] != "discovery" or run.get("objectness_ms") is None:
        return None
    return 100.0 * run["objectness_ms"] / 1e3 / run["window_s"]
