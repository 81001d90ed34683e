"""Share of a traced discovery group's stream time inside the objectness
net's calls, in %: the program's ``models.objectness`` spans over its
``engine.discover_batch`` span, device seconds of each (CUDA events on the
group's stream), from ``stats["trace"]`` of the traced groups. The
in-program counterpart of ``models.objectness_time_share``, which times the
same calls from the harness over the whole window. None where the program
keeps no such trace."""


def read(run):
    traces = [g["stats"].get("trace") for g in run.get("traced_groups") or []]
    if run.get("kind") != "discovery" or not traces or None in traces:
        return None
    spans = [t["spans"] for t in traces]
    total = sum(s["engine.discover_batch"]["device_s"] for s in spans)
    model = sum(s["models.objectness"]["device_s"] for s in spans if "models.objectness" in s)
    return 100.0 * model / total if total > 0 else None
