"""Share of a traced discovery group's stream time spent in the boundary
evolution, in %: the program's ``engine.boundary`` span over its
``engine.discover_batch`` span, device seconds of each (CUDA events on the
group's stream, idle included), from ``stats["trace"]`` of the traced
groups. None where the program keeps no such trace."""


def read(run):
    traces = [g["stats"].get("trace") for g in run.get("traced_groups") or []]
    if run.get("kind") != "discovery" or not traces or None in traces:
        return None
    spans = [t["spans"] for t in traces]
    total = sum(s["engine.discover_batch"]["device_s"] for s in spans)
    return 100.0 * sum(s["engine.boundary"]["device_s"] for s in spans) / total if total > 0 else None
