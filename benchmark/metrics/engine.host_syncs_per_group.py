"""Device-to-host reads a discovery group makes, each a stall of the launch
queue: the program's counter ``host_syncs`` (every read of the engine, its
connected components and its NMS goes through the port's tracer), from
``stats["trace"]`` of the traced groups, averaged over them. None where the
program keeps no such trace."""


def read(run):
    traces = [g["stats"].get("trace") for g in run.get("traced_groups") or []]
    if run.get("kind") != "discovery" or not traces or None in traces:
        return None
    return sum(t["counters"]["host_syncs"] for t in traces) / len(traces)
