"""The device time a boundary round costs besides its model calls, in ms:
the self time of the program's ``engine.boundary.round`` spans (their
stream time less that of the spans inside them, the ``models.objectness``
calls and the ``sync.*`` reads) over the number of rounds, from
``stats["trace"]`` of the traced groups: bookkeeping kernels, the bubbles
after host reads and launch gaps. None where the program keeps no such
trace or ran no round."""


def read(run):
    traces = [g["stats"].get("trace") for g in run.get("traced_groups") or []]
    if run.get("kind") != "discovery" or not traces or None in traces:
        return None
    rounds = [t["spans"]["engine.boundary.round"] for t in traces if "engine.boundary.round" in t["spans"]]
    n = sum(r["count"] for r in rounds)
    return 1e3 * sum(r["self_device_s"] for r in rounds) / n if n else None
