"""Boundary-phase crops a discovery image costs: the crops of every
boundary round (the live counts of ``stats["boundary_active_trace"]``, one
trace per group's shared lattice) over the window's images."""


def read(run):
    if run["kind"] != "discovery" or not run["images"]:
        return None
    return sum(sum(g["stats"]["boundary_active_trace"]) for g in run["groups"]) / run["images"]
