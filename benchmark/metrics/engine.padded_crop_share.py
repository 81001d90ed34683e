"""Share of the crops the engine's model chunks run that are padding: the
executed crops (full chunks, then tail chunks) less the live ones, over the
executed, summed over every model phase of the window's groups, in %."""


def read(run):
    if run["kind"] != "discovery":
        return None
    executed = sum(sum(g["executed"].values()) for g in run["groups"])
    live = sum(sum(g["live"].values()) for g in run["groups"])
    return 100.0 * (executed - live) / executed if executed else None
