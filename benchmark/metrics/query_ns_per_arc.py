"""Host-clock nanoseconds a returned arc: the window's time over the
arcs that all its batches returned (the reference's random-access
measure)."""


def read(run):
    arcs = sum(r["arcs"] for r in run.records)
    if run.entry != "query" or not arcs:
        return None
    return run.window["seconds"] / arcs * 1e9
