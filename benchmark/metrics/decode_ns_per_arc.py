"""Host-clock nanoseconds a delivered arc over the whole window: the
window's time over all arcs of the full decodes that completed in it."""


def read(run):
    if run.entry != "decode" or not run.window.get("count"):
        return None
    return run.window["seconds"] / (run.window["count"] * run.arcs) * 1e9
