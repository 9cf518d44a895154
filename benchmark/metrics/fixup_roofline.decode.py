"""The fixup kernel's share of the least time of its work: the bytes of
the verified node layout (`benchmark/fixup_layout.py`: 20 B a dirty node,
12 B an element) over HBM's peak, divided by emit_fixup_kernel's device
time a decode in the traced window. None off the card, where the trace
shows no fixup kernel, or where the program records no layout."""

from benchmark import fixup_layout, trace


def read(run):
    tr = run.trace
    if run.entry != "decode" or not tr or not tr["ops"]:
        return None
    layout = fixup_layout.verified(run, ("dirty_nodes", "dirty_elements"))
    k = trace.kernel_seconds(tr, "emit_fixup_kernel")
    if layout is None or not k:
        return None
    bound = fixup_layout.fixup_seconds(layout["dirty_nodes"],
                                       layout["dirty_elements"])
    return 100 * bound / (k / tr["ops"])
