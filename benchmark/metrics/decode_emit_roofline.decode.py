"""decode_emit's share of the least time of a full decode: the decode's
bytes (the `.ans` file read once, 4 B a successor and 4 B a node
written) over HBM's peak, divided by decode_emit's device time a decode
in the traced window."""

from benchmark import roofline, trace


def read(run):
    tr = run.trace
    if run.entry != "decode" or not tr or not tr["ops"]:
        return None
    k = trace.kernel_seconds(tr, "decode_emit")
    if not k:
        return None
    bound = roofline.decode_seconds(run.ans_bytes, run.nodes, run.arcs)
    return 100 * bound / (k / tr["ops"])
