"""decode_emit's device ms a batch in the traced query window."""

from benchmark import trace


def read(run):
    tr = run.trace
    if run.entry != "query" or not tr or not tr["ops"]:
        return None
    k = trace.kernel_seconds(tr, "decode_emit")
    return None if k is None else k / tr["ops"] * 1e3
