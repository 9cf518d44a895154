"""Device ms a decode of everything in the traced window other than
decode_emit: the post-pass kernels, copies and fills."""

from benchmark import trace


def read(run):
    tr = run.trace
    if run.entry != "decode" or not tr or not tr["ops"]:
        return None
    k = trace.kernel_seconds(tr, "decode_emit")
    if k is None:
        return None
    return (tr["device_total_s"] - k) / tr["ops"] * 1e3
