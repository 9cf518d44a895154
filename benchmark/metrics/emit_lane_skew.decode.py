"""How far the verified plan's longest lane runs past the mean lane:
100 x (`rows_max` / `rows_mean` - 1) of the port's newest `plan.verify`
stage that started inside the warm-up decodes, the rows of the decode
that verified the plan (the mean over all lanes, empty ones included).
The merged-emit kernel runs until its longest lane ends. None off the
card, on another entry, or where the program records no such stage or
attributes."""


def read(run):
    if run.entry != "decode" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    cold = [(s["start"], s["end"]) for s in run.spans.items
            if s["name"] == "cold_decode"]
    found = [st.attrs for st in trace.stages() if st.name == "plan.verify"
             and "rows_max" in st.attrs and "rows_mean" in st.attrs
             and any(lo <= st.start * 1e-9 <= hi for lo, hi in cold)]
    if not found or not found[-1]["rows_mean"]:
        return None
    return 100 * (found[-1]["rows_max"] / found[-1]["rows_mean"] - 1)
