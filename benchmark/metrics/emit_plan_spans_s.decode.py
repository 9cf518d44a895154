"""Host seconds of the emit planner's stages in set-up: the port's
`plan.*` stages (first call, safe boundaries, split, refinement,
verification, CUDA graph capture, fall back) that started inside the
warm-up decodes, each counted once (not again inside another plan
stage). None off the card, or where the program records no stages."""


def read(run):
    if run.entry != "decode" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    cold = [(s["start"], s["end"]) for s in run.spans.items
            if s["name"] == "cold_decode"]
    plan = [st for st in trace.stages() if st.name.startswith("plan.")
            and any(lo <= st.start * 1e-9 <= hi for lo, hi in cold)]
    if not plan:
        return None
    ids = {st.id for st in plan}
    return sum(st.seconds for st in plan if st.parent not in ids)
