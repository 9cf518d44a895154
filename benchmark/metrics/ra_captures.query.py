"""CUDA graph captures in the measured query window: the port's
`ra.capture` stages (a new lane count, cap and output size) that started
inside a batch of the window. None off the card, or where the program
records no stages."""


def read(run):
    if run.entry != "query" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    window = [(s["start"], s["end"]) for s in run.spans.items
              if s["name"] == "batch" and not s.get("warmup")
              and not s.get("traced")]
    if not window:
        return None
    return sum(any(lo <= st.start * 1e-9 <= hi for lo, hi in window)
               for st in trace.stages() if st.name == "ra.capture")
