"""The port's host microseconds a steady full decode: the `decode.steady`
span of each decode that started in the traced window (a CUDA graph
replay and the copies of its outputs), averaged. None off the card, or
where the program records no such span."""


def read(run):
    if run.entry != "decode" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    win = [s for s in run.spans.items if s["name"] == "decode"
           and s.get("traced")]
    calls = trace.calls("decode", win[0]["start"],
                        win[-1]["end"]) if win else []
    steady = [s.seconds for _, call in calls for s in call
              if s.name == "decode.steady"]
    if not steady:
        return None
    return 1e6 * sum(steady) / len(steady)
