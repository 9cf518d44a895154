"""Host synchronisations a steady full decode: the port's `host_syncs`
counted inside each `decode` call with a `decode.steady` span that
started in the traced window, averaged. None off the card, or where the
program records no such span."""


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
    steady = [root.syncs for root, call in calls
              if any(s.name == "decode.steady" for s in call)]
    if not steady:
        return None
    return sum(steady) / len(steady)
