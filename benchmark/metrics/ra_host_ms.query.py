"""The port's host ms a batch of the traced query window, while the card
waits: each `ra.batch` span's length less the `fetch` spans of its call
(the wave decode's included), averaged over the batches that started in
the traced window. None off the card, or where the program records no
such span."""


def read(run):
    if run.entry != "query" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    win = [s for s in run.spans.items if s["name"] == "batch"
           and s.get("traced")]
    batches = trace.calls("ra.batch", win[0]["start"],
                          win[-1]["end"]) if win else []
    if not batches:
        return None
    host = [root.seconds - sum(s.seconds for s in call if s.name == "fetch")
            for root, call in batches]
    return 1e3 * sum(host) / len(host)
