"""Host synchronisations a batch of the traced query window: the port's
`host_syncs` counted inside each `ra.batch` span, averaged over the
batches that started in the traced window. None off the card, or where
the program records no such span."""


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
    return sum(root.syncs for root, _ in batches) / len(batches)
