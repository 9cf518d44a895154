"""The steady layout the port's emit planner verified in a run's set-up:
the attributes of the newest `plan.verify` stage
(webgraph_ans_torch.utils.trace) that started inside the warm-up
decodes and carries them."""

from __future__ import annotations

LAYOUT = ("fixup_rounds", "dirty_nodes", "empty_lanes", "lanes")


def verified_layout(run) -> dict | None:
    """{fixup_rounds, dirty_nodes, empty_lanes, lanes} of the run's
    verified plan. None off the card, on another entry, or where the
    program records no such stage or attributes."""
    if run.entry != "decode" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    cold = [(s["start"], s["end"]) for s in run.spans.items
            if s["name"] == "cold_decode"]
    found = [st.attrs for st in trace.stages() if st.name == "plan.verify"
             and all(k in st.attrs for k in LAYOUT)
             and any(lo <= st.start * 1e-9 <= hi for lo, hi in cold)]
    return {k: found[-1][k] for k in LAYOUT} if found else None
