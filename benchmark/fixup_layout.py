"""The fixup's work in the layout the port's emit planner verified: the
attributes a reader asks for of the newest `plan.verify` stage
(webgraph_ans_torch.utils.trace) that started inside the warm-up
decodes and carries them all, and the bytes that layout's fixup needs.

The bytes are counted from the layout, never from how the program runs
the fixup: each dirty node's row of the node table (five int32) read
once, and for each of its elements its source read, its value gathered
and its sorted value written, 4 B each. So any fixup of the same layout
is held to the same work.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

NODE_BYTES = 20
ELEMENT_BYTES = 12


def verified(run, keys) -> dict | None:
    """{key: value} for `keys` from the newest `plan.verify` stage of the
    run's warm-up that has every one of them. None off the card, on
    another entry, or where the program records no such stage or
    attributes."""
    if run.entry != "decode" or run.peak_bytes is None:
        return None
    try:
        from webgraph_ans_torch.utils import trace
    except ImportError:
        return None
    cold = [(s["start"], s["end"]) for s in run.spans.items
            if s["name"] == "cold_decode"]
    found = [st.attrs for st in trace.stages() if st.name == "plan.verify"
             and all(k in st.attrs for k in keys)
             and any(lo <= st.start * 1e-9 <= hi for lo, hi in cold)]
    return {k: found[-1][k] for k in keys} if found else None


def fixup_bytes(dirty_nodes: int, dirty_elements: int) -> int:
    """Bytes the fixup of a layout must move: its node table once, and
    each element's source, gathered value and write."""
    return NODE_BYTES * int(dirty_nodes) + ELEMENT_BYTES * int(dirty_elements)


def fixup_seconds(dirty_nodes: int, dirty_elements: int) -> float:
    """The least time of that fixup on the card: its bytes over HBM's
    peak rate."""
    return fixup_bytes(dirty_nodes, dirty_elements) / HBM_BYTES_PER_S
