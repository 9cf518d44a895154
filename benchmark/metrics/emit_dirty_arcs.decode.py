"""The share of the graph's arcs that the post-pass's fixup finishes in
each steady full decode: 100 x `dirty_elements` (the verified node
layout's elements) of the port's `plan.verify` stage in set-up, over the
configuration's arcs. None off the card, or where the program records no
such attribute."""

from benchmark import fixup_layout


def read(run):
    layout = fixup_layout.verified(run, ("dirty_elements",))
    if layout is None or not run.arcs:
        return None
    return 100 * layout["dirty_elements"] / run.arcs
