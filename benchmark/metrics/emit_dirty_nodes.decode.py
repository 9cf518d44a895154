"""The dirty nodes that the post-pass's fixup resolves in each steady
full decode: `dirty_nodes` of the port's `plan.verify` stage in set-up.
None off the card, or where the program records no such attribute."""

from benchmark import plan_stages


def read(run):
    layout = plan_stages.verified_layout(run)
    return None if layout is None else layout["dirty_nodes"]
