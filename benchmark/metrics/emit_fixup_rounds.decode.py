"""The fixup rounds of each steady full decode: the dirty-chain depth of
the layout the port's planner verified in set-up (`fixup_rounds` of its
`plan.verify` stage). None off the card, or where the program records
no such attribute."""

from benchmark import plan_stages


def read(run):
    layout = plan_stages.verified_layout(run)
    return None if layout is None else layout["fixup_rounds"]
