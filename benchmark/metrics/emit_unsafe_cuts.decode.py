"""The share of the verified plan's lanes whose start is not a
reference-safe node, so that the chains it cuts are left to the fixup:
100 x `unsafe_cuts` / `lanes` of the port's `plan.verify` stage in
set-up. None off the card, or where the program records no such
attribute."""

from benchmark import fixup_layout


def read(run):
    layout = fixup_layout.verified(run, ("unsafe_cuts", "lanes"))
    if layout is None or not layout["lanes"]:
        return None
    return 100 * layout["unsafe_cuts"] / layout["lanes"]
