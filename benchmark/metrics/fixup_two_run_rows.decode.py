"""The share of the dirty nodes whose rows take the fixup kernel's two-run
step in each steady full decode: 100 x `two_run_rows` over `dirty_nodes`
of the port's `plan.verify` stage in set-up (benchmark/fixup_layout.py).
None off the card, where the layout has no dirty node, or where the
program records no such attribute."""

from benchmark import fixup_layout


def read(run):
    layout = fixup_layout.verified(run, ("two_run_rows", "dirty_nodes"))
    if layout is None or not layout["dirty_nodes"]:
        return None
    return 100 * layout["two_run_rows"] / layout["dirty_nodes"]
