"""The share of the merged-emit kernel's rows that it writes by run
folding (a tight loop in place of a full step, while the lane's decode
side is idle and no queue moves) in each steady full decode: 100 x
`fold_rows` over all lanes' rows (`rows_mean` x `lanes`) of the port's
`plan.verify` stage in set-up (benchmark/fixup_layout.py). None off the
card, or where the program records no such attribute."""

from benchmark import fixup_layout


def read(run):
    layout = fixup_layout.verified(run, ("fold_rows", "rows_mean", "lanes"))
    if layout is None or not layout["rows_mean"] or not layout["lanes"]:
        return None
    return 100 * layout["fold_rows"] / (layout["rows_mean"] * layout["lanes"])
