"""The lanes that hold a node for each encode block of a block-parallel
artifact in the verified plan: (`lanes` - `empty_lanes`) /
`encode_blocks` of the port's `plan.verify` stage in set-up. None off
the card, where the program records no such attribute, or on a serial
artifact (`encode_blocks` 0)."""

from benchmark import fixup_layout


def read(run):
    layout = fixup_layout.verified(run, ("encode_blocks", "lanes",
                                         "empty_lanes"))
    if layout is None or not layout["encode_blocks"]:
        return None
    return (layout["lanes"] - layout["empty_lanes"]) / layout["encode_blocks"]
