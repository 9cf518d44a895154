"""The share of the verified plan's lanes that hold no node (a lane
bound snapped onto the one before it): 100 x `empty_lanes` / `lanes` of
the port's `plan.verify` stage in set-up. None off the card, or where
the program records no such attribute."""

from benchmark import plan_stages


def read(run):
    layout = plan_stages.verified_layout(run)
    if layout is None or not layout["lanes"]:
        return None
    return 100 * layout["empty_lanes"] / layout["lanes"]
