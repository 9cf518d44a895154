"""Host seconds that the cold full-decode calls took beyond steady ones:
the warm-up calls' sum, less as many times the median decode of the
window. The emit planner plans, rebalances, verifies and captures its
steady state in those calls; whatever part of that work a change makes
faster shows here in proportion."""

import statistics


def read(run):
    cold = run.spans.seconds("cold_decode")
    steady = [s["end"] - s["start"] for s in run.spans.items
              if s["name"] == "decode" and not s.get("traced")]
    if run.entry != "decode" or not cold or not steady:
        return None
    return sum(cold) - len(cold) * statistics.median(steady)
