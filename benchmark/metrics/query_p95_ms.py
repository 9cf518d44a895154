"""The 95th percentile of one batch's latency over every batch of the
window, in ms: host clock from handing the queries over to holding the
lists on the host."""

import numpy as np


def read(run):
    lat = [r["latency"] for r in run.records]
    if run.entry != "query" or not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
