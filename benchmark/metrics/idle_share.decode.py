"""Share of the traced decode window in which the card ran nothing."""


def read(run):
    tr = run.trace
    if run.entry != "decode" or not tr:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
