"""Mean rounds of lanes a batch (the port's `last_rounds` after each
batch of the window): a count."""


def read(run):
    if run.entry != "query" or not run.records:
        return None
    return sum(r["rounds"] for r in run.records) / len(run.records)
