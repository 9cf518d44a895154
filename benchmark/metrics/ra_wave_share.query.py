"""Share of the window's unique queries that the per-query lanes left to
the wave decode (the port's `last_unclean` over each batch's unique
queries)."""


def read(run):
    if run.entry != "query" or not run.records:
        return None
    uniq = sum(r["unique"] for r in run.records)
    return 100 * sum(r["unclean"] for r in run.records) / uniq
