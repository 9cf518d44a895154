"""Bits a link of the stored artifact: 8 x the `.ans` file's bytes over
the configuration's arcs."""


def read(run):
    return 8 * run.ans_bytes / run.arcs if run.arcs else None
