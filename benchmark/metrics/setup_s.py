"""Seconds from the process's start to the first timed operation:
imports, the data cache (made on a checkout's first run), loading,
kernel builds and every warm-up call."""


def read(run):
    return run.setup_s
