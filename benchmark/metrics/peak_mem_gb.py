"""Peak device memory of the run in GB (1e9 B):
torch.cuda.max_memory_allocated() after reset_peak_memory_stats() at
the start of set-up, read when the window closes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
