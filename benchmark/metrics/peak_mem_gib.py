"""peak_mem_gib: torch.cuda.max_memory_allocated over the window (reset at
its start), frames in flight included, in GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
