"""The most memory the allocator held on the device during the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``), GB."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
