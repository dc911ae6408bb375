"""peak_mem_gb (GB, lower is better; host clock of the allocator):
torch.cuda.max_memory_allocated() over the window, the peak reset after
set-up, in 1e9 bytes.  What still fits on the card beside the solver, and
work moved into caches."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 1e9
