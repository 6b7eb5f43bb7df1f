"""peak_device_gb: torch.cuda.max_memory_allocated() over the window,
reset at its start, in GB (1e9 bytes)."""


def read(ctx):
    if ctx.peak_window_bytes <= 0:
        return None
    return ctx.peak_window_bytes / 1e9
