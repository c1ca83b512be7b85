"""The allocator's peak over the window (``max_memory_allocated`` after a
reset at the window's start), GiB."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30
