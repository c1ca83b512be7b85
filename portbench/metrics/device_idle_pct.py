"""Share of the profiled wall time in which no device operation runs (the
union of the device intervals)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)
