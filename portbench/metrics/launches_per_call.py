"""Device operations (kernels, copies, sets) per call or training step in
the profiled calls: the host's launch work scales with it."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return len(p.ops) / p.calls
