"""Device milliseconds per call of the plain elementwise work (normalize,
casts, diffs, upsampling, pooling): every device operation the kernel
groups leave over."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return p.group_ms_per_call("other (elementwise, pooling, casts)")
