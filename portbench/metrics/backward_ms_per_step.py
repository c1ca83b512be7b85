"""Device milliseconds per training step of the backward group (data and
weight gradients of the convolutions, other operations named backward)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return p.group_ms_per_call("cudnn conv backward and other backward")
