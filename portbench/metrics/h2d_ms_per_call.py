"""Device milliseconds of host-to-device copies per call."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return 1e3 * p.seconds(lambda n: "HtoD" in n) / p.calls
