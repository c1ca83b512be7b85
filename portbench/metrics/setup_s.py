"""Set-up: seconds from the harness's start to the first timed call
(imports, kernel loads or builds, weights, folding and packing, warm-up,
and in training the checked first steps)."""


def read(ctx):
    return ctx.setup_s
