"""Pairs completed in the window over the window's seconds: a scored pair
once its score or map is on the host, a trained pair once its step has
ended (the window ends in a synchronize)."""


def read(ctx):
    return ctx.items / ctx.window_s
