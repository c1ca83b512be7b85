"""The whole step's share of the chip's peak: the model FLOPs of the
window's calls (counted once from the plain reference's layers at the
cell's shapes, each part at the peak of the dtype the configuration
states) over the window's seconds."""

from portbench.common.peaks import FLOPS


def read(ctx):
    if ctx.profile is None:
        return None
    at_peak = sum(f / FLOPS[dtype]
                  for dtype, f in ctx.driver.flops_per_call().items())
    return 100.0 * at_peak * ctx.calls / ctx.window_s
