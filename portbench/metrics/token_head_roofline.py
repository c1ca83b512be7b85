"""The head kernel's share of its roofline on token taps: the least time
the chip could take for the profiled calls' token head (bytes-bound; the
counts the configuration's model module gives), over the device time of
the operations named ``fused_head``."""

from portbench.common.kernels import roofline


def read(ctx):
    return roofline(ctx, "fused_head")
