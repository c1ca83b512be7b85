"""The bottleneck kernel's share of its roofline: the least time the chip
could take for the stride-1 bottleneck blocks of the profiled calls (the
counts the configuration's model module gives, ``common/kernels.py``),
over the device time of the operations named ``fused_bottleneck``."""

from portbench.common.kernels import roofline


def read(ctx):
    return roofline(ctx, "fused_bottleneck")
