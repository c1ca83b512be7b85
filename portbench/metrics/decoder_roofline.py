"""The decoder kernel's share of its roofline: the least time the chip
could take for the decoder levels the kernel runs in the profiled calls
(the counts the configuration's model module gives, float32 work held to
the TF32 peak, ``common/kernels.py``), over the device time of the
operations named ``fused_decoder``."""

from portbench.common.kernels import roofline


def read(ctx):
    return roofline(ctx, "fused_decoder")
