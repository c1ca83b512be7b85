"""Operations and bytes of one call of each hand-written kernel, from the
shapes a model module gives (``models/<model>.py::kernel_work``): the
yardstick of the ``<kernel>_roofline`` metrics.  Each input byte is read
once and each output byte written once; a multiply-add is two
operations.  A work item is ``(operations, bytes, dtype)``, and its bound
the larger of the operations over the dtype's peak and the bytes over
HBM's (``peaks.bound_s``)."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from portbench.common.peaks import BYTES, bound_s

Work = Tuple[float, float, str]


def bottleneck(n: int, h: int, c: int, w: int, dtype: str) -> Work:
    """A stride-1 bottleneck block over ``n`` images of ``h`` x ``h``
    pixels and ``c`` channels, width ``w``: three convs (1x1 c -> w, 3x3
    w -> w, 1x1 w -> c); input, output and weights in ``dtype``."""
    pixels = n * h * h
    weights = c * w + 9 * w * w + w * c
    return 2 * pixels * weights, BYTES[dtype] * (2 * pixels * c + weights), dtype


def decoder_level(n: int, h: int, cd: int, cu: int, mid: int, out: int,
                  k: int, dtype: str) -> Work:
    """A CLU decoder level over ``n`` pairs at ``h`` x ``h``: conv1 3x3
    over [skip diff (``cd``), upsampled (``cu``)] to ``mid``, conv2 ``k``
    x ``k`` to ``out``; its two inputs, its output and its weights in
    ``dtype``."""
    pixels = n * h * h
    weights = 9 * (cd + cu) * mid + k * k * mid * out + mid + out
    ops = 2 * pixels * (9 * (cd + cu) * mid + k * k * mid * out)
    return ops, BYTES[dtype] * (pixels * (cd + cu + out) + weights), dtype


def stages_head(passes: Sequence[int], pairs: int,
                taps: Iterable[Tuple[int, int]], tap_dtype: str) -> Work:
    """The stages head over the taps (``(h, c)`` each) of ``passes`` tower
    passes and ``pairs`` scored pairs: every tapped feature read once in
    ``tap_dtype``, float32 weights read once, the scores written once; a
    subtraction, a square and a multiply-add an element, float32 work."""
    taps = list(taps)
    per_image = sum(h * h * c for h, c in taps)
    weights = sum(c + 1 for _, c in taps)
    nbytes = (BYTES[tap_dtype] * per_image * sum(passes)
              + 4 * weights + 4 * pairs)
    return 4 * per_image * pairs, nbytes, "float32"


def resnet50_blocks(passes: Sequence[int], image: int, blocks: Sequence[int],
                    channels: Sequence[int], dtype: str) -> List[Work]:
    """The stride-1 blocks (each stage's but its first) of ResNet-50
    passes over ``passes`` images each: stage ``s`` at ``image / 4 / 2**s``
    pixels a side, ``channels[s]`` channels, width a quarter of them."""
    out = []
    for n in passes:
        for s, (count, c) in enumerate(zip(blocks, channels)):
            out += [bottleneck(n, image // 4 // 2 ** s, c, c // 4, dtype)] * (
                count - 1)
    return out


def roofline(ctx, kernel: str):
    """A kernel's share of its roofline in the profiled calls: the bound
    of the work the driver counts for ``kernel`` (a name its device
    operations contain), over their device time; None where the trace
    holds no such operation."""
    p = ctx.profile
    if p is None:
        return None
    spent = p.seconds(lambda name: kernel in name)
    work = ctx.driver.kernel_work().get(kernel)
    if spent <= 0 or not work:
        return None
    return 100.0 * sum(bound_s(*w) for w in work) * p.calls / spent
