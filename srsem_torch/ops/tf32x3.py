"""The 3xTF32 split of float32 operands, the conv kernels' float32 route.

A float32 ``x`` is ``hi + lo + e`` with ``hi = tf32(x)`` and
``lo = tf32(x - hi)``: tf32 keeps 10 of float32's 23 mantissa bits, here
rounded to nearest with ties away from zero (PTX's ``cvt.rna.tf32.f32``,
which csrc/wgmma.cuh::split_tf32 applies to activations in registers), so
``hi``'s 13 low bits are zero, ``x - hi`` is exact and ``|e| <= 2^-22 |x|``.
The tensor cores then sum ``lo.hi + hi.lo + hi.hi`` (csrc/conv_wgmma.cuh).
The weights are split here once, when they are packed (``split_weights``).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def to_tf32(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to tf32 (its 13 low mantissa bits zero), to
    nearest with ties away from zero, as float32.  Finite values only: the
    bits of a NaN may change."""
    if x.dtype != torch.float32:
        raise TypeError(f"to_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def split_tf32(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo): ``hi = tf32(x)``, ``lo = tf32(x - hi)``."""
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def split_weights(w: Tensor) -> Tensor:
    """A float32 K-major (rows, K) weight matrix as the 3xTF32 route takes
    it: one contiguous (2, rows, K) tensor, hi over lo."""
    return torch.stack(split_tf32(w))
