"""The controls' lower precisions: the nearest step below what a
configuration states, in the program's place.

* a bfloat16 tower → fp8 (e4m3): each conv's input and weight rounded to
  float8_e4m3fn under one per-tensor scale (its largest magnitude maps to
  448, e4m3's largest finite value), then multiplied in float32;
* float32 with TF32 off (heads, decoder) → TF32: the float32 convs and
  matrix products run with TF32 allowed (``tf32()``).

``CONTROLS`` names what each control lowers: ``lower`` (the contract's
control) the tower and the head or decoder, ``head`` the head or decoder
alone (TF32), ``head_bf16`` the head or decoder's convs alone, their
inputs and weights rounded to bfloat16 (a further step down, a reading
beside it).
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference.towers import Rounding, ident, rounder

E4M3_MAX = 448.0

#: control → (lowers the tower, the head or decoder's precision).
CONTROLS = {"lower": (True, "tf32"), "head": (False, "tf32"),
            "head_bf16": (False, "bf16")}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32."""
    amax = t.detach().abs().max().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def tf32():
    """float32 convs and matrix products in TF32 inside the block."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


class Precision:
    """A reference's precision: the configuration's (``control`` None) or
    a control's.  ``tower`` is the tower's ``Rounding``; ``head_ctx`` and
    ``head_q`` the head or decoder's."""

    def __init__(self, tower_dtype: str, control=None):
        if control is not None and control not in CONTROLS:
            raise ValueError(f"no control {control!r}; one of {sorted(CONTROLS)}")
        lower_tower, head = CONTROLS.get(control, (False, None))
        self.tower = Rounding(rounder(tower_dtype), fp8 if lower_tower else None)
        self.head_tf32 = head == "tf32"
        self.head_q = bf16 if head == "bf16" else ident

    def head_ctx(self):
        return tf32() if self.head_tf32 else contextlib.nullcontext()
