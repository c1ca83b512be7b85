"""Plain ResNet-50 towers over a raw state dict: torchvision's ImageNet
ResNet-50 (He et al. 2016) and OpenAI CLIP's modified ResNet-50 (Radford
et al. 2021), NCHW, ``F.conv2d`` in float32 and nothing else of note.

A tower computes in the precision its configuration states.  ``r`` rounds
each stored activation to that precision (``rounder``: the identity for
float32, a round trip through bfloat16 for a bfloat16 tower), where a
serving tower in that dtype stores one: the input, each conv's output,
the stems' BatchNorm product and sum (applied apart from the conv), the
first block of each stage's bias add and residual sum (library convs in
the dtype), each interior block's two inner activations and its output
(float32 sums and biases, rounded once).  The interior and first blocks
fold frozen BatchNorm into the conv weight and a bias, in float32, before
``q`` rounds the weight.  ``q`` rounds each conv's input and weight: ``r``
itself, or a lower precision for a control (``lowprec.py``).  In float32
every rounding is the identity and the tower is the plain float32 one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.layout import STAGE_BLOCKS

Tensor = torch.Tensor
State = Dict[str, Tensor]


def ident(t: Tensor) -> Tensor:
    return t


def rounder(dtype: str) -> Callable[[Tensor], Tensor]:
    """A float32 tensor rounded to ``dtype`` and back (the identity for
    float32)."""
    if dtype == "float32":
        return ident
    dt = getattr(torch, dtype)
    return lambda t: t.to(dt).to(torch.float32)


def affine(sd: State, key: str, eps: float = 1e-5):
    """A frozen BatchNorm's float32 ``(scale, shift)``."""
    scale = sd[f"{key}.weight"] * torch.rsqrt(sd[f"{key}.running_var"] + eps)
    return scale, sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * scale


def col(t: Tensor) -> Tensor:
    return t.view(1, -1, 1, 1)


def folded(sd: State, conv: str, bn: str):
    """A conv's float32 weight with its frozen BatchNorm folded in, and
    the bias that leaves."""
    scale, shift = affine(sd, bn)
    return sd[f"{conv}.weight"] * scale.view(-1, 1, 1, 1), shift


class Rounding:
    """The rounding points of one tower pass (see the module's doc)."""

    def __init__(self, r: Callable = ident, q: Optional[Callable] = None):
        self.r, self.q = r, (q or r)

    def conv(self, x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
        """A conv of ``q``-rounded input and weight, summed in float32."""
        return F.conv2d(self.q(x), self.q(w), None, stride, w.shape[-1] // 2)

    def stem(self, h: Tensor, sd: State, conv: str, bn: str,
             stride: int) -> Tensor:
        """A stem conv in the dtype, then its BatchNorm as an affine in the
        dtype (product and sum each rounded), then a ReLU."""
        r = self.r
        y = r(self.conv(h, sd[f"{conv}.weight"], stride))
        scale, shift = affine(sd, bn)
        return F.relu(r(r(y * col(r(scale))) + col(r(shift))))

    def first_block(self, h: Tensor, sd: State, k: str, stride: int,
                    pool: bool) -> Tensor:
        """A stage's first block on library convs in the dtype: each conv
        rounded, its bias (rounded) added and the sum rounded; CLIP's
        blocks (``pool``) average-pool where ImageNet's stride."""
        r = self.r

        def conv(x, name, bn, s=1, relu=True):
            w, b = folded(sd, f"{k}.{name}", f"{k}.{bn}")
            y = r(r(self.conv(x, w, s)) + col(r(b)))
            return F.relu(y) if relu else y

        conv_stride = 1 if pool else stride
        y = conv(conv(h, "conv1", "bn1"), "conv2", "bn2", conv_stride)
        if pool and stride > 1:
            y, h = r(F.avg_pool2d(y, stride)), r(F.avg_pool2d(h, stride))
        y = conv(y, "conv3", "bn3", relu=False)
        h = conv(h, "downsample.0", "downsample.1", conv_stride, relu=False)
        return F.relu(r(y + h))

    def interior_block(self, x: Tensor, sd: State, k: str) -> Tensor:
        """A stride-1 block: float32 sums and biases, the two inner
        activations and the output (after the residual) rounded once."""
        r = self.r
        out = x
        for i in (1, 2, 3):
            w, b = folded(sd, f"{k}.conv{i}", f"{k}.bn{i}")
            y = self.conv(out, w) + col(b)
            out = r(F.relu(y if i < 3 else y + x))
        return out


def imagenet_taps(x: Tensor, sd: State, prefix: str = "backbone.",
                  rounding: Rounding = Rounding()) -> Dict[str, Tensor]:
    """NCHW float32 images → the four stage taps ``layer{s}.2.act3``
    (each stage's third block, after its residual ReLU)."""
    p, rd = prefix, rounding
    h = rd.stem(rd.r(x), sd, f"{p}conv1", f"{p}bn1", 2)
    h = F.max_pool2d(h, 3, 2, 1)
    taps = {}
    for s, blocks in enumerate(STAGE_BLOCKS):
        for b in range(blocks):
            k = f"{p}layer{s + 1}.{b}"
            if b == 0:
                h = rd.first_block(h, sd, k, 2 if s > 0 else 1, pool=False)
            else:
                h = rd.interior_block(h, sd, k)
            if b == 2:
                taps[f"layer{s + 1}.2.act3"] = h
    return taps


def clip_taps(x: Tensor, sd: State, prefix: str = "backbone.",
              rounding: Rounding = Rounding()) -> Dict[str, Tensor]:
    """NCHW float32 images → the stem tap (after bn3 and ReLU) and each
    stage's third-block tap ``stages.{s}.2.act``.  CLIP's blocks keep every
    conv at stride 1 and average-pool after the 3x3 conv (and before the
    shortcut's conv); the attention pool is not on the maps' path."""
    p, rd = prefix, rounding
    h = rd.r(x)
    for i in (1, 2, 3):
        h = rd.stem(h, sd, f"{p}conv{i}", f"{p}bn{i}", 2 if i == 1 else 1)
    taps = {"stem.conv3": h}
    h = rd.r(F.avg_pool2d(h, 2))
    for s, blocks in enumerate(STAGE_BLOCKS):
        for b in range(blocks):
            k = f"{p}layer{s + 1}.{b}"
            if b == 0:
                h = rd.first_block(h, sd, k, 2 if s > 0 else 1, pool=True)
            else:
                h = rd.interior_block(h, sd, k)
            if b == 2:
                taps[f"stages.{s}.2.act"] = h
    return taps


def normalize(x_u8: Tensor, mean, std) -> Tensor:
    """NHWC uint8 → NCHW float32, scaled to [0, 1] and normalized."""
    x = x_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)
