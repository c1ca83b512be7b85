"""Fused stride-1 ResNet bottleneck — the port of srsem/ops/fused_bottleneck.py.

    h1 = relu(x @ W1 + b1)                 # 1x1 conv = channel matmul
    h2 = relu(conv3x3(h1, W2) + b2)        # 9 shifted matmuls
    y  = relu(h2 @ W3 + b3 + x)            # 1x1 conv + residual

with frozen BN folded into the weights (``fold_bn_into_conv``, exact).  The
Hopper kernel (csrc/fused_bottleneck.cu: three launches of the conv it
shares with the decoder, csrc/conv_wgmma.cuh, with h1 and h2 in a scratch
tensor allocated here) replaces both TPU kernels, ``fused_bottleneck`` and
``fused_bottleneck_tiled``; its plan lives in the .cu (``kernel_plan``).
The wrappers take the JAX weight layout and pack it on every call, or one
``Packed`` made once (``pack_weights``, as ``fold_tower`` does).  Each
launches the kernel for a CUDA tensor, runs the plain version
(``bottleneck_tiles_plain``: the TPU kernels' tile loop, halo and h1
masking) only for a CPU tensor, and counts its calls that launch the
kernel in ``launches``.  Compute is in x's dtype with float32 sums, h1 and
h2 rounded to it, as in the JAX kernels.  float32 runs on the tensor cores
by 3xTF32 (``ops/tf32x3.py``): a float32 ``Packed`` is a ``PackedTF32``,
which also holds each matrix split into tf32 hi and lo.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from srsem_torch.ops import _build
from srsem_torch.ops.tf32x3 import split_weights

Tensor = torch.Tensor
Weights = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def fold_bn_into_conv(weight: Tensor, bn, eps: Optional[float] = None,
                      bias: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Fold a FrozenBatchNorm into the preceding OIHW conv, in float32:
    returns (weight', bias') with ``conv(x, w') + b' == bn(conv(x, w) + b)``
    exactly (the affine commutes with the output channels)."""
    eps = bn.eps if eps is None else eps
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    folded = weight.float() * scale.view(-1, *([1] * (weight.dim() - 1)))
    if bias is not None:
        shift = shift + bias.float() * scale
    return folded, shift


def bottleneck_weights(block) -> Weights:
    """BN-folded float32 (w1, b1, w2, b2, w3, b3) of a stride-1
    ImageNetBottleneck or ClipBottleneck (the same block at stride 1), in
    the JAX package's layout: w1 (C, wd), w2 (3, 3, wd, wd) [dy, dx, in,
    out], w3 (wd, C)."""
    w1, b1 = fold_bn_into_conv(block.conv1.weight, block.bn1)
    w2, b2 = fold_bn_into_conv(block.conv2.weight, block.bn2)
    w3, b3 = fold_bn_into_conv(block.conv3.weight, block.bn3)
    return (w1[:, :, 0, 0].t(), b1, w2.permute(2, 3, 1, 0), b2,
            w3[:, :, 0, 0].t(), b3)


@dataclass(frozen=True)
class Packed:
    """A block's weights as the kernel takes them: K-major w1t (wd, C),
    w2t (wd, 9*wd) with k = (dy*3 + dx)*wd + c, w3t (C, wd) in the compute
    dtype, float32 biases.  Not a tuple: it cannot be star-unpacked into
    JAX-layout arguments by mistake."""

    w1t: Tensor
    b1: Tensor
    w2t: Tensor
    b2: Tensor
    w3t: Tensor
    b3: Tensor


@dataclass(frozen=True)
class PackedTF32(Packed):
    """A float32 ``Packed`` with each matrix also split for the 3xTF32
    route: w1s (2, wd, C), w2s (2, wd, 9*wd), w3s (2, C, wd), tf32 hi over
    lo (``split_weights``)."""

    w1s: Tensor
    w2s: Tensor
    w3s: Tensor


def pack_weights(weights: Weights, dtype: torch.dtype) -> Packed:
    """JAX-layout (w1, b1, w2, b2, w3, b3) in the kernel's layout, cast to
    ``dtype`` (biases float32): one copy each; float32 also splits each
    matrix once (a ``PackedTF32``)."""
    w1, b1, w2, b2, w3, b3 = weights
    wd = w1.shape[-1]
    mat = lambda t: t.to(dtype).contiguous()  # noqa: E731
    vec = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    p = Packed(mat(w1.t()), vec(b1),
               mat(w2.permute(3, 0, 1, 2).reshape(wd, 9 * wd)), vec(b2),
               mat(w3.t()), vec(b3))
    if dtype != torch.float32:
        return p
    return PackedTF32(*vars(p).values(), split_weights(p.w1t),
                      split_weights(p.w2t), split_weights(p.w3t))


def unpack_weights(p: Packed) -> Weights:
    """``Packed`` back in the JAX layout (views, in the packed dtype)."""
    wd = p.w1t.shape[0]
    return (p.w1t.t(), p.b1, p.w2t.reshape(wd, 3, 3, wd).permute(1, 2, 3, 0),
            p.b2, p.w3t.t(), p.b3)


def _prepare(x: Tensor, weights: Union[Weights, Tuple[Packed]]) -> Packed:
    """Check x and the weights against what the kernel takes; pack
    JAX-layout weights in x's dtype."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    c = x.shape[-1]
    if len(weights) == 6:
        wd = weights[0].shape[-1]
        for name, t, want in zip(("w1", "w2", "w3"), weights[::2],
                                 ((c, wd), (3, 3, wd, wd), (wd, c))):
            if tuple(t.shape) != want:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
        weights = (pack_weights(weights, x.dtype),)
    if len(weights) != 1 or not isinstance(weights[0], Packed):
        raise TypeError("weights: (w1, b1, w2, b2, w3, b3) or one Packed")
    p = weights[0]
    if x.dtype == torch.float32 and not isinstance(p, PackedTF32):
        raise TypeError("float32 x needs pack_weights(..., torch.float32)")
    wd = p.w1t.shape[0]
    want = {"w1t": (wd, c), "b1": (wd,), "w2t": (wd, 9 * wd), "b2": (wd,),
            "w3t": (c, wd), "b3": (c,), "w1s": (2, wd, c),
            "w2s": (2, wd, 9 * wd), "w3s": (2, c, wd)}
    for name, t in vars(p).items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        dt = torch.float32 if t.dim() == 1 else x.dtype
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"packed {name} must be contiguous {dt}")
    return p


def bottleneck_tiles_plain(x: Tensor, weights: Weights, th: int,
                           tw: int) -> Tensor:
    """Plain PyTorch version of the TPU kernels: a (rows, columns) tile loop
    over all images with a 1-pixel halo, h1 zeroed outside the image, float32
    sums, rounding to x's dtype between the convs (the result does not
    depend on the tile).  ``weights`` in the JAX layout."""
    n, h, w, c = x.shape
    dt = x.dtype
    w1, b1, w2, b2, w3, b3 = (t.float() for t in weights)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # zero halo around the image
    y = torch.empty_like(x)
    rows = torch.arange(h + 2, device=x.device) - 1
    cols = torch.arange(w + 2, device=x.device) - 1
    for r0 in range(0, h, th):
        te = min(th, h - r0)
        for c0 in range(0, w, tw):
            we = min(tw, w - c0)
            halo = xp[:, r0:r0 + te + 2, c0:c0 + we + 2].float()
            h1 = F.relu(halo @ w1 + b1)
            r, q = rows[r0:r0 + te + 2], cols[c0:c0 + we + 2]
            inside = (((r >= 0) & (r < h))[:, None]
                      & ((q >= 0) & (q < w))[None, :])
            h1 = torch.where(inside[None, :, :, None], h1, 0.0).to(dt).float()
            acc = sum(h1[:, dy:dy + te, dx:dx + we] @ w2[dy, dx]
                      for dy in range(3) for dx in range(3))
            h2 = F.relu(acc + b2).to(dt).float()
            res = x[:, r0:r0 + te, c0:c0 + we].float()
            y[:, r0:r0 + te, c0:c0 + we] = F.relu(h2 @ w3 + b3 + res).to(dt)
    return y


def plain_bottleneck(x: Tensor, weights, row_tile: Optional[int] = None
                     ) -> Tensor:
    """The plain version of both wrappers, on any device:
    ``bottleneck_tiles_plain`` over full-width tiles of ``row_tile`` rows,
    or over whole images.  ``weights``: the wrappers' weight arguments, as
    a tuple."""
    h = x.shape[1]
    return bottleneck_tiles_plain(x, unpack_weights(_prepare(x, weights)),
                                  min(row_tile or h, h), x.shape[2])


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """fused_bottleneck.cu's library with its exports typed (built on first
    use).  It holds the one copy of the kernel's plan."""
    lib = _build.load("fused_bottleneck")
    lib.srsem_fused_bottleneck.restype = ctypes.c_int
    lib.srsem_fused_bottleneck.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.srsem_bottleneck_uses_tensor_cores.restype = ctypes.c_int
    lib.srsem_bottleneck_uses_tensor_cores.argtypes = [ctypes.c_int] * 3
    lib.srsem_bottleneck_plan.restype = ctypes.c_int
    lib.srsem_bottleneck_plan.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double)])
    return lib


# What fused_bottleneck.cu's and fused_decoder.cu's predicates return.
ROUTES = ("fma", "wgmma_bf16", "wgmma_tf32x3")


class Plan(NamedTuple):
    """fused_bottleneck.cu's ``srsem_bottleneck_plan``: ``launches`` CUDA
    launches, and per conv (1, 2, 3) its ``tilings`` ("flat": 64-row tiles
    of the pixel matrix; "BHxBW": patches), ``nts`` (output channels a
    block), ``blocks`` and ``rows_ratio`` (rows computed over pixels);
    ``route``, one of ``ROUTES``: the bf16 or float32 (3xTF32) wgmma conv,
    or the FMA conv (widths it does not take)."""

    launches: int
    tilings: Tuple[str, ...]
    nts: Tuple[int, ...]
    blocks: Tuple[int, ...]
    rows_ratio: Tuple[float, ...]
    route: str


def _route(x: Tensor, wd: int) -> str:
    return ROUTES[_kernel().srsem_bottleneck_uses_tensor_cores(
        int(x.dtype == torch.bfloat16), x.shape[-1], wd)]


def kernel_plan(x: Tensor, wd: int, sms: int = 0) -> Plan:
    """The plan the kernel launches with for ``x`` and width ``wd`` on
    ``sms`` SMs (0: the current card's)."""
    launches = ctypes.c_int()
    flat, bh, bw, nt = ((ctypes.c_int * 3)() for _ in range(4))
    blocks, ratio = (ctypes.c_longlong * 3)(), (ctypes.c_double * 3)()
    if _kernel().srsem_bottleneck_plan(
            *x.shape, wd, int(x.dtype == torch.bfloat16), sms,
            ctypes.byref(launches), flat, bh, bw, nt, blocks, ratio):
        raise ValueError(f"no bottleneck plan for x {tuple(x.shape)}, wd {wd}")
    return Plan(launches.value, tuple("flat" if flat[i] else f"{bh[i]}x{bw[i]}"
                                      for i in range(3)),
                tuple(nt), tuple(blocks), tuple(ratio), _route(x, wd))


def _launch(x: Tensor, p: Packed) -> Tensor:
    n, h, w, c = x.shape
    wd = p.w1t.shape[0]
    scratch = torch.empty(2, n, h, w, wd, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    # The 3xTF32 route takes each matrix split, hi rows over lo rows.
    w1, w2, w3 = ((p.w1s, p.w2s, p.w3s) if _route(x, wd) == "wgmma_tf32x3"
                  else (p.w1t, p.w2t, p.w3t))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel().srsem_fused_bottleneck(
            x.data_ptr(), w1.data_ptr(), p.b1.data_ptr(), w2.data_ptr(),
            p.b2.data_ptr(), w3.data_ptr(), p.b3.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), y.data_ptr(),
            n, h, w, c, wd, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)} {x.dtype}, "
                           f"wd {wd})")
    return y


def _run(wrapper, x: Tensor, weights, row_tile: Optional[int]) -> Tensor:
    if x.device.type == "cpu":
        return plain_bottleneck(x, weights, row_tile)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_bottleneck kernel for {x.device}")
    p = _prepare(x, weights)
    if any(t.data_ptr() % 16 for t in (x, *vars(p).values())):
        raise ValueError("fused_bottleneck needs 16-byte-aligned tensors")
    y = _launch(x, p)
    wrapper.launches += 1
    return y


def fused_bottleneck(x: Tensor, *weights) -> Tensor:
    """Stride-1 bottleneck ``relu(x + f(x))`` on NHWC ``x``; ``weights``
    is (w1, b1, w2, b2, w3, b3) in the JAX layout, or one ``Packed``."""
    return _run(fused_bottleneck, x, weights, None)


def fused_bottleneck_tiled(x: Tensor, *weights, row_tile: int) -> Tensor:
    """``fused_bottleneck`` for callers of the TPU's row-tiled kernel:
    ``row_tile`` (>= 1; it need not divide H) is its rows per grid step,
    which the CPU's plain version runs and the card's kernel ignores."""
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return _run(fused_bottleneck_tiled, x, weights, row_tile)


fused_bottleneck.launches = 0
fused_bottleneck_tiled.launches = 0
