"""Fused stride-1 ResNet bottleneck — the port of srsem/ops/fused_bottleneck.py.

    h1 = relu(x @ W1 + b1)                 # 1x1 conv = channel matmul
    h2 = relu(conv3x3(h1, W2) + b2)        # 9 shifted matmuls
    y  = relu(h2 @ W3 + b3 + x)            # 1x1 conv + residual

with frozen BN folded into the weights (``fold_bn_into_conv``, exact).  The
Hopper kernel (srsem_torch/csrc/fused_bottleneck.cu) computes one output
tile of (image, rows, columns) per thread block with a 1-pixel halo; h1 and
h2 never leave shared memory.  It replaces both TPU kernels:

* ``fused_bottleneck``       ← fused_bottleneck.py::fused_bottleneck
  (``_bottleneck_kernel``): picks the largest tile that fits in shared
  memory;
* ``fused_bottleneck_tiled`` ← fused_bottleneck.py::fused_bottleneck_tiled
  (``_tiled_bottleneck_kernel`` / ``_halo_copy``): honours ``row_tile``.

Each wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch version (``bottleneck_tiles_plain``, the same tile loop with the
same halo and h1 masking, in torch ops) only for a CPU tensor.  Each
counts its kernel launches in its ``launches`` attribute.

The kernel computes in x's dtype (float32 or bfloat16) with float32
accumulation; weights are folded in float32 and cast to x's dtype, biases
stay float32, as the JAX wrapper does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from srsem_torch.ops import _build

Tensor = torch.Tensor
Weights = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]

#: Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Mirrors of fused_bottleneck.cu: channels of padding per h1/h2 row, and the
# GEMM staging: the larger of two cp.async stages of a 128x64 A tile and a
# 64x64 B tile, and three stages of a 64x128 B tile (bf16, rows padded by 8).
_PAD = 8
_STAGING_BYTES = max(2 * (128 * (64 + 8) + 64 * (64 + 8)) * 2,
                     3 * 64 * (128 + 8) * 2)


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
    the kernel's layout: w1 (C, wd), w2 (3, 3, wd, wd) [dy, dx, in, out],
    w3 (wd, C)."""
    w1, b1 = fold_bn_into_conv(block.conv1.weight, block.bn1)
    w2, b2 = fold_bn_into_conv(block.conv2.weight, block.bn2)
    w3, b3 = fold_bn_into_conv(block.conv3.weight, block.bn3)
    return (w1[:, :, 0, 0].t(), b1, w2.permute(2, 3, 1, 0), b2,
            w3[:, :, 0, 0].t(), b3)


def bottleneck_smem_bytes(th: int, tw: int, wd: int, itemsize: int) -> int:
    """Shared memory of one (th, tw) tile — mirrors ``smem_bytes`` in
    fused_bottleneck.cu: h1 and h2 in the halo-grid layout (rows of
    ``tw + 2`` pixels, h2 padded to 32-row warp slabs, h1 = h2's rows plus
    the largest tap offset), rows of ``wd + 8`` channels, plus staging."""
    a128 = lambda b: (b + 127) // 128 * 128  # noqa: E731
    h2_rows = -(-th * (tw + 2) // 32) * 32
    h1_rows = h2_rows + 2 * (tw + 2) + 2
    row = (wd + _PAD) * itemsize
    return a128(h1_rows * row) + a128(h2_rows * row) + _STAGING_BYTES


def _balanced(h: int, th: int) -> int:
    """Rows per tile when ``h`` rows split into tiles of at most ``th``
    rows as evenly as possible (14 rows in two tiles are 7+7, not 13+1)."""
    return -(-h // -(-h // th))


def pick_tile(h: int, w: int, wd: int, itemsize: int,
              row_tile: Optional[int] = None) -> Tuple[int, int]:
    """(th, tw) of an output tile that fits in shared memory.

    With ``row_tile`` the tile has that many rows.  Otherwise it is the
    largest that fits, with the rows balanced across the tiles.  The width
    is split only when full-width rows do not fit."""
    for splits in range(1, w + 1):
        tw = -(-w // splits)
        for th in [min(row_tile, h)] if row_tile else range(h, 0, -1):
            if bottleneck_smem_bytes(th, tw, wd, itemsize) <= SMEM_LIMIT:
                return (th if row_tile else _balanced(h, th)), tw
    raise ValueError(f"no bottleneck tile fits {SMEM_LIMIT} B of shared "
                     f"memory (wd={wd}, itemsize={itemsize})")


def wave_tile(n: int, h: int, w: int, c: int, wd: int, itemsize: int,
              sms: int) -> Tuple[int, int]:
    """The whole-image wrapper's tile for ``n`` images on ``sms`` SMs: of
    the balanced row tiles no taller than ``pick_tile``'s, the one with the
    least modelled time.  The model is waves of blocks (one block per SM,
    since a tile takes most of an SM's shared memory) times one block's
    multiply-adds, conv1's halo rows and the halo-grid columns included.
    Ties go to the taller tile."""
    top, tw = pick_tile(h, w, wd, itemsize)

    def cost(th: int) -> int:
        blocks = n * -(-h // th) * -(-w // tw)
        macs = ((th + 2) * (tw + 2) * c * wd
                + th * (tw + 2) * (9 * wd * wd + wd * c))
        return -(-blocks // sms) * macs

    rows = sorted({_balanced(h, t) for t in range(1, top + 1)}, reverse=True)
    return min(rows, key=cost), tw


def _prepare(x: Tensor, weights) -> Weights:
    """Check x and the weights against what the kernel takes; cast the
    weights to x's dtype and the biases to float32."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    c = x.shape[-1]
    w1, b1, w2, b2, w3, b3 = weights
    wd = w1.shape[-1]
    want = {"w1": (c, wd), "b1": (wd,), "w2": (3, 3, wd, wd), "b2": (wd,),
            "w3": (wd, c), "b3": (c,)}
    for name, t in zip(want, weights):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    cast = lambda t, dt: t.to(dt).contiguous()  # noqa: E731
    return (cast(w1, x.dtype), cast(b1, torch.float32), cast(w2, x.dtype),
            cast(b2, torch.float32), cast(w3, x.dtype), cast(b3, torch.float32))


def bottleneck_tiles_plain(x: Tensor, weights: Weights, th: int,
                           tw: int) -> Tensor:
    """Plain PyTorch version of the kernel: the same (rows, columns) tile
    loop with a 1-pixel halo, h1 zeroed outside the image, float32
    accumulation and rounding to x's dtype between the convs.  Tiles run
    over every image at once.  ``weights`` as ``_prepare`` returns them."""
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


def _launch(x: Tensor, weights: Weights, th: int, tw: int) -> Tensor:
    lib = _build.load("fused_bottleneck")
    fn = lib.srsem_fused_bottleneck
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(),
                 *(t.data_ptr() for t in weights),
                 n, h, w, c, weights[0].shape[1], th, tw,
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA "
                           f"error {err} (tile {th}x{tw}, x {tuple(x.shape)} "
                           f"{x.dtype})")
    return y


def plain_bottleneck(x: Tensor, weights, row_tile: Optional[int] = None
                     ) -> Tensor:
    """The plain version of both wrappers, on any device: the kernel's
    tile (``pick_tile``) through ``bottleneck_tiles_plain``."""
    weights = _prepare(x, weights)
    th, tw = pick_tile(x.shape[1], x.shape[2], weights[0].shape[1],
                       x.element_size(), row_tile)
    return bottleneck_tiles_plain(x, weights, th, tw)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_tile(x: Tensor, wd: int, row_tile: Optional[int]) -> Tuple[int, int]:
    """The tile the kernel launches with on x's card: ``row_tile`` rows
    when given, else ``wave_tile`` for the card's SM count."""
    n, h, w, c = x.shape
    if row_tile:
        return pick_tile(h, w, wd, x.element_size(), row_tile)
    return wave_tile(n, h, w, c, wd, x.element_size(),
                     _sm_count(x.device.index or 0))


def _run(wrapper, x: Tensor, weights, row_tile: Optional[int]) -> Tensor:
    if x.device.type == "cpu":
        return plain_bottleneck(x, weights, row_tile)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_bottleneck kernel for {x.device}")
    weights = _prepare(x, weights)
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused_bottleneck needs 16-byte-aligned tensors")
    th, tw = kernel_tile(x, weights[0].shape[1], row_tile)
    y = _launch(x, weights, th, tw)
    wrapper.launches += 1
    return y


def fused_bottleneck(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                     b2: Tensor, w3: Tensor, b3: Tensor) -> Tensor:
    """Stride-1 bottleneck ``relu(x + f(x))`` on NHWC ``x`` with the
    largest output tile that fits in shared memory."""
    return _run(fused_bottleneck, x, (w1, b1, w2, b2, w3, b3), None)


def fused_bottleneck_tiled(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                           b2: Tensor, w3: Tensor, b3: Tensor,
                           row_tile: int) -> Tensor:
    """``fused_bottleneck`` with ``row_tile`` rows per tile and a 1-row
    halo.  H need not divide by ``row_tile``: the last tile is ragged and
    masked.  Columns are split only when the row tile does not fit."""
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return _run(fused_bottleneck_tiled, x, (w1, b1, w2, b2, w3, b3), row_tile)


fused_bottleneck.launches = 0
fused_bottleneck_tiled.launches = 0
