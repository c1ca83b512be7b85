"""Fused CLU decoder level — the port of srsem/ops/fused_decoder.py.

    h1 = relu(conv3x3(d, W1d) + conv3x3(u, W1u) + b1)   # split concat-conv
    y  = relu(conv3x3(h1, W2) + b2)                     # 1x1 at level 0

with serving BN folded into the weights
(srsem_torch/models/local_models.py::folded_decoder_weights).  The Hopper
kernel (srsem_torch/csrc/fused_decoder.cu) computes one output tile of
(image, rows, columns) per thread block; the (d, u) concat is never built
and h1 never leaves shared memory.  It replaces both TPU kernels:

* ``fused_decoder_level``       ← fused_decoder.py::fused_decoder_level
  (``_decoder_kernel``): the kernel picks the tile (its ``wave_tile``);
* ``fused_decoder_level_tiled`` ← fused_decoder.py::fused_decoder_level_tiled
  (``_tiled_decoder_kernel`` / ``_copy_with_halo``): honours ``row_tile``.

What bounds it on the card, and what the design does about it, is noted
at the top of fused_decoder.cu: every main-path level is bound by
tensor-core operations, so conv1 is an implicit GEMM straight from global
memory (no im2col, no concat) on mma.sync, and h1 stays on chip.

Each wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch version (``decoder_tiles_plain``: the same tile loop, the same
halo and h1 masking, in torch ops, over full-width tiles) only for a CPU
tensor.  Each counts its kernel launches in its ``launches`` attribute.
The tile and shared-memory rules live once, in fused_decoder.cu; the
wrapper asks the built library for them.

Layouts are the JAX package's: NHWC activations, (3, 3, Cin, Cout) HWIO
conv kernels, a (Cm, Co) or (1, 1, Cm, Co) 1x1 ``w2``.  The kernel computes
in d's dtype (float32 or bfloat16) with float32 accumulation; weights are
cast to d's dtype and biases to float32, h1 is rounded to d's dtype, and
the output is in d's dtype, as in the JAX kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from srsem_torch.ops import _build
from srsem_torch.ops.fused_bottleneck import _KERNEL_DTYPES, _sm_count

Tensor = torch.Tensor
Prepared = Tuple[Tensor, Optional[Tensor], Tensor, Optional[Tensor], Tensor,
                 Tensor, Tensor]


def _prepare(d: Tensor, u: Optional[Tensor], w1d: Tensor,
             w1u: Optional[Tensor], b1: Tensor, w2: Tensor, b2: Tensor,
             final_kernel: int) -> Prepared:
    """Check the inputs against what the kernel takes and bring them to its
    layout: weights in d's dtype as (9, Cin, Cm) and (9, Cm, Co) or
    (Cm, Co), biases float32."""
    if d.dim() != 4:
        raise ValueError(f"d must be (N, H, W, C), got shape {tuple(d.shape)}")
    if d.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"d dtype {d.dtype} not in {_KERNEL_DTYPES}")
    if final_kernel not in (1, 3):
        raise ValueError(f"final_kernel must be 1 or 3, got {final_kernel}")
    if (u is None) != (w1u is None):
        raise ValueError("u and w1u come together (both or neither)")
    n, h, w, cd = d.shape
    cm = w1d.shape[-1]
    co = w2.shape[-1]
    cu = 0 if u is None else u.shape[-1]
    taps = 9 if final_kernel == 3 else 1
    if w2.numel() != taps * cm * co:
        raise ValueError(f"w2 shape {tuple(w2.shape)} is not a "
                         f"{final_kernel}x{final_kernel} conv {cm} -> {co}")
    w2 = w2.reshape(taps, cm, co)
    want = {"w1d": (3, 3, cd, cm), "b1": (cm,), "w2": (taps, cm, co),
            "b2": (co,)}
    got = {"w1d": w1d, "b1": b1, "w2": w2, "b2": b2}
    if u is not None:
        want.update(u=(n, h, w, cu), w1u=(3, 3, cu, cm))
        got.update(u=u, w1u=w1u)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
        if t.device != d.device:
            raise ValueError(f"{name} on {t.device}, d on {d.device}")
    if u is not None and u.dtype != d.dtype:
        raise TypeError(f"u dtype {u.dtype} != d dtype {d.dtype}")
    if not d.is_contiguous() or (u is not None and not u.is_contiguous()):
        raise ValueError("d and u must be contiguous NHWC tensors")
    dt = d.dtype
    if w2.shape[0] == 1:
        w2 = w2[0]
    cast = lambda t, to: t.to(to).contiguous()  # noqa: E731
    return (d, u, cast(w1d.reshape(9, cd, cm), dt),
            None if w1u is None else cast(w1u.reshape(9, cu, cm), dt),
            cast(b1, torch.float32), cast(w2, dt), cast(b2, torch.float32))


def pad_skip(args: Prepared, channels: int) -> Prepared:
    """Zero-pad the skip diff ``d`` to ``channels`` channels, with zero rows
    in w1d: the level's result is exact.  The kernel's tensor cores take
    only multiples of 64 (v2's extra pixel channel makes Cd odd)."""
    d, u, w1d, *rest = args
    pad = channels - d.shape[-1]
    return (F.pad(d, (0, pad)), u, F.pad(w1d, (0, 0, 0, pad)), *rest)


def decoder_tiles_plain(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                        w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                        b2: Tensor, final_kernel: int, th: int,
                        tw: int) -> Tensor:
    """Plain PyTorch version of the kernel: the same (rows, columns) tile
    loop with the inputs' halo (2 pixels for a 3x3 conv2, 1 for 1x1), h1
    zeroed outside the image, float32 accumulation and h1 rounded to d's
    dtype.  Tiles run over every image at once.  Arguments as ``_prepare``
    returns them."""
    n, h, w, _ = d.shape
    dt = d.dtype
    e = 1 if final_kernel == 3 else 0
    p = 1 + e
    cm = w1d.shape[-1]
    co = w2.shape[-1]
    oihw = lambda k: k.float().reshape(3, 3, -1, k.shape[-1]).permute(3, 2, 0, 1)  # noqa: E731
    inputs = [(F.pad(d, (0, 0, p, p, p, p)).permute(0, 3, 1, 2), oihw(w1d))]
    if u is not None:
        inputs.append((F.pad(u, (0, 0, p, p, p, p)).permute(0, 3, 1, 2),
                       oihw(w1u)))
    k2 = oihw(w2) if final_kernel == 3 else w2.float()
    y = torch.empty(n, h, w, co, dtype=dt, device=d.device)
    rows = torch.arange(h + 2 * e, device=d.device) - e
    cols = torch.arange(w + 2 * e, device=d.device) - e
    for r0 in range(0, h, th):
        te = min(th, h - r0)
        for c0 in range(0, w, tw):
            we = min(tw, w - c0)
            acc = sum(F.conv2d(x[:, :, r0:r0 + te + 2 * p,
                                 c0:c0 + we + 2 * p].float(), k)
                      for x, k in inputs)
            h1 = F.relu(acc + b1.view(1, cm, 1, 1))
            r, q = rows[r0:r0 + te + 2 * e], cols[c0:c0 + we + 2 * e]
            inside = (((r >= 0) & (r < h))[:, None]
                      & ((q >= 0) & (q < w))[None, :])
            h1 = torch.where(inside, h1, 0.0).to(dt).float()
            if final_kernel == 3:
                out = F.conv2d(h1, k2).permute(0, 2, 3, 1)
            else:
                out = h1.permute(0, 2, 3, 1) @ k2
            y[:, r0:r0 + te, c0:c0 + we] = F.relu(out + b2).to(dt)
    return y


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """fused_decoder.cu's library with its exports typed (built on first
    use).  It holds the one copy of the kernel's tile, shared-memory and
    tensor-core rules, which the wrapper asks for."""
    lib = _build.load("fused_decoder")
    lib.srsem_fused_decoder.restype = ctypes.c_int
    lib.srsem_fused_decoder.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 11
                                        + [ctypes.c_void_p])
    lib.srsem_decoder_uses_tensor_cores.restype = ctypes.c_int
    lib.srsem_decoder_uses_tensor_cores.argtypes = [ctypes.c_int] * 6
    lib.srsem_decoder_tile.restype = ctypes.c_int
    lib.srsem_decoder_tile.argtypes = ([ctypes.c_int] * 11
                                       + [ctypes.POINTER(ctypes.c_int)] * 2)
    return lib


def _widths(args: Prepared):
    d, u, w1d, _, _, w2, _ = args
    return (d.shape[-1], 0 if u is None else u.shape[-1], w1d.shape[-1],
            w2.shape[-1])


def kernel_args(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                w1u: Optional[Tensor], b1: Tensor, w2: Tensor, b2: Tensor,
                final_kernel: int) -> Prepared:
    """``_prepare``'s arguments as the kernel takes them: a skip diff whose
    channels are not a multiple of 64 is padded (``pad_skip``) when the
    padded widths take the tensor cores."""
    args = _prepare(d, u, w1d, w1u, b1, w2, b2, final_kernel)
    cd, cu, cm, co = _widths(args)
    wide = cd + -cd % 64
    if wide != cd and _kernel().srsem_decoder_uses_tensor_cores(
            int(d.dtype == torch.bfloat16), wide, cu, cm, co, final_kernel):
        args = pad_skip(args, wide)
    return args


def kernel_tile(args: Prepared, final_kernel: int,
                row_tile: Optional[int]) -> Tuple[int, int]:
    """The tile (th, tw) the kernel launches with on d's card, as
    fused_decoder.cu chooses it: ``row_tile`` rows when given, else its
    ``wave_tile`` for the card's SM count.  Raises when nothing fits."""
    d = args[0]
    n, h, w, _ = d.shape
    cd, cu, cm, co = _widths(args)
    th, tw = ctypes.c_int(), ctypes.c_int()
    err = _kernel().srsem_decoder_tile(
        n, h, w, cd, cu, cm, co, final_kernel, int(d.dtype == torch.bfloat16),
        row_tile or 0, _sm_count(d.device.index or 0), ctypes.byref(th),
        ctypes.byref(tw))
    if err != 0:
        raise ValueError(f"no decoder tile fits in shared memory (cm={cm}, "
                         f"{d.dtype})")
    return th.value, tw.value


def _launch(args: Prepared, final_kernel: int, th: int, tw: int) -> Tensor:
    d, u, w1d, w1u, b1, w2, b2 = args
    n, h, w, cd = d.shape
    _, cu, cm, co = _widths(args)
    y = torch.empty(n, h, w, co, dtype=d.dtype, device=d.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = _kernel().srsem_fused_decoder(
            ptr(d), ptr(u), ptr(w1d), ptr(w1u), ptr(b1), ptr(w2), ptr(b2),
            ptr(y), n, h, w, cd, cu, cm, co, final_kernel, th, tw,
            int(d.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder kernel launch failed: CUDA error "
                           f"{err} (tile {th}x{tw}, d {tuple(d.shape)}, "
                           f"cu {cu}, cm {cm}, co {co}, {d.dtype})")
    return y


def plain_decoder_level(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                        w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                        b2: Tensor, final_kernel: int = 3,
                        row_tile: Optional[int] = None) -> Tensor:
    """The plain version of both wrappers, on any device:
    ``decoder_tiles_plain`` over full-width tiles of ``row_tile`` rows, or
    over whole images.  Its result does not depend on the tile, so it is
    the oracle for whatever tile the kernel takes."""
    args = _prepare(d, u, w1d, w1u, b1, w2, b2, final_kernel)
    h, w = d.shape[1:3]
    return decoder_tiles_plain(*args, final_kernel, min(row_tile or h, h), w)


def _run(wrapper, d, u, w1d, w1u, b1, w2, b2, final_kernel,
         row_tile: Optional[int]) -> Tensor:
    if d.device.type == "cpu":
        return plain_decoder_level(d, u, w1d, w1u, b1, w2, b2, final_kernel,
                                   row_tile)
    if d.device.type != "cuda":
        raise ValueError(f"no fused_decoder kernel for {d.device}")
    args = kernel_args(d, u, w1d, w1u, b1, w2, b2, final_kernel)
    if any(t.data_ptr() % 16 for t in args if t is not None):
        raise ValueError("fused_decoder needs 16-byte-aligned tensors")
    th, tw = kernel_tile(args, final_kernel, row_tile)
    y = _launch(args, final_kernel, th, tw)
    wrapper.launches += 1
    return y


def fused_decoder_level(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                        w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                        b2: Tensor, final_kernel: int = 3) -> Tensor:
    """One CLU decoder level: ``relu(conv2(relu(conv1(d, u))))`` on NHWC
    ``d`` (skip diff) and ``u`` (upsampled deeper output, or None at the
    deepest level), with the tile chosen to fill the card."""
    return _run(fused_decoder_level, d, u, w1d, w1u, b1, w2, b2,
                final_kernel, None)


def fused_decoder_level_tiled(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                              w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                              b2: Tensor, row_tile: int,
                              final_kernel: int = 3) -> Tensor:
    """``fused_decoder_level`` with ``row_tile`` rows per tile and the
    inputs' 1- or 2-row halo.  H need not divide by ``row_tile`` (the last
    tile is ragged and masked), and ``u`` may be None; columns are split
    only when the row tile does not fit."""
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return _run(fused_decoder_level_tiled, d, u, w1d, w1u, b1, w2, b2,
                final_kernel, row_tile)


fused_decoder_level.launches = 0
fused_decoder_level_tiled.launches = 0
