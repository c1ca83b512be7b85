"""Fused CLU decoder level — the port of srsem/ops/fused_decoder.py.

    h1 = relu(conv3x3(d, W1d) + conv3x3(u, W1u) + b1)   # split concat-conv
    y  = relu(conv3x3(h1, W2) + b2)                     # 1x1 at level 0

with serving BN folded into the weights
(srsem_torch/models/local_models.py::folded_decoder_weights).  The Hopper
kernel (srsem_torch/csrc/fused_decoder.cu) is an implicit-GEMM conv over
one or two NHWC inputs on wgmma, fed by TMA: a level with a 3x3 conv2 is
two launches of it, conv1 (d, u -> h1, a scratch tensor allocated here)
and conv2 (h1 -> y), so h1 goes through L2 and no halo is recomputed;
level 0's 1x1 head to one channel is one launch whose epilogue forms the
head.  The (d, u) concat is never built.  It replaces both TPU kernels:

* ``fused_decoder_level``       ← fused_decoder.py::fused_decoder_level
  (``_decoder_kernel``);
* ``fused_decoder_level_tiled`` ← fused_decoder.py::fused_decoder_level_tiled
  (``_tiled_decoder_kernel`` / ``_copy_with_halo``).  Its ``row_tile`` is
  the TPU kernel's rows per grid step: on the card the kernel tiles the
  output its own way and the result does not depend on it; on the CPU it
  picks the plain version's row tiles.

What bounds it on the card, and why h1 leaves the chip, is noted at the
top of fused_decoder.cu.

Each wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch version (``decoder_tiles_plain``: the TPU kernels' tile loop, halo
and h1 masking, in torch ops, over full-width tiles) only for a CPU
tensor.  Each counts its calls that launch the kernel in its ``launches``
attribute (one a call, whatever the CUDA launches of the level).  The
kernel's plan (its output patch, its launches, the rows it computes) lives
once, in fused_decoder.cu; the wrapper asks the built library for it.

Layouts are the JAX package's: NHWC activations, (3, 3, Cin, Cout) HWIO
conv kernels, a (Cm, Co) or (1, 1, Cm, Co) 1x1 ``w2``.  The kernel computes
in d's dtype (float32 or bfloat16) with float32 accumulation; weights are
cast to d's dtype and biases to float32, h1 is rounded to d's dtype, and
the output is in d's dtype, as in the JAX kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from srsem_torch.ops import _build
from srsem_torch.ops.fused_bottleneck import _KERNEL_DTYPES

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
    use).  It holds the one copy of the kernel's plan and tensor-core
    rules, which the wrapper asks for."""
    lib = _build.load("fused_decoder")
    lib.srsem_fused_decoder.restype = ctypes.c_int
    lib.srsem_fused_decoder.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    lib.srsem_decoder_uses_tensor_cores.restype = ctypes.c_int
    lib.srsem_decoder_uses_tensor_cores.argtypes = [ctypes.c_int] * 6
    lib.srsem_decoder_plan.restype = ctypes.c_int
    lib.srsem_decoder_plan.argtypes = ([ctypes.c_int] * 9
                                       + [ctypes.POINTER(ctypes.c_int)] * 3
                                       + [ctypes.POINTER(ctypes.c_double)])
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


class Plan(NamedTuple):
    """How the kernel runs a level (fused_decoder.cu's
    ``srsem_decoder_plan``): each 64-row tile of its products is an output
    patch of ``bh`` x ``bw`` pixels; ``launches`` CUDA launches (2: conv1
    into an h1 scratch, then conv2; 1: conv1 with the 1x1 head in its
    epilogue); ``rows_ratio`` = rows the products compute over output
    pixels (>= 1)."""

    bh: int
    bw: int
    launches: int
    rows_ratio: float


def kernel_plan(args: Prepared, final_kernel: int) -> Plan:
    """The plan the kernel launches with for ``kernel_args``' arguments."""
    d = args[0]
    n, h, w, _ = d.shape
    cd, cu, cm, co = _widths(args)
    bh, bw, launches = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ratio = ctypes.c_double()
    err = _kernel().srsem_decoder_plan(
        n, h, w, cd, cu, cm, co, final_kernel, int(d.dtype == torch.bfloat16),
        ctypes.byref(bh), ctypes.byref(bw), ctypes.byref(launches),
        ctypes.byref(ratio))
    if err != 0:
        raise ValueError(f"no decoder plan for d {tuple(d.shape)}, cu {cu}, "
                         f"cm {cm}, co {co}, final_kernel {final_kernel}")
    return Plan(bh.value, bw.value, launches.value, ratio.value)


def _k_major(parts, dtype: torch.dtype) -> Tensor:
    """(K_i, Cout) weight blocks stacked along K, as one contiguous
    (Cout, sum K_i) matrix in ``dtype`` (one copy a block)."""
    cout = parts[0].shape[-1]
    out = torch.empty(cout, sum(p.shape[0] for p in parts), dtype=dtype,
                      device=parts[0].device)
    k = 0
    for p in parts:
        out[:, k:k + p.shape[0]].copy_(p.t())
        k += p.shape[0]
    return out


def _launch(args: Prepared, final_kernel: int, plan: Plan) -> Tensor:
    d, u, w1d, w1u, b1, w2, b2 = args
    n, h, w, cd = d.shape
    _, cu, cm, co = _widths(args)
    dt = d.dtype
    w1t = _k_major([w1d.reshape(-1, cm)]
                   + ([] if w1u is None else [w1u.reshape(-1, cm)]), dt)
    w2t = _k_major([w2.reshape(-1, co)], dt)
    h1 = (torch.empty(n, h, w, cm, dtype=dt, device=d.device)
          if plan.launches == 2 else None)
    y = torch.empty(n, h, w, co, dtype=dt, device=d.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = _kernel().srsem_fused_decoder(
            ptr(d), ptr(u), ptr(w1t), ptr(b1), ptr(w2t), ptr(b2), ptr(h1),
            ptr(y), n, h, w, cd, cu, cm, co, final_kernel,
            int(dt == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder kernel launch failed: CUDA error "
                           f"{err} ({plan}, d {tuple(d.shape)}, cu {cu}, "
                           f"cm {cm}, co {co}, {dt})")
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
    y = _launch(args, final_kernel, kernel_plan(args, final_kernel))
    wrapper.launches += 1
    return y


def fused_decoder_level(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                        w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                        b2: Tensor, final_kernel: int = 3) -> Tensor:
    """One CLU decoder level: ``relu(conv2(relu(conv1(d, u))))`` on NHWC
    ``d`` (skip diff) and ``u`` (upsampled deeper output, or None at the
    deepest level)."""
    return _run(fused_decoder_level, d, u, w1d, w1u, b1, w2, b2,
                final_kernel, None)


def fused_decoder_level_tiled(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                              w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
                              b2: Tensor, row_tile: int,
                              final_kernel: int = 3) -> Tensor:
    """``fused_decoder_level`` for callers of the TPU's row-tiled kernel.
    ``row_tile`` (>= 1; it need not divide H, and ``u`` may be None) is
    that kernel's rows per grid step.  On the card the kernel has no row
    tile and the result does not depend on it; on the CPU the plain
    version runs the TPU kernel's row tiles with their 1- or 2-row halo."""
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return _run(fused_decoder_level_tiled, d, u, w1d, w1u, b1, w2, b2,
                final_kernel, row_tile)


fused_decoder_level.launches = 0
fused_decoder_level_tiled.launches = 0
