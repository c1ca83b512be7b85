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
kernel's plan (its output patch or flat tiles, its launches, the rows it
computes) lives once, in fused_decoder.cu; the wrapper asks the built
library for it.

The wrappers take the JAX package's layouts: NHWC activations, (3, 3,
Cin, Cout) HWIO conv kernels, a (Cm, Co) or (1, 1, Cm, Co) 1x1 ``w2``; and
they pack them on every call.  Or they take one ``PackedLevel``, the
weights in the kernel's layout packed once (``pack_level``;
``local_models.py::fold_decoder`` packs every level of a serving
decoder, ``fused_serving_decode`` passes them through).  The kernel
computes in d's dtype (float32 or bfloat16) with float32 accumulation;
weights are cast to d's dtype and biases to float32, h1 is rounded to d's
dtype, and the output is in d's dtype, as in the JAX kernel.  float32 runs
on the tensor cores by 3xTF32 (``ops/tf32x3.py``), its conv weights split
into tf32 hi and lo where they are packed.  The tensor cores take channel
widths in multiples of 64 (bf16) or 32 (float32); a skip diff whose width
is not one (v2's pixel channel makes Cd odd) is zero-padded to the next
one, with zero rows in w1d, which leaves the level's result exact
(``skip_width``; ``fused_serving_decode`` writes its skips at that width
once a level).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from srsem_torch.ops import _build
from srsem_torch.ops.fused_bottleneck import _KERNEL_DTYPES, ROUTES
from srsem_torch.ops.tf32x3 import split_weights

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


def tensor_core_widths(dtype: torch.dtype, cd: int, cu: int, cm: int,
                       co: int, final_kernel: int) -> bool:
    """Whether a level of these widths runs on the tensor cores: every
    width a multiple of 64 (bf16) or 32 (float32), and a 1x1 head's Cm one
    N tile.  The same rule as ``route()`` in csrc/fused_decoder.cu, kept
    here so that the padding below needs no built library (the CPU path
    pads as the card does); change the two together."""
    if dtype not in _KERNEL_DTYPES:
        return False
    bf16 = dtype == torch.bfloat16
    q = 64 if bf16 else 32
    heads = (64, 128, 256) if bf16 else (32, 64, 128)
    return not (cd % q or cu % q or cm % q
                or (co % q if final_kernel == 3 else cm not in heads))


def skip_width(dtype: torch.dtype, cd: int, cu: int, cm: int, co: int,
               final_kernel: int) -> int:
    """The skip width the kernel takes for a ``cd``-channel skip diff:
    ``cd`` rounded up to a multiple of 64 (bf16) or 32 (float32) where that
    puts the level on the tensor cores (``tensor_core_widths``), else
    ``cd``."""
    wide = cd + -cd % (64 if dtype == torch.bfloat16 else 32)
    return (wide if tensor_core_widths(dtype, wide, cu, cm, co, final_kernel)
            else cd)


def pad_skip(args: Prepared, channels: int) -> Prepared:
    """Zero-pad the skip diff ``d`` to ``channels`` channels, with zero rows
    in w1d: the level's result is exact."""
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
                                       + [ctypes.POINTER(ctypes.c_int)] * 5
                                       + [ctypes.POINTER(ctypes.c_double)])
    return lib


def _widths(args: Prepared):
    d, u, w1d, _, _, w2, _ = args
    return (d.shape[-1], 0 if u is None else u.shape[-1], w1d.shape[-1],
            w2.shape[-1])


def kernel_args(d: Tensor, u: Optional[Tensor], w1d: Tensor,
                w1u: Optional[Tensor], b1: Tensor, w2: Tensor, b2: Tensor,
                final_kernel: int) -> Prepared:
    """``_prepare``'s arguments as the kernel takes them: the skip diff
    padded to ``skip_width`` (``pad_skip``; nothing to do where it comes at
    that width)."""
    args = _prepare(d, u, w1d, w1u, b1, w2, b2, final_kernel)
    cd, cu, cm, co = _widths(args)
    wide = skip_width(d.dtype, cd, cu, cm, co, final_kernel)
    return pad_skip(args, wide) if wide != cd else args


def _route(dtype: torch.dtype, widths, final_kernel: int) -> str:
    """The route (``ROUTES``) fused_decoder.cu takes for these widths."""
    return ROUTES[_kernel().srsem_decoder_uses_tensor_cores(
        int(dtype == torch.bfloat16), *widths, final_kernel)]


class Plan(NamedTuple):
    """How the kernel runs a level (fused_decoder.cu's
    ``srsem_decoder_plan``): ``launches`` CUDA launches (2: conv1 into an
    h1 scratch, then conv2; 1: conv1 with the 1x1 head in its epilogue);
    each launch's M tiles in ``tilings``: "flat" (64 flat pixel rows, TMA
    im2col boxes) or "BHxBW" (output patches of ``bh`` x ``bw`` pixels);
    ``rows_ratio`` = rows the products compute over output pixels (>= 1);
    ``route``, one of ``ROUTES``; ``nts``, the output channels a
    tensor-core block of each launch computes (0: the FMA conv, or no
    second launch)."""

    bh: int
    bw: int
    launches: int
    rows_ratio: float
    route: str
    nts: Tuple[int, int]
    tilings: Tuple[str, ...]


def _plan(d: Tensor, widths, final_kernel: int) -> Plan:
    n, h, w, _ = d.shape
    cd, cu, cm, co = widths
    bh, bw, launches = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    flat, nt = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    ratio = ctypes.c_double()
    err = _kernel().srsem_decoder_plan(
        n, h, w, cd, cu, cm, co, final_kernel, int(d.dtype == torch.bfloat16),
        ctypes.byref(bh), ctypes.byref(bw), ctypes.byref(launches), flat, nt,
        ctypes.byref(ratio))
    if err != 0:
        raise ValueError(f"no decoder plan for d {tuple(d.shape)}, cu {cu}, "
                         f"cm {cm}, co {co}, final_kernel {final_kernel}")
    return Plan(bh.value, bw.value, launches.value, ratio.value,
                _route(d.dtype, widths, final_kernel), tuple(nt),
                tuple("flat" if flat[i] else f"{bh.value}x{bw.value}"
                      for i in range(launches.value)))


def kernel_plan(args: Prepared, final_kernel: int) -> Plan:
    """The plan the kernel launches with for ``kernel_args``' arguments on
    the current card."""
    return _plan(args[0], _widths(args), final_kernel)


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


@dataclass(frozen=True)
class PackedLevel:
    """A level's weights as the kernel takes them, packed once
    (``pack_level``): K-major ``w1t`` (Cm, 9*Cd + 9*Cu), k = (dy*3 + dx)*C
    + c over d, then u; ``w2t`` (Co, 9*Cm), or (Co, Cm) for the 1x1 head;
    in the compute dtype, float32 biases.  Where the level takes the
    3xTF32 route, w1t and a 3x3 w2t are their (2, rows, K) split, tf32 hi
    over lo (``split_weights``), and nothing else is kept: the kernel
    reads only those.  ``cd`` is the skip width the kernel takes
    (``skip_width``), ``cu`` 0 at the deepest level.  Not a tuple: it
    cannot be star-unpacked into JAX-layout arguments by mistake."""

    w1t: Tensor
    b1: Tensor
    w2t: Tensor
    b2: Tensor
    cd: int
    cu: int
    final_kernel: int

    @property
    def widths(self) -> Tuple[int, int, int, int]:
        """(Cd, Cu, Cm, Co)."""
        return self.cd, self.cu, self.w1t.shape[-2], self.w2t.shape[-2]

    @property
    def split(self) -> bool:
        """Whether the matrices hold the 3xTF32 split."""
        return self.w1t.dim() == 3


def pack_level(w1d: Tensor, w1u: Optional[Tensor], b1: Tensor, w2: Tensor,
               b2: Tensor, final_kernel: int,
               dtype: torch.dtype) -> PackedLevel:
    """A level's JAX-layout weights (w1d (3, 3, Cd, Cm), w1u (3, 3, Cu,
    Cm) or None, w2 (3, 3, Cm, Co) or a 1x1 (Cm, Co); taps flattened to 9
    also taken) as the kernel takes them for activations of ``dtype``:
    w1d's rows zero-padded to ``skip_width``, each matrix cast and laid
    out K-major in one copy, float32 biases, and the 3xTF32 split where a
    float32 level's widths take the tensor cores."""
    cd, cm = w1d.shape[-2:]
    cu = 0 if w1u is None else w1u.shape[-2]
    co = w2.shape[-1]
    if w2.numel() != (9 if final_kernel == 3 else 1) * cm * co:
        raise ValueError(f"w2 shape {tuple(w2.shape)} is not a "
                         f"{final_kernel}x{final_kernel} conv {cm} -> {co}")
    wide = skip_width(dtype, cd, cu, cm, co, final_kernel)
    w1d = F.pad(w1d.reshape(9, cd, cm), (0, 0, 0, wide - cd))
    w1t = _k_major([w1d.reshape(-1, cm)]
                   + ([] if w1u is None else [w1u.reshape(-1, cm)]), dtype)
    w2t = _k_major([w2.reshape(-1, co)], dtype)
    if dtype == torch.float32 and tensor_core_widths(dtype, wide, cu, cm, co,
                                                     final_kernel):
        w1t = split_weights(w1t)
        if final_kernel == 3:  # the head's w2t is read unsplit
            w2t = split_weights(w2t)
    vec = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    return PackedLevel(w1t, vec(b1), w2t, vec(b2), wide, cu, final_kernel)


def unpack_level(p: PackedLevel):
    """A ``PackedLevel``'s weights as ``_prepare`` returns them: w1d (9,
    Cd, Cm), w1u (9, Cu, Cm) or None, b1, w2 (9, Cm, Co) or (Cm, Co), b2;
    views, except that a split matrix is its hi + lo, in float32 exactly
    (22 significant bits of the packed weight)."""
    cd, cu, cm, co = p.widths
    join = lambda t: t[0] + t[1] if t.dim() == 3 else t  # noqa: E731
    w1, w2 = join(p.w1t).t(), join(p.w2t).t()
    return (w1[:9 * cd].reshape(9, cd, cm),
            w1[9 * cd:].reshape(9, cu, cm) if cu else None, p.b1,
            w2.reshape(9, cm, co) if p.final_kernel == 3 else w2, p.b2)


def _check_packed(d: Tensor, u: Optional[Tensor], p: PackedLevel,
                  final_kernel: int) -> None:
    """Check d and u against a ``PackedLevel``: the kernel's shapes, its
    dtype and device, and the skip at the packed width."""
    if d.dim() != 4:
        raise ValueError(f"d must be (N, H, W, C), got shape {tuple(d.shape)}")
    if d.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"d dtype {d.dtype} not in {_KERNEL_DTYPES}")
    if final_kernel != p.final_kernel:
        raise ValueError(f"final_kernel {final_kernel}, the level was "
                         f"packed for {p.final_kernel}")
    cd, cu, _, _ = p.widths
    if d.shape[-1] != cd:
        raise ValueError(f"d has {d.shape[-1]} channels; the packed level "
                         f"takes the skip at {cd} (skip_width)")
    if (u is None) != (cu == 0) or (
            u is not None and tuple(u.shape) != (*d.shape[:3], cu)):
        raise ValueError(f"u shape {None if u is None else tuple(u.shape)}, "
                         f"the packed level takes Cu = {cu}")
    if u is not None and u.dtype != d.dtype:
        raise TypeError(f"u dtype {u.dtype} != d dtype {d.dtype}")
    if not d.is_contiguous() or (u is not None and not u.is_contiguous()):
        raise ValueError("d and u must be contiguous NHWC tensors")
    for name, t in vars(p).items():
        if isinstance(t, Tensor):
            dt = torch.float32 if t.dim() == 1 else d.dtype
            if t.device != d.device or t.dtype != dt:
                raise TypeError(f"packed {name} is {t.dtype} on {t.device}; "
                                f"d is {d.dtype} on {d.device}")


def _launch(d: Tensor, u: Optional[Tensor], p: PackedLevel,
            plan: Plan) -> Tensor:
    n, h, w, cd = d.shape
    _, cu, cm, co = p.widths
    dt = d.dtype
    if p.split != (plan.route == "wgmma_tf32x3"):
        raise RuntimeError(f"level packed {'with' if p.split else 'without'}"
                           f" the 3xTF32 split, the kernel takes route "
                           f"{plan.route}")
    h1 = (torch.empty(n, h, w, cm, dtype=dt, device=d.device)
          if plan.launches == 2 else None)
    y = torch.empty(n, h, w, co, dtype=dt, device=d.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = _kernel().srsem_fused_decoder(
            ptr(d), ptr(u), ptr(p.w1t), ptr(p.b1), ptr(p.w2t), ptr(p.b2),
            ptr(h1), ptr(y), n, h, w, cd, cu, cm, co, p.final_kernel,
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


def _run(wrapper, d: Tensor, u: Optional[Tensor], weights, final_kernel: int,
         row_tile: Optional[int]) -> Tensor:
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_decoder kernel for {d.device}")
    if len(weights) == 1 and isinstance(weights[0], PackedLevel):
        p = weights[0]
        _check_packed(d, u, p, final_kernel)
        if d.device.type == "cpu":
            h, w = d.shape[1:3]
            return decoder_tiles_plain(d, u, *unpack_level(p), final_kernel,
                                       min(row_tile or h, h), w)
    elif len(weights) == 5:
        if d.device.type == "cpu":
            return plain_decoder_level(d, u, *weights, final_kernel, row_tile)
        args = kernel_args(d, u, *weights, final_kernel)
        d, u = args[:2]
        p = pack_level(*args[2:], final_kernel, d.dtype)
    else:
        raise TypeError("weights: (w1d, w1u, b1, w2, b2) or one PackedLevel")
    if any(t.data_ptr() % 16 for t in (d, u, p.w1t, p.b1, p.w2t, p.b2)
           if t is not None):
        raise ValueError("fused_decoder needs 16-byte-aligned tensors")
    y = _launch(d, u, p, _plan(d, p.widths, final_kernel))
    wrapper.launches += 1
    return y


def fused_decoder_level(d: Tensor, u: Optional[Tensor], *weights,
                        final_kernel: int = 3) -> Tensor:
    """One CLU decoder level: ``relu(conv2(relu(conv1(d, u))))`` on NHWC
    ``d`` (skip diff) and ``u`` (upsampled deeper output, or None at the
    deepest level).  ``weights`` is (w1d, w1u, b1, w2, b2) in the JAX
    layouts, packed on this call, or one ``PackedLevel``."""
    return _run(fused_decoder_level, d, u, weights, final_kernel, None)


def fused_decoder_level_tiled(d: Tensor, u: Optional[Tensor], *weights,
                              row_tile: int,
                              final_kernel: int = 3) -> Tensor:
    """``fused_decoder_level`` for callers of the TPU's row-tiled kernel.
    ``row_tile`` (>= 1; it need not divide H, and ``u`` may be None) is
    that kernel's rows per grid step.  On the card the kernel has no row
    tile and the result does not depend on it; on the CPU the plain
    version runs the TPU kernel's row tiles with their 1- or 2-row halo."""
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return _run(fused_decoder_level_tiled, d, u, weights, final_kernel,
                row_tile)


fused_decoder_level.launches = 0
fused_decoder_level_tiled.launches = 0
