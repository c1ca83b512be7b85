"""Fused squared-diff → 1x1-conv head → spatial sum — the port of
srsem/ops/fused_head.py.

Per tapped stage the global regressor's head computes
``mean_hw((f_a - f_b)^2 · w) + b`` (reference numerics:
models/global_eval_models.py:379-392).  ``fused_stage_score`` reads each
feature map once and writes no diff tensor.

Hopper kernel (Triton; replaces fused_head.py::fused_stage_score and its
Pallas body ``_make_kernel``).  What bounds it: about 1 FLOP a byte — a
pure streaming reduction, memory-bound on any GPU, so it needs no tensor
cores and no shared-memory staging.  The design:

* grid (image, chunk of the flattened H·W·C image); each program streams
  ``_CHUNK`` elements in ``_BLOCK``-wide vector loads (16 bytes a thread
  in bf16), accumulates ``(a-b)^2 · w[c]`` in float32 and writes one
  partial to an (N, T) buffer — so a batch of 64 images fills all 132 SMs
  (one program per image would leave half of them idle);
* a second small pass sums each image's partials in a fixed order: the
  result is deterministic, with no atomics.

The wrapper divides by H·W and adds ``b`` as the JAX wrapper does (:129).
For a CPU tensor it runs the plain PyTorch version; ``triton`` is imported
only where the kernel launches.  ``fused_stage_score.launches`` counts
launches.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Union

import torch

Tensor = torch.Tensor

_BLOCK = 1024        # elements per vector step of one program
_CHUNK = 8 * _BLOCK  # elements per program
_SUM_BLOCK = 128     # partials per step of the second pass
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels once, at first launch."""
    import triton
    import triton.language as tl

    @triton.jit
    def partials(fa_ptr, fb_ptr, w_ptr, part_ptr, L, C, T,
                 CHUNK: tl.constexpr, BLOCK: tl.constexpr):
        img = tl.program_id(0)
        t = tl.program_id(1)
        base = img.to(tl.int64) * L
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = t * CHUNK + off + tl.arange(0, BLOCK)
            mask = idx < L
            a = tl.load(fa_ptr + base + idx, mask=mask, other=0.0)
            b = tl.load(fb_ptr + base + idx, mask=mask, other=0.0)
            wc = tl.load(w_ptr + idx % C, mask=mask, other=0.0)
            d = a.to(tl.float32) - b.to(tl.float32)
            acc += d * d * wc
        tl.store(part_ptr + img * T + t, tl.sum(acc, axis=0))

    @triton.jit
    def total(part_ptr, out_ptr, T, BLOCK: tl.constexpr):
        img = tl.program_id(0)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for t0 in range(0, T, BLOCK):
            offs = t0 + tl.arange(0, BLOCK)
            acc += tl.load(part_ptr + img * T + offs, mask=offs < T, other=0.0)
        tl.store(out_ptr + img, tl.sum(acc, axis=0))

    return partials, total


def _check(fa: Tensor, fb: Tensor, w: Tensor) -> None:
    if fa.dim() != 4 or fa.shape != fb.shape:
        raise ValueError(f"fa {tuple(fa.shape)} and fb {tuple(fb.shape)} must "
                         "be equal (N, H, W, C) shapes")
    if fa.dtype != fb.dtype or fa.dtype not in _DTYPES:
        raise TypeError(f"fa/fb dtypes {fa.dtype}/{fb.dtype}: need one of "
                        f"{_DTYPES}")
    if tuple(w.shape) != (fa.shape[-1],) or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 of shape ({fa.shape[-1]},), got "
                         f"{w.dtype} {tuple(w.shape)}")
    if not (fa.device == fb.device == w.device):
        raise ValueError(f"devices differ: {fa.device}, {fb.device}, "
                         f"{w.device}")
    if not (fa.is_contiguous() and fb.is_contiguous() and w.is_contiguous()):
        raise ValueError("fa, fb and w must be contiguous")


def plain_stage_sums(fa: Tensor, fb: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: (N,) float32
    ``sum_{h,w,c}((fa-fb)^2 · w[c])``."""
    d = fa.float() - fb.float()
    return (d * d * w).sum(dim=(1, 2, 3))


def _launch(fa: Tensor, fb: Tensor, w: Tensor) -> Tensor:
    partials, total = _kernels()
    n = fa.shape[0]
    length = fa[0].numel()
    tiles = -(-length // _CHUNK)
    part = torch.empty((n, tiles), dtype=torch.float32, device=fa.device)
    out = torch.empty((n,), dtype=torch.float32, device=fa.device)
    with torch.cuda.device(fa.device):
        partials[(n, tiles)](fa, fb, w, part, length, fa.shape[-1], tiles,
                             CHUNK=_CHUNK, BLOCK=_BLOCK, num_warps=4)
        total[(n,)](part, out, tiles, BLOCK=_SUM_BLOCK, num_warps=4)
    return out


def fused_stage_score(fa: Tensor, fb: Tensor, w: Tensor,
                      b: Union[Tensor, float]) -> Tensor:
    """(N, H, W, C) feature pair + head weights (C,) float32 + bias →
    (N,) float32 scores ``mean_hw((fa-fb)^2 · w) + b``."""
    _check(fa, fb, w)
    if fa.device.type == "cpu":
        sums = plain_stage_sums(fa, fb, w)
    elif fa.device.type == "cuda":
        sums = _launch(fa, fb, w)
        fused_stage_score.launches += 1
    else:
        raise ValueError(f"no fused_stage_score kernel for {fa.device}")
    return sums / (fa.shape[1] * fa.shape[2]) + b


fused_stage_score.launches = 0


def fused_global_score(taps_a: Dict[str, Tensor], taps_b: Dict[str, Tensor],
                       head, tap_names: Sequence[str]) -> Tensor:
    """The stages_cnn aggregation through the kernel: per-stage score,
    mean over stages, final ReLU — ConvHeadAggregator's numerics.
    ``head`` is a ConvHeadAggregator (srsem_torch/models/global_models.py),
    whose ``w_layers.{j}`` Conv2d(C, 1, 1) hold the per-stage weights."""
    scores: List[Tensor] = []
    for j, name in enumerate(tap_names):
        layer = head.w_layers[j]
        scores.append(fused_stage_score(
            taps_a[name], taps_b[name], layer.weight.reshape(-1).float(),
            layer.bias.float()[0]))
    return torch.relu(torch.stack(scores).mean(dim=0))
