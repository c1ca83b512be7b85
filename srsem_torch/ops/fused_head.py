"""Fused squared-diff → 1x1-conv head → spatial sum — the port of
srsem/ops/fused_head.py, of the grouped head
srsem/models/global_models.py::fused_grouped_head, and of the ViT token
head (``TokenHeadAggregator``, ``fused_grouped_token_head``).

Per tapped stage the global regressor's head computes
``mean_hw((f_a - f_b)^2 · w) + b`` over (N, H, W, C) feature maps
(reference numerics: models/global_eval_models.py:379-392), or
``mean_t((t_a - t_b)^2 · w) + b`` over (N, T, W) token taps; the score is
the ReLU of the mean over stages.  The kernel reads each tap once and
writes no diff tensor.

Hopper kernel: csrc/fused_head.cu (CUDA C++), one launch a scored batch
with every stage, the bias, the mean and the ReLU in it; a grouped batch
(one GT against K SR images) reads each GT tap once.  The source says what
bounds it (bytes) and what its design does about that.  Its plan (chunk
size, work items, grid) is made here only, by ``kernel_plan``; the
library checks it.

* ``fused_stage_score(fa, fb, w, b)`` — one stage, (N,) scores
  ``sum/(H·W) + b`` (the TPU kernel's wrapper);
* ``fused_global_score(taps_a, taps_b, head, names)`` — (N,) scores of
  a conv head (stages_cnn, wperlay_cnn) or a token head (the ViT heads),
  the aggregators' numerics, up to 12 stages;
* ``fused_grouped_score(taps_g, taps_s, head, names)`` — (G, K) scores
  from G GT and G·K SR taps (fused_grouped_head's and
  fused_grouped_token_head's numerics).

``head`` is a ConvHeadAggregator, a TokenHeadAggregator or the
``PackedHead`` that ``pack_head`` makes once (the scorers do, at
construction).  Each function has a plain
PyTorch version beside it (``plain_stage_sums``, ``plain_global_score``,
``plain_grouped_score``), which runs for CPU tensors; for a CUDA tensor the
wrapper launches the kernel or raises.  Each counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch

from srsem_torch.ops import _build

Tensor = torch.Tensor
Taps = Dict[str, Tensor]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_STEP = 2048          # elements a block streams a step (256 threads x 8)
# The fixed-channel path's steps, one a launch, the first that a stage's C
# divides: all 256 threads, or 192 (C = 768, the ViT-B width, divides 1536
# and not 2048).
_VEC_STEPS = (_STEP, 1536)
_UNROLL = 4 * _STEP   # chunks are whole groups of the most steps a thread unrolls
_MAX_CHUNK = 32 * _STEP
_ITEMS_PER_BLOCK = 8  # work items a block that the chunk size aims at
_BLOCKS_PER_SM = 4    # csrc/fused_head.cu kMinBlocks: 64 registers a thread
_MAX_KB = 8           # SR images an item streams against one GT chunk
_MAX_STAGES = 12     # csrc/fused_head.cu kMaxStages: wperlay_cnn's 12 taps


@dataclass(frozen=True)
class PackedHead:
    """A head's per-stage weights and biases as the kernel reads them:
    ``w`` (ΣC,) and ``b`` (S,) float32 on the head's device, stage j's
    weights at ``w[offsets[j]: offsets[j] + channels[j]]``."""

    w: Tensor
    b: Tensor
    channels: Tuple[int, ...]

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, o = [], 0
        for c in self.channels:
            out.append(o)
            o += c
        return tuple(out)

    def stage(self, j: int) -> Tuple[Tensor, Tensor]:
        o = self.offsets[j]
        return self.w[o: o + self.channels[j]], self.b[j]


def pack_head(head) -> PackedHead:
    """Concatenate a ConvHeadAggregator's ``w_layers.{j}`` or a
    TokenHeadAggregator's heads, weights and biases in float32 on its
    device: one copy, made once by the scorers (the head math runs in
    float32, so the pack has no other dtype).  A shared token head
    (single_lin_vit) packs its one ``w_layer`` once a stage."""
    layers = ([head.w_layer[0]] * head.n_layers
              if getattr(head, "shared", False) else list(head.w_layers))
    with torch.no_grad():
        w = torch.cat([l.weight.reshape(-1).float() for l in layers])
        b = torch.cat([l.bias.reshape(-1).float() for l in layers])
    return PackedHead(w.contiguous(), b.contiguous(),
                      tuple(l.weight.shape[1] for l in layers))


def _as_packed(head) -> PackedHead:
    return head if isinstance(head, PackedHead) else pack_head(head)


# ---- checks ------------------------------------------------------------


def _check_stages(stages: Sequence[Tuple[Tensor, Tensor]]) -> None:
    """Check (GT, SR) tap pairs against what the kernel takes: (N, H, W, C)
    maps or (N, T, W) tokens, SR batches K times the GT batch, one dtype,
    one device, contiguous."""
    if not stages:
        raise ValueError("no tapped stages")
    g = stages[0][0].shape[0] if stages[0][0].dim() else 0
    k = None
    dev, dt = stages[0][0].device, stages[0][0].dtype
    for gt, sr in stages:
        if gt.dim() not in (3, 4) or sr.dim() != gt.dim() \
                or gt.shape[1:] != sr.shape[1:]:
            raise ValueError(f"GT {tuple(gt.shape)} and SR {tuple(sr.shape)} "
                             "must be (N, H, W, C) or (N, T, W) with equal "
                             "trailing sizes")
        if gt.numel() == 0 or gt.shape[0] != g:
            raise ValueError(f"every stage needs the same nonzero GT batch "
                             f"{g}, got {tuple(gt.shape)}")
        if sr.shape[0] % g or (k is not None and sr.shape[0] != k * g):
            raise ValueError(f"SR batch {sr.shape[0]} is not K x GT batch {g}")
        k = sr.shape[0] // g
        if gt.dtype != sr.dtype or gt.dtype != dt or dt not in _DTYPES:
            raise TypeError(f"GT/SR dtypes {gt.dtype}/{sr.dtype}: need one "
                            f"equal dtype of {_DTYPES}")
        if gt.device != dev or sr.device != dev:
            raise ValueError(f"devices differ: {gt.device}, {sr.device}, {dev}")
        if not (gt.is_contiguous() and sr.is_contiguous()):
            raise ValueError("GT and SR taps must be contiguous")


def _check_head(p: PackedHead, stages, device) -> None:
    want = tuple(gt.shape[-1] for gt, _ in stages)
    if p.channels != want:
        raise ValueError(f"head channels {p.channels} != tap channels {want}")
    for name, t, n in (("w", p.w, sum(want)), ("b", p.b, len(want))):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise TypeError(f"packed head {name} must be contiguous float32 "
                            f"({n},), got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"packed head {name} on {t.device}, taps on "
                             f"{device}")


def _pairs(taps_g: Taps, taps_s: Taps, names: Sequence[str]):
    return [(taps_g[n], taps_s[n]) for n in names]


# ---- plain versions ----------------------------------------------------


def plain_stage_sums(fa: Tensor, fb: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version of the per-stage kernel: (N,) float32
    ``sum_{h,w,c}((fa-fb)^2 · w[c])`` (or over tokens and width)."""
    d = fa.float() - fb.float()
    return (d * d * w).sum(dim=tuple(range(1, d.dim())))


def plain_grouped_score(taps_g: Taps, taps_s: Taps, head,
                        tap_names: Sequence[str]) -> Tensor:
    """Plain PyTorch version of the kernel (fused_grouped_head's and
    fused_grouped_token_head's math, in float32): (G, K)
    ``relu(mean_s(sum_hwc((g - s)^2 · w_s)/(H·W) + b_s))``, or with T
    tokens in place of H·W, for G GT taps against G·K SR taps."""
    p = _as_packed(head)
    g = taps_g[tap_names[0]].shape[0]
    scores = []
    for j, name in enumerate(tap_names):
        t = taps_s[name]
        d = (taps_g[name].float()[:, None]
             - t.reshape(g, t.shape[0] // g, *t.shape[1:]).float())
        w, b = p.stage(j)
        scores.append((d * d * w).sum(dim=tuple(range(2, d.dim())))
                      / math.prod(t.shape[1:-1]) + b)
    return torch.relu(torch.stack(scores).mean(dim=0))


def plain_global_score(taps_a: Taps, taps_b: Taps, head,
                       tap_names: Sequence[str]) -> Tensor:
    """Plain PyTorch version of ``fused_global_score`` (ConvHeadAggregator's
    math, in float32): (N,) scores."""
    return plain_grouped_score(taps_a, taps_b, head, tap_names)[:, 0]


# ---- the kernel's plan -------------------------------------------------


class Plan(NamedTuple):
    """How one launch walks its work: stages in ``order`` (largest tap
    first); per stage (in that order) ``chunk`` elements a work item,
    ``chunks`` an image, ``step`` (on the fixed-channel path, ``vec``:
    the launch's step, 2048 elements, or 1536 by 192 threads, with a
    thread's channels fixed and 16-byte loads; 0 off it), its first item
    ``item0`` and first partial ``part0``; an item streams
    ``kb`` SR images (``kblocks`` k-blocks a group; ``kt`` the kernel's
    compile-time bound); ``items`` in all, ``grid`` blocks, ``partials``
    floats of scratch."""

    order: Tuple[int, ...]
    chunk: Tuple[int, ...]
    chunks: Tuple[int, ...]
    step: Tuple[int, ...]
    item0: Tuple[int, ...]
    part0: Tuple[int, ...]
    kb: int
    kblocks: int
    kt: int
    items: int
    grid: int
    partials: int

    @property
    def vec(self) -> Tuple[bool, ...]:
        return tuple(s > 0 for s in self.step)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shapes(stages) -> Tuple[tuple, tuple]:
    """What a plan depends on: the (GT, SR) shapes and whether both taps
    of each stage are 16-byte aligned."""
    return (tuple((gt.shape, sr.shape) for gt, sr in stages),
            tuple(gt.data_ptr() % 16 == 0 and sr.data_ptr() % 16 == 0
                  for gt, sr in stages))


def kernel_plan(stages: Sequence[Tuple[Tensor, Tensor]], sms: int) -> Plan:
    """The plan of one launch over checked (GT, SR) tap pairs on ``sms``
    SMs (at most 12 stages): one chunk size for every stage, near
    ``items / (sms x 4 blocks) = 8`` items a block, in whole unrolled
    groups of four steps and spread evenly over each image's tap.  The
    fixed-channel path has one step a launch (the kernel's instance): 2048
    elements if a stage's C divides it, else 1536 (192 of the 256 threads:
    C = 768, the ViT tokens' width).  A stage takes it when C is a
    multiple of 8 dividing that step and both taps are 16-byte aligned;
    else the general path, in steps of 2048."""
    return _plan(*_shapes(stages), sms)


@functools.lru_cache(maxsize=256)
def _plan(shapes: tuple, aligned: tuple, sms: int) -> Plan:
    if len(shapes) > _MAX_STAGES:
        raise ValueError(f"the kernel scores at most {_MAX_STAGES} stages, "
                         f"got {len(shapes)}")
    g = shapes[0][0][0]
    k = shapes[0][1][0] // g
    kb = min(k, _MAX_KB)
    kblocks = _cdiv(k, kb)
    per_image = [math.prod(gt[1:]) for gt, _ in shapes]
    order = tuple(sorted(range(len(shapes)), key=lambda s: -per_image[s]))
    cap = sms * _BLOCKS_PER_SM
    total = g * kblocks * sum(per_image)
    target = min(_MAX_CHUNK, _cdiv(_cdiv(total, cap * _ITEMS_PER_BLOCK),
                                   _UNROLL) * _UNROLL)
    fits = [gt[-1] % 8 == 0 and ok for (gt, _), ok in zip(shapes, aligned)]
    launch_step = next((v for v in _VEC_STEPS
                        if any(f and v % gt[-1] == 0
                               for f, (gt, _) in zip(fits, shapes))), 0)
    chunk, chunks, step, item0, part0 = [], [], [], [], []
    items = parts = 0
    for s in order:
        n = per_image[s]
        vstep = launch_step if (fits[s] and launch_step
                                and launch_step % shapes[s][0][-1] == 0) else 0
        unit = _UNROLL // _STEP * vstep if vstep else _UNROLL
        size = _cdiv(_cdiv(n, _cdiv(n, target)), unit) * unit
        m = _cdiv(n, size)
        chunk.append(size)
        chunks.append(m)
        step.append(vstep)
        item0.append(items)
        part0.append(parts)
        items += g * kblocks * m
        parts += g * k * m
    return Plan(order, tuple(chunk), tuple(chunks), tuple(step),
                tuple(item0), tuple(part0), kb, kblocks,
                1 << (kb - 1).bit_length(), items, min(items, cap), parts)


# ---- the launch --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """fused_head.cu's library with its export typed (built on first use)."""
    lib = _build.load("fused_head")
    lib.srsem_fused_head.restype = ctypes.c_int
    lib.srsem_fused_head.argtypes = (
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_void_p),
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_void_p] * 4)
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _descriptor(shapes: tuple, aligned: tuple, sms: int, dtype: int,
                per_stage: bool):
    """The plan and the library's plan array for it (csrc/fused_head.cu,
    srsem_fused_head): made once a shape; a call adds the taps' pointers."""
    plan = _plan(shapes, aligned, sms)
    g, k = shapes[0][0][0], shapes[0][1][0] // shapes[0][0][0]
    offsets = [0]
    for gt, _ in shapes:
        offsets.append(offsets[-1] + gt[-1])
    values = [len(shapes), dtype, g, k, plan.kb, plan.kblocks, plan.kt,
              plan.items, plan.grid, int(per_stage)]
    for i, s in enumerate(plan.order):
        gt = shapes[s][0]
        values += [math.prod(gt[1:]), plan.item0[i], plan.part0[i], gt[-1],
                   offsets[s], s, plan.chunk[i], plan.chunks[i],
                   plan.step[i], math.prod(gt[1:-1])]
    return plan, (ctypes.c_longlong * len(values))(*values)


_TICKETS: Dict[Tuple[int, int], Tensor] = {}


def _ticket(device: torch.device, stream: int) -> Tensor:
    """One zeroed counter for the launches on ``stream`` (the kernel leaves
    it zero), allocated once."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _launch(stages, w: Tensor, b, b_const: float, per_stage: bool) -> Tensor:
    """One launch over checked (GT, SR) pairs, stage s weighted by the
    packed head's stage s (``b`` None: every stage adds ``b_const``).
    Returns (G·K,) float32 scores."""
    dev = stages[0][0].device
    plan, desc = _descriptor(*_shapes(stages), _sm_count(dev.index),
                             _DTYPES.index(stages[0][0].dtype), per_stage)
    taps = (ctypes.c_void_p * (2 * len(stages)))(
        *[t.data_ptr() for s in plan.order for t in stages[s]])
    pairs = stages[0][1].shape[0]
    scratch = torch.empty(plan.partials + pairs, dtype=torch.float32,
                          device=dev)
    out = scratch[plan.partials:]
    # The raw handle of the device's current stream: torch.cuda's Stream
    # object costs about 9 us of host time a call, the launch itself ~15.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (desc, taps, w.data_ptr(), None if b is None else b.data_ptr(),
            b_const, scratch.data_ptr(), _ticket(dev, stream).data_ptr(),
            out.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        err = _kernel().srsem_fused_head(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel().srsem_fused_head(*args)
    if err != 0:
        raise RuntimeError(f"fused_head kernel launch failed: CUDA error "
                           f"{err} (stages {[tuple(t.shape) for t, _ in stages]}"
                           f", {stages[0][0].dtype}, plan {plan})")
    return out


def _on_card(device: torch.device, name: str) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for {device}")
    return True


def _score(wrapper, taps_g: Taps, taps_s: Taps, head,
           tap_names: Sequence[str]) -> Tensor:
    """(G·K,) head scores through the kernel or its plain version."""
    stages = _pairs(taps_g, taps_s, tap_names)
    _check_stages(stages)
    p = _as_packed(head)
    dev = stages[0][0].device
    _check_head(p, stages, dev)
    if not _on_card(dev, wrapper.__name__):
        return plain_grouped_score(taps_g, taps_s, p, tap_names).reshape(-1)
    out = _launch(stages, p.w, p.b, 0.0, False)
    wrapper.launches += 1
    return out


def fused_stage_score(fa: Tensor, fb: Tensor, w: Tensor,
                      b: Union[Tensor, float]) -> Tensor:
    """(N, H, W, C) feature pair (or (N, T, W) tokens) + head weights (C,)
    float32 + bias → (N,) float32 scores ``mean_hw((fa-fb)^2 · w) + b``.
    On the card a tensor ``b`` is read there (no host sync)."""
    if fa.shape != fb.shape:
        raise ValueError(f"fa {tuple(fa.shape)} and fb {tuple(fb.shape)} "
                         "must be equal (N, H, W, C) or (N, T, W) shapes")
    _check_stages([(fa, fb)])
    if tuple(w.shape) != (fa.shape[-1],) or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 of shape ({fa.shape[-1]},), got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != fa.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous on {fa.device}, got "
                         f"{w.device}")
    if not _on_card(fa.device, "fused_stage_score"):
        return plain_stage_sums(fa, fb, w) / math.prod(fa.shape[1:-1]) + b
    if isinstance(b, Tensor) and b.device == fa.device:
        bias = b.reshape(-1).float().contiguous()
        if bias.numel() != 1:
            raise ValueError(f"b must be one value, got {tuple(b.shape)}")
        out = _launch([(fa, fb)], w, bias, 0.0, True)
    else:
        out = _launch([(fa, fb)], w, None, float(b), True)
    fused_stage_score.launches += 1
    return out


def fused_global_score(taps_a: Taps, taps_b: Taps, head,
                       tap_names: Sequence[str]) -> Tensor:
    """The head's aggregation — per-stage score, mean over stages, final
    ReLU, ConvHeadAggregator's or TokenHeadAggregator's numerics — in one
    launch: (N,) float32.  ``head``: an aggregator or its ``pack_head``."""
    return _score(fused_global_score, taps_a, taps_b, head, tap_names)


def fused_grouped_score(taps_g: Taps, taps_s: Taps, head,
                        tap_names: Sequence[str]) -> Tensor:
    """fused_grouped_head in one launch: G GT taps against G·K SR taps
    (SR image g·K + k against GT g) → (G, K) float32 scores."""
    out = _score(fused_grouped_score, taps_g, taps_s, head, tap_names)
    return out.reshape(taps_g[tap_names[0]].shape[0], -1)


fused_stage_score.launches = 0
fused_global_score.launches = 0
fused_grouped_score.launches = 0
