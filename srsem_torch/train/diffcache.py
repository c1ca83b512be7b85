"""Diff-cache sweep training: the frozen tower runs once, epochs train on
its cached squared-diff pyramids — the port of srsem/train/diffcache.py.

A frozen tower and deterministic preprocessing make every pair's
squared-diff pyramid a constant of the dataset, yet the reference
recomputes it every epoch of every grid point (reference:
CLIPLPIPS_REG_training_sweep_example.py:107-114,169-188).  Here the
tap-union pyramids of the train and validation streams are computed in
one tower pass (the Hopper bottleneck kernels on the card, through
``frozen_tower``) and kept on the card, built there directly, as
``(n_batches, batch, h, w, c)`` tensors; every later epoch of every grid
point trains heads (or the CLU decoder) on the cache alone.

Numerics: the cached diffs (float32 by default) feed the same head math
as the per-epoch paths, so one step from the cache equals one uncached
step.  Batch composition is frozen at build time; epochs reshuffle the
batch order only (a permutation from a ``torch.Generator`` seeded with
``tcfg.seed``, where JAX draws ``jax.random.permutation``).

Memory: the depth-3 tap union at 224 px is ~6 MB a pair in float32 (~1.4
GB for the 240-pair train split); ``max_bytes`` (8 GiB) guards the
budget with JAX's ``MemoryError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from srsem_torch.config import GlobalModelConfig, TrainConfig
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.train.loop import batch_to_device
from srsem_torch.train.multisweep import (
    SweepPoint,
    adam_step,
    global_results,
    labels_for,
    local_sweep_models,
    pair_taps,
    point_heads,
    sweep_tower,
)
from srsem_torch.train.steps import masked_mse
from srsem_torch.utils.convert import jax_trainable_params

Tensor = torch.Tensor


@dataclasses.dataclass
class DiffCache:
    """Squared-diff pyramids of a pair stream on the device.

    ``diffs[name]``: (n_batches, batch, h, w, c); ``y`` / ``mask``:
    (n_batches, batch)."""

    diffs: Dict[str, Tensor]
    y: Tensor
    mask: Tensor

    @property
    def n_batches(self) -> int:
        return int(self.y.shape[0])

    @property
    def batch(self) -> int:
        return int(self.y.shape[1])


def estimate_cache_bytes(tap_shapes: Dict[str, Tuple[int, ...]],
                         n_pairs: int, cache_dtype) -> int:
    """Bytes for ``n_pairs`` diff pyramids over the given (h, w, c) taps."""
    item = torch.empty((), dtype=cache_dtype).element_size()
    per_pair = sum(math.prod(s) for s in tap_shapes.values())
    return per_pair * n_pairs * item


def _stacked(batches: List[Tensor]) -> Tensor:
    if any(t.shape[0] != batches[0].shape[0] for t in batches):
        raise ValueError("loader must yield fixed-size (padded) batches")
    return torch.stack(batches)


def build_diff_cache(tower, tap_names: Sequence[str], loader,
                     device: torch.device, cache_dtype=torch.float32,
                     max_bytes: Optional[int] = 8 << 30) -> DiffCache:
    """One frozen-tower pass over ``loader`` (masked batches ``(((a, b),
    y), mask)``) into a diff cache on ``device``.  ``tower`` maps NHWC
    images to ``(embedding, taps)``."""
    tap_names = list(tap_names)
    diffs: Dict[str, List[Tensor]] = {nm: [] for nm in tap_names}
    ys: List[Tensor] = []
    masks: List[Tensor] = []
    total = 0
    for batch in loader:
        a, b, y, mask = batch_to_device(batch, device)
        taps_a, taps_b = pair_taps(tower, a, b, tap_names)
        for nm in tap_names:
            d = ((taps_a[nm].float() - taps_b[nm].float()) ** 2).to(
                cache_dtype)
            diffs[nm].append(d)
            total += d.numel() * d.element_size()
        ys.append(y.float())
        masks.append(mask.float())
        if max_bytes is not None and total > max_bytes:
            raise MemoryError(
                f"diff cache exceeds {max_bytes} bytes after "
                f"{sum(m.numel() for m in masks)} pairs; use the shared-tower "
                "sweep (srsem/train/multisweep.py) for datasets this large")
    if not ys:
        raise ValueError("empty loader — nothing to cache")
    return DiffCache(diffs={nm: _stacked(v) for nm, v in diffs.items()},
                     y=_stacked(ys), mask=_stacked(masks))


def train_global_sweep_cached_diffs(
    points: Sequence[SweepPoint],
    cfg: GlobalModelConfig,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    cache_dtype=torch.float32,
    max_cache_bytes: Optional[int] = 8 << 30,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
) -> List[Dict]:
    """The global depth sweep with the tower amortized to one pass.

    Same contract as ``train_global_sweep_shared_tower`` (one summary a
    point: ``{name, train_loss, val_srcc, val_mse, head_params}``); after
    the cache builds, epochs train every head on it in a reshuffled batch
    order.  ``backbone_params``: the pretrained tower (CLI
    ``--backbone-checkpoint``); the whole premise is caching the frozen
    pretrained tower's diffs, so random weights are only the zero-egress
    fallback."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(tcfg.seed)
    kind = cfg.backbone.kind
    tower = sweep_tower(cfg, backbone_params, gen, dev, fused_tower)
    heads = [h.to(dev) for h in point_heads(points, kind, gen)]
    names = [p.tap_names(kind) for p in points]
    union = sorted({n for nm in names for n in nm})
    cache = build_diff_cache(tower, union, train_loader, dev, cache_dtype,
                             max_cache_bytes)
    val_cache = build_diff_cache(tower, union, val_loader, dev, cache_dtype,
                                 max_cache_bytes)

    def pred(i: int, c: DiffCache, idx: int) -> Tensor:
        return heads[i]([c.diffs[nm][idx].float() for nm in names[i]])

    opts = [torch.optim.Adam(h.parameters(), lr=tcfg.lr) for h in heads]
    losses = torch.zeros(len(points))
    for _ in range(tcfg.epochs):
        for idx in torch.randperm(cache.n_batches, generator=gen).tolist():
            y, mask = cache.y[idx], cache.mask[idx]
            losses = torch.stack([
                adam_step(opt, masked_mse(pred(i, cache, idx),
                                          labels_for(p, y), mask))
                for i, (p, opt) in enumerate(zip(points, opts))])
    losses = losses.cpu().numpy()

    keep = val_cache.mask.cpu().numpy() > 0
    with torch.no_grad():
        preds = [torch.stack([pred(i, val_cache, j)
                              for j in range(val_cache.n_batches)]
                             ).float().cpu().numpy()[keep]
                 for i in range(len(points))]
    return global_results(points, heads, losses, preds,
                          val_cache.y.cpu().numpy()[keep])


# --------------------------------------------------------------------------
# CLU decoder-only training on cached diffs
# --------------------------------------------------------------------------


def build_local_diff_cache(model, tower, loader, device: torch.device,
                           cache_dtype=torch.float32,
                           max_bytes: Optional[int] = 8 << 30) -> Dict:
    """A frozen-tower pass over a CLU pair stream: ``{"diffs": [(nb, bs,
    h, w, c), ...] shallow to deep, "img_sq": (nb, bs, H, W, 1) or None,
    "y": (nb, bs, H, W), "mask": (nb, bs)}`` on ``device`` — everything
    the decoder needs, so epochs never touch the tower.  For the
    decoder-only grid points (the reference CLU sweep's ``lora_rank=None``
    rows, CLU_training_sweep_example.py:81-89)."""
    names = model.tap_names
    levels: List[List[Tensor]] = [[] for _ in names]
    img: List[Tensor] = []
    ys: List[Tensor] = []
    masks: List[Tensor] = []
    total = 0
    for batch in loader:
        a, b, y, mask = batch_to_device(batch, device)
        taps_a, taps_b = pair_taps(tower, a, b, names)
        parts = [((taps_a[nm].float() - taps_b[nm].float()) ** 2).to(
            cache_dtype) for nm in names]
        for lvl, d in enumerate(parts):
            levels[lvl].append(d)
        if model.v2:
            img.append(((a.float() - b.float()) ** 2).mean(
                dim=-1, keepdim=True).to(cache_dtype))
            parts.append(img[-1])
        total += sum(d.numel() * d.element_size() for d in parts)
        ys.append(y.float())
        masks.append(mask.float())
        if max_bytes is not None and total > max_bytes:
            raise MemoryError(
                f"CLU diff cache exceeds {max_bytes} bytes; lower epochs' "
                "cost with the standard train_local loop instead")
    if not ys:
        raise ValueError("empty loader — nothing to cache")
    return {"diffs": [_stacked(lvl) for lvl in levels],
            "img_sq": _stacked(img) if img else None,
            "y": _stacked(ys), "mask": _stacked(masks)}


def train_local_cached_diffs(
    cfg,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    cache_dtype=torch.float32,
    max_cache_bytes: Optional[int] = 8 << 30,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
) -> Dict:
    """CLU decoder-only training with the tower amortized to one pass.

    The loss, optimizer and BatchNorm semantics of ``train_local`` for the
    decoder-only grid points (a frozen tower makes the cached diffs what
    ``CluUnet.forward`` would recompute each step — reference:
    CLU_training_sweep_example.py:25-72); LoRA and full fine-tune
    configurations, whose tower changes each step, raise JAX's
    ``ValueError``.  Returns ``{trainable, batch_stats, train_loss,
    val_mse}`` (JAX layout)."""
    if cfg.lora_rank is not None or getattr(cfg, "full_finetune", False):
        raise ValueError(
            "cached-diff CLU training applies to decoder-only configs; "
            "LoRA/full fine-tune change the tower per step")
    dev = resolve_device(device)
    (model,), tower = local_sweep_models(cfg, tcfg, 1, backbone_params, dev,
                                         fused_tower)
    cache = build_local_diff_cache(model, tower, train_loader, dev,
                                   cache_dtype, max_cache_bytes)
    val_cache = build_local_diff_cache(model, tower, val_loader, dev,
                                       cache_dtype, max_cache_bytes)

    def decode(c: Dict, idx: int, train: bool) -> Tensor:
        img = c["img_sq"][idx] if c["img_sq"] is not None else None
        return model.decode_from_diffs([d[idx] for d in c["diffs"]], img,
                                       train)

    optimizer = torch.optim.Adam(model.decoder.parameters(), lr=tcfg.lr)
    gen = torch.Generator().manual_seed(tcfg.seed)
    n_batches = int(cache["y"].shape[0])
    last_loss = float("nan")
    for _ in range(tcfg.epochs):
        for idx in torch.randperm(n_batches, generator=gen).tolist():
            loss = adam_step(optimizer, masked_mse(
                decode(cache, idx, True), cache["y"][idx],
                cache["mask"][idx]))
        last_loss = float(loss)

    se, n = 0.0, 0.0
    with torch.no_grad():
        for idx in range(int(val_cache["y"].shape[0])):
            pred = decode(val_cache, idx, False).float()
            m = val_cache["mask"][idx]
            se += float((((pred - val_cache["y"][idx]) ** 2)
                         * m.reshape((-1,) + (1,) * (pred.dim() - 1))).sum())
            n += float(m.sum()) * pred[0].numel()
    trainable, stats = jax_trainable_params(model)
    return {"trainable": trainable, "batch_stats": stats,
            "train_loss": last_loss, "val_mse": se / (n + 1e-9)}
