"""Sufficient-statistic sweep training: exact conv-head training at ~15 KB
a pair — the port of srsem/train/statcache.py.

The diff cache (srsem_torch/train/diffcache.py) stores whole (h, w, C)
squared-diff pyramids, ~6 MB a pair at 224 px.  The ConvHeadAggregator is
a 1x1 conv then a spatial mean (reference:
models/global_eval_models.py:379-395), so per layer

    mean_hw(diff @ w + b) == dot(mean_hw(diff), w) + b

exactly: scores and head gradients from the per-layer spatial mean (one
C-vector a tap) equal those from the whole diff, up to FP reduction
order.  The depth-3 tap union is 256+512+1024+2048 = 3,840 floats ≈ 15 KB
a pair in float32, so a 10k-pair dataset caches in ~150 MB on the card.

The CLU decoder is nonlinear in its diffs and has no sufficient
statistic; it keeps the diff cache.

The closed form is one (D+1)x(D+1) ``torch.linalg.solve`` in float32 with
TF32 off.  The JAX package keeps a bounded cache of jitted solves (64
entries, FIFO, under a lock) so that repeated fits skip re-tracing; eager
PyTorch traces nothing, so here the solve is a plain function.

On a mesh the cache keeps JAX's layout (srsem/train/statcache.py:123):
the batch-index axis whole on every rank, the batch axis sliced by data
rank; each rank runs the tower on its slice and Adam steps as
``train.steps`` does.  The ridge solve runs on the statistics gathered
whole on every rank (``gathered``), as JAX's solve reads the replicated
arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from srsem_torch.config import GlobalModelConfig, TrainConfig
from srsem_torch.core.meshes import Mesh, replicate
from srsem_torch.device import DeviceLike
from srsem_torch.models.global_models import (
    conv_head_from_stats,
    conv_head_params,
    token_head_params,
)
from srsem_torch.train.diffcache import gather_rows
from srsem_torch.train.loop import batch_to_device, training_mesh
from srsem_torch.train.multisweep import (
    SweepPoint,
    global_results,
    labels_for,
    pair_taps,
    point_heads,
    sweep_tower,
)
from srsem_torch.train.steps import adam_step, masked_mse
from srsem_torch.utils.convert import conv_head_from_params

Tensor = torch.Tensor


@dataclasses.dataclass
class StatCache:
    """Per-layer diff statistics of a pair stream on the device.

    ``stats[name]``: (n_batches, batch, C) spatial-mean squared diffs;
    ``y`` / ``mask``: (n_batches, batch)."""

    stats: Dict[str, Tensor]
    y: Tensor
    mask: Tensor

    @property
    def n_batches(self) -> int:
        return int(self.y.shape[0])

    @property
    def batch(self) -> int:
        return int(self.y.shape[1])


def build_stat_cache(tower, tap_names: Sequence[str], loader,
                     device: torch.device,
                     mesh: Optional[Mesh] = None) -> StatCache:
    """One frozen-tower pass over ``loader`` into a stat cache on
    ``device``: per tap the mean over every axis but the batch and the
    features of the float32 squared diff (spatial for conv taps, tokens
    for ViT taps); on a ``mesh``, of this rank's slice of every batch."""
    tap_names = list(tap_names)
    stats: Dict[str, List[Tensor]] = {nm: [] for nm in tap_names}
    ys: List[Tensor] = []
    masks: List[Tensor] = []
    for batch in loader:
        a, b, y, mask = batch_to_device(batch, device, mesh)
        taps_a, taps_b = pair_taps(tower, a, b, tap_names)
        for nm in tap_names:
            d = (taps_a[nm].float() - taps_b[nm].float()) ** 2
            stats[nm].append(d.mean(dim=tuple(range(1, d.dim() - 1))))
        ys.append(y.float())
        masks.append(mask.float())
    if not ys:
        raise ValueError("empty loader — nothing to cache")
    if any(y.shape[0] != ys[0].shape[0] for y in ys):
        raise ValueError("loader must yield fixed-size (padded) batches")
    return StatCache(stats={nm: torch.stack(v) for nm, v in stats.items()},
                     y=torch.stack(ys), mask=torch.stack(masks))


def gathered(mesh: Optional[Mesh], cache: StatCache) -> StatCache:
    """``cache`` with every rank's slice of its batches: the whole cache
    on every rank."""
    if mesh is None or not mesh.distributed:
        return cache
    return StatCache(stats={nm: gather_rows(mesh, v)
                            for nm, v in cache.stats.items()},
                     y=gather_rows(mesh, cache.y),
                     mask=gather_rows(mesh, cache.mask))


@contextlib.contextmanager
def _no_tf32():
    """float32 matrix products in full float32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def closed_form_solve(stats: Dict[str, Tensor], names: Sequence[str],
                      y: Tensor, mask: Tensor, l2: float,
                      label_transform=None):
    """The ridge solve of the masked pre-ReLU MSE over ``theta = (w_1..
    w_L, b)`` with design matrix ``concat_l(s_l) / L``: ``(theta, mse)``,
    ``l2`` on the weights only (not the intercept)."""
    with _no_tf32():
        x = torch.cat([stats[nm].float() for nm in names], dim=-1) / len(names)
        yv = y.float()
        if label_transform is not None:
            yv = label_transform(yv)
        m = mask.float()
        xw = x * m[..., None]
        d = x.shape[-1]
        xs = torch.einsum("nbd->d", xw)
        a = torch.zeros((d + 1, d + 1), dtype=torch.float32, device=x.device)
        a[:d, :d] = (torch.einsum("nbd,nbe->de", xw, x)
                     + l2 * torch.eye(d, device=x.device))
        a[:d, d] = xs
        a[d, :d] = xs
        a[d, d] = m.sum()
        rhs = torch.cat([torch.einsum("nbd,nb->d", xw, yv),
                         (m * yv).sum()[None]])
        theta = torch.linalg.solve(a, rhs)
        pred = torch.einsum("nbd,d->nb", x, theta[:d]) + theta[d]
        mse = (m * (pred - yv) ** 2).sum() / m.sum().clamp(min=1.0)
    return theta, mse


def fit_conv_head_closed_form(cache: StatCache, names: Sequence[str],
                              l2: float = 1e-6, label_transform=None) -> Dict:
    """The exact ridge solution of the conv head's pre-ReLU MSE objective.

    The head is linear in its parameters, ``score = relu(mean_l(s_l @ w_l
    + b_l))`` (reference models/global_eval_models.py:379-395), so up to
    the outer ReLU (which only clamps negative predictions; labels live in
    [0, 1]) the masked MSE is least squares in ``theta = (w_1..w_L, b)``:
    the reference's 30 Adam epochs become one solve over the statistics
    the stat-cache sweep trains on (D = 3,840 at depth 3).  The per-layer
    biases are not separately identifiable (only their mean enters the
    score), so the shared intercept goes into every ``w_layers.{j}``
    bias: the parameters are interchangeable with Adam-trained ones.

    Returns ``{"params", "theta", "train_mse"}``: the head in the JAX
    layout, theta as float32 numpy, and the masked pre-ReLU MSE of the
    solution on ``cache``."""
    names = list(names)
    dims = [int(cache.stats[nm].shape[-1]) for nm in names]
    theta, mse = closed_form_solve(cache.stats, names, cache.y, cache.mask,
                                   float(l2), label_transform)
    theta = theta.cpu().numpy()
    # The design matrix's 1/L is the aggregator's own layer mean, so theta
    # maps one to one onto the weights (see conv_head_from_stats).
    weights = list(np.split(theta[:-1], np.cumsum(dims)[:-1]))
    return {"params": conv_head_params(weights, [float(theta[-1])] * len(names)),
            "theta": theta, "train_mse": float(mse)}


def fit_token_head_closed_form(cache: StatCache, names: Sequence[str],
                               shared: bool = False, l2: float = 1e-6,
                               label_transform=None) -> Dict:
    """The closed-form ridge fit of the ViT token heads: the token mean is
    their exact sufficient statistic and ``build_stat_cache`` emits it for
    (N, T, W) taps, so the per-layer fit is ``fit_conv_head_closed_form``.
    ``shared`` fits the singleLin head (reference:
    models/global_eval_models.py:29-80): ``score = mean_l(s_l @ w + b) =
    (mean_l s_l) @ w + b``, one (W+1) solve over the layer-mean statistic,
    emitted as ``w_layer``."""
    if not shared:
        return fit_conv_head_closed_form(cache, names, l2=l2,
                                         label_transform=label_transform)
    names = list(names)
    dims = {int(cache.stats[nm].shape[-1]) for nm in names}
    if len(dims) != 1:
        raise ValueError(f"shared head needs equal tap widths, got {dims}")
    merged = torch.stack([cache.stats[nm].float() for nm in names]).mean(dim=0)
    theta, mse = closed_form_solve({"shared": merged}, ["shared"], cache.y,
                                   cache.mask, float(l2), label_transform)
    theta = theta.cpu().numpy()
    return {"params": token_head_params([theta[:-1]], [float(theta[-1])],
                                        shared=True),
            "theta": theta, "train_mse": float(mse)}


def _stat_caches(points, cfg, tcfg, train_loader, val_loader,
                 backbone_params, mesh, fused_tower):
    """``(generator, train cache, val cache)`` over the points' tap union,
    from one frozen tower built from ``backbone_params`` or the
    generator; the validation cache gathered whole."""
    gen = torch.Generator().manual_seed(tcfg.seed)
    tower = sweep_tower(cfg, backbone_params, gen, mesh.device, fused_tower,
                        mesh)
    union = sorted({n for p in points for n in p.tap_names(cfg.backbone.kind)})
    dev = mesh.device
    return (gen, build_stat_cache(tower, union, train_loader, dev, mesh),
            gathered(mesh, build_stat_cache(tower, union, val_loader, dev,
                                            mesh)))


def _predict(head, cache: StatCache, names) -> Tensor:
    """(n_batches, batch) head scores over a cache."""
    return conv_head_from_stats(head, [cache.stats[nm] for nm in names])


def solve_global_sweep_closed_form(
    points: Sequence[SweepPoint],
    cfg: GlobalModelConfig,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    l2: float = 1e-6,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
    mesh: Optional[Mesh] = None,
) -> List[Dict]:
    """The global sweep solved instead of trained: one tower pass builds
    the stat cache, then every grid point is one ridge solve
    (``fit_conv_head_closed_form``) over the whole cache, on every rank of
    ``mesh`` (None: ``tcfg.mesh`` over the ranks).  The result contract of
    ``train_global_sweep_cached_stats``, with ``train_loss`` the solve's
    pre-ReLU train MSE; no epochs."""
    mesh = training_mesh(tcfg, mesh, device)
    dev = mesh.device
    _, cache, val_cache = _stat_caches(points, cfg, tcfg, train_loader,
                                       val_loader, backbone_params, mesh,
                                       fused_tower)
    cache = gathered(mesh, cache)
    keep = val_cache.mask.cpu().numpy() > 0
    heads, losses, preds = [], [], []
    for p in points:
        names = p.tap_names(cfg.backbone.kind)
        fit = fit_conv_head_closed_form(cache, names, l2=l2,
                                        label_transform=p.label_transform)
        head = conv_head_from_params(fit["params"]).to(dev)
        with torch.no_grad():
            preds.append(_predict(head, val_cache, names).cpu().numpy()[keep])
        heads.append(head)
        losses.append(fit["train_mse"])
    return global_results(points, heads, losses, preds,
                          val_cache.y.cpu().numpy()[keep])


def train_global_sweep_cached_stats(
    points: Sequence[SweepPoint],
    cfg: GlobalModelConfig,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    closed_form_init: bool = False,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
    mesh: Optional[Mesh] = None,
) -> List[Dict]:
    """The global sweep trained entirely from per-layer diff statistics,
    over ``mesh`` (None: ``tcfg.mesh`` over the ranks).

    The contract of ``train_global_sweep_cached_diffs`` (one summary a
    point), the same head math (``conv_head_from_stats`` is the
    aggregator with the spatial mean commuted through the 1x1 conv), a
    cache ~400x smaller.  ``closed_form_init`` starts each point at its
    pre-ReLU ridge optimum instead of the random init; Adam then refines
    through the output ReLU."""
    mesh = training_mesh(tcfg, mesh, device)
    dev = mesh.device
    kind = cfg.backbone.kind
    gen, cache, val_cache = _stat_caches(points, cfg, tcfg, train_loader,
                                         val_loader, backbone_params, mesh,
                                         fused_tower)
    names = [p.tap_names(kind) for p in points]
    if closed_form_init:
        whole = gathered(mesh, cache)
        heads = [conv_head_from_params(fit_conv_head_closed_form(
            whole, nm, label_transform=p.label_transform)["params"])
            for p, nm in zip(points, names)]
    else:
        heads = point_heads(points, kind, gen)
    heads = replicate(mesh, [h.to(dev) for h in heads])
    opts = [torch.optim.Adam(h.parameters(), lr=tcfg.lr) for h in heads]

    losses = torch.zeros(len(points))
    for _ in range(tcfg.epochs):
        for idx in torch.randperm(cache.n_batches, generator=gen).tolist():
            y, mask = cache.y[idx], cache.mask[idx]
            losses = torch.stack([
                adam_step(opt, masked_mse(
                    conv_head_from_stats(h, [cache.stats[n][idx] for n in nm]),
                    labels_for(p, y), mask, mesh), mesh)
                for p, h, opt, nm in zip(points, heads, opts, names)])
    losses = losses.cpu().numpy()

    keep = val_cache.mask.cpu().numpy() > 0
    with torch.no_grad():
        preds = [_predict(h, val_cache, nm).cpu().numpy()[keep]
                 for h, nm in zip(heads, names)]
    return global_results(points, heads, losses, preds,
                          val_cache.y.cpu().numpy()[keep])
