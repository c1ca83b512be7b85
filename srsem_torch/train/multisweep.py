"""Shared-tower sweep training: N sweep points, one frozen-tower pass — the
port of srsem/train/multisweep.py.

The reference forks one process a GPU and lets each wandb agent train one
grid point (reference: CLU_training_sweep_example.py:184-197).  Here one
step runs the frozen tower once a batch and trains every point's head (or
CLU decoder) on the shared taps.  For the global depth grid (reference:
CLIPLPIPS_REG_training_sweep_example.py:107-114 — depth ∈ {1,2,3}, same
data, same split) the tower is most of a step, so the three points train
for about the price of one run.

The tower goes through ``frozen_tower`` (srsem_torch/train/loop.py): the
Hopper bottleneck kernels on the card unless ``fused_tower=False``, one
pass over the 2N images of a pair batch (the JAX package runs a and b
apart so that a data-sharded batch needs no reshard; one card has no
mesh, and the frozen BN makes the two the same numbers).

Initial weights (the tower when no ``backbone_params`` is given, then the
heads in point order) and every shuffle come from one ``torch.Generator``
seeded with ``tcfg.seed``, where JAX draws each head from
``fold_in(PRNGKey(seed), i)``: the same distributions, other bits.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from srsem_torch.backbones.fused_resnet import resolve_fused_tower
from srsem_torch.backbones.resnet import make_backbone, reset_tower
from srsem_torch.config import GlobalModelConfig, TrainConfig
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.models.global_models import (
    ConvHeadAggregator,
    squared_diffs,
    stage_taps_for,
    tap_channels,
    wperlay_taps,
)
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train.loop import batch_to_device, frozen_tower
from srsem_torch.train.metrics import mse as mse_metric, srcc
from srsem_torch.train.steps import masked_mse
from srsem_torch.utils.convert import (
    jax_head_params,
    jax_trainable_params,
    load_backbone_params,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class SweepPoint:
    """One grid point: a head over a tap subset + optional label map."""

    name: str
    depth: int
    head: str = "stages_cnn"
    label_transform: Optional[Callable] = None  # labels -> labels (tensors)

    def tap_names(self, backbone_kind: str):
        if self.head == "stages_cnn":
            return stage_taps_for(backbone_kind, self.depth)
        if self.head == "wperlay_cnn":
            return wperlay_taps(self.depth)
        raise ValueError(
            f"shared-tower sweep supports conv heads, got {self.head!r}")


def depth_grid(depths: Sequence[int] = (1, 2, 3),
               head: str = "stages_cnn") -> List[SweepPoint]:
    """The reference's global sweep grid
    (CLIPLPIPS_REG_training_sweep_example.py:107-114)."""
    return [SweepPoint(name=f"depth-{d}", depth=d, head=head) for d in depths]


def sweep_tower(cfg, backbone_params, generator: torch.Generator,
                device: torch.device, fused_tower: Optional[bool] = None):
    """The frozen tower of a sweep on ``device``: ``backbone_params`` (a
    JAX-layout tree or a torchvision / OpenAI-CLIP state dict, CLI
    ``--backbone-checkpoint``), or weights drawn from ``generator`` (the
    zero-egress fallback).  Returns ``x -> (embedding, taps)``."""
    backbone = make_backbone(cfg.backbone)
    if backbone_params is None:
        reset_tower(backbone, generator)
    else:
        load_backbone_params(backbone, cfg.backbone.kind, backbone_params)
    backbone.to(device).eval().requires_grad_(False)
    return frozen_tower(backbone, cfg.backbone.kind,
                        resolve_fused_tower(fused_tower, True))


@torch.no_grad()
def pair_taps(tower, a: Tensor, b: Tensor, names):
    """The taps ``names`` of a and b from one tower pass over the 2N
    images."""
    n = a.shape[0]
    _, taps = tower(torch.cat([a, b], dim=0))
    return ({k: taps[k][:n] for k in names}, {k: taps[k][n:] for k in names})


def point_heads(points: Sequence[SweepPoint], kind: str,
                generator: torch.Generator) -> List[ConvHeadAggregator]:
    """One ConvHeadAggregator a point (JAX's default ``"live"`` bias), drawn
    from ``generator`` in point order."""
    heads = []
    for p in points:
        head = ConvHeadAggregator([tap_channels(n) for n in p.tap_names(kind)])
        head.reset_parameters(generator)
        heads.append(head)
    return heads


def labels_for(point: SweepPoint, y: Tensor) -> Tensor:
    return point.label_transform(y) if point.label_transform else y


def adam_step(optimizer: torch.optim.Optimizer, loss: Tensor) -> Tensor:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def global_results(points, heads, losses, preds: List[np.ndarray],
                   y_true: np.ndarray) -> List[Dict]:
    """One summary a point: ``{name, train_loss, val_srcc, val_mse,
    head_params}`` (the head in the JAX layout)."""
    results = []
    for i, p in enumerate(points):
        y_ref = (labels_for(p, torch.from_numpy(y_true)).numpy()
                 if p.label_transform else y_true)
        results.append({
            "name": p.name,
            "train_loss": float(losses[i]),
            "val_srcc": float(srcc(preds[i], y_ref)),
            "val_mse": float(mse_metric(preds[i], y_ref)),
            "head_params": jax_head_params(heads[i]),
        })
    return results


def train_global_sweep_shared_tower(
    points: Sequence[SweepPoint],
    cfg: GlobalModelConfig,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
) -> List[Dict]:
    """Train every point's head at once over one tower stream.

    Returns one summary dict a point: ``{name, train_loss, val_srcc,
    val_mse, head_params}``, ``train_loss`` the last batch's."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(tcfg.seed)
    kind = cfg.backbone.kind
    tower = sweep_tower(cfg, backbone_params, gen, dev, fused_tower)
    heads = [h.to(dev) for h in point_heads(points, kind, gen)]
    opts = [torch.optim.Adam(h.parameters(), lr=tcfg.lr) for h in heads]
    names = [p.tap_names(kind) for p in points]
    union = sorted({n for nm in names for n in nm})

    losses = torch.zeros(len(points))
    for _ in range(tcfg.epochs):
        for batch in train_loader:
            a, b, y, mask = batch_to_device(batch, dev)
            taps_a, taps_b = pair_taps(tower, a, b, union)
            losses = torch.stack([
                adam_step(opt, masked_mse(
                    head(squared_diffs(taps_a, taps_b, nm)),
                    labels_for(p, y.float()), mask))
                for p, head, opt, nm in zip(points, heads, opts, names)])
    losses = losses.cpu().numpy()

    preds: List[List[np.ndarray]] = [[] for _ in points]
    targets = []
    with torch.no_grad():
        for batch in val_loader:
            ((_, _), y), mask = batch
            keep = np.asarray(mask) > 0
            a, b, _, _ = batch_to_device(batch, dev)
            taps_a, taps_b = pair_taps(tower, a, b, union)
            for i, (head, nm) in enumerate(zip(heads, names)):
                pred = head(squared_diffs(taps_a, taps_b, nm))
                preds[i].append(pred.float().cpu().numpy()[keep])
            targets.append(np.asarray(y, np.float32)[keep])
    return global_results(points, heads, losses,
                          [np.concatenate(p) for p in preds],
                          np.concatenate(targets))


def local_sweep_models(cfg, tcfg: TrainConfig, n: int, backbone_params,
                       device: torch.device, fused_tower: Optional[bool]):
    """``n`` CluUnets from one init (what ``train_local`` draws from
    ``tcfg.seed``; the dataset never affects it), sharing one frozen tower
    on ``device``, and that tower's ``x -> (embedding, taps)``."""
    if cfg.lora_rank is not None:
        raise ValueError("shared-tower CLU sweep needs a frozen tower "
                         "(lora_rank=None); LoRA/full points train the "
                         "tower and cannot share it")
    model = make_local_model(
        cfg, generator=torch.Generator().manual_seed(tcfg.seed))
    if backbone_params is not None:
        load_backbone_params(model.backbone, cfg.backbone.kind,
                             backbone_params)
    backbone = model.backbone.to(device)
    models = []
    for _ in range(n):
        # The memo shares the tower instead of copying it.
        m = copy.deepcopy(model, {id(backbone): backbone}).to(device)
        m.decoder.requires_grad_(True)
        models.append(m)
    tower = frozen_tower(backbone, cfg.backbone.kind,
                         resolve_fused_tower(fused_tower, True))
    return models, tower


def train_local_sweep_shared_tower(
    thresholds: Sequence[Optional[float]],
    cfg,
    tcfg: TrainConfig,
    train_loader,
    val_loader,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
) -> List[Dict]:
    """CLU threshold sweep: N binarization points, one tower stream.

    The reference CLU grid (CLU_training_sweep_example.py:78-89) varies
    ``threshold ∈ {None, 0.4, 0.9}``, a label-space axis: the images, the
    frozen tower and the squared-diff pyramids are the same for every
    point.  One tower pass a batch feeds one decoder a threshold, each
    trained on its own labels, which the dataset binarizes then resizes
    (``KoniqPairsMapsDataset(thresholds=...)``): loaders yield labels
    (N, T, H, W) in threshold order.  Every decoder starts from the same
    init, so each point follows its standalone run.  Needs a frozen tower
    (``lora_rank`` None: JAX's ``ValueError`` otherwise).

    Returns one summary a threshold: ``{name, train_loss, val_mse,
    trainable, batch_stats}`` (JAX layout)."""
    dev = resolve_device(device)
    models, tower = local_sweep_models(cfg, tcfg, len(thresholds),
                                       backbone_params, dev, fused_tower)
    names = models[0].tap_names
    opts = [torch.optim.Adam(m.decoder.parameters(), lr=tcfg.lr)
            for m in models]

    losses = torch.zeros(len(models))
    for _ in range(tcfg.epochs):
        for batch in train_loader:
            a, b, y, mask = batch_to_device(batch, dev)
            taps_a, taps_b = pair_taps(tower, a, b, names)
            losses = torch.stack([
                adam_step(opt, masked_mse(
                    m.decode_from_taps(taps_a, taps_b, a, b, train=True),
                    y[:, i], mask))
                for i, (m, opt) in enumerate(zip(models, opts))])
    losses = losses.cpu().numpy()

    sq_err = np.zeros(len(models))
    n_valid = 0
    with torch.no_grad():
        for batch in val_loader:
            ((_, _), y), mask = batch
            keep = np.asarray(mask) > 0
            a, b, _, _ = batch_to_device(batch, dev)
            taps_a, taps_b = pair_taps(tower, a, b, names)
            y_np = np.asarray(y, np.float32)
            for i, m in enumerate(models):
                pred = m.decode_from_taps(taps_a, taps_b, a, b).float()
                sq_err[i] += float(((pred.cpu().numpy()[keep]
                                     - y_np[keep][:, i]) ** 2).sum())
            n_valid += int(keep.sum()) * y_np.shape[-2] * y_np.shape[-1]

    out = []
    for i, (t, m) in enumerate(zip(thresholds, models)):
        trainable, stats = jax_trainable_params(m)
        out.append({"name": f"threshold-{t}", "train_loss": float(losses[i]),
                    "val_mse": sq_err[i] / max(n_valid, 1),
                    "trainable": trainable, "batch_stats": stats})
    return out
