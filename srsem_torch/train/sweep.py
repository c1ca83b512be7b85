"""Grid sweeps — the port of srsem/train/sweep.py.

The reference launches ``wandb.agent`` processes a GPU (reference:
CLU_training_sweep_example.py:181-197) to grid over hyperparameters; here
one process trains the points one after the other on one card and
appends a summary line a point to a JSONL file.

Reference grids:

* global: depth ∈ {1,2,3}, lr=1e-4
  (reference: CLIPLPIPS_REG_training_sweep_example.py:107-114);
* CLU: min_caps ∈ {2,4,8,16}, only_hq ∈ {T,F}, lora_rank ∈ {None,32,"full"},
  threshold ∈ {None,0.4,0.9}, backbone ∈ {clip, imagenet}
  (reference: CLU_training_sweep_example.py:78-89).

Points that train the tower (``lora_rank`` set) wait for ROADMAP A7 and
the shared-threshold CLU sweep for A8: both raise before any point
trains.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence

from srsem_torch.config import (
    BackboneConfig,
    GlobalModelConfig,
    LocalModelConfig,
    TrainConfig,
)
from srsem_torch.data.datasets import (
    KoniqPairsMapsDataset,
    Subset,
    UserStudyScores,
    seeded_split,
)
from srsem_torch.data.loader import Loader
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.train.loop import train_global, train_local

GLOBAL_SWEEP: Dict[str, Sequence[Any]] = {"depth": [1, 2, 3]}

CLU_SWEEP: Dict[str, Sequence[Any]] = {
    "imgamincaps": [2, 4, 8, 16],
    "only_hq": [True, False],
    "lora_rank": [None, 32, "full"],
    "threshold": [None, 0.4, 0.9],
    "backbone_kind": ["resnet50_clip", "resnet50"],
}


def run_name(point: Mapping[str, Any], prefix: str = "run") -> str:
    """Run name from the point's values, like the reference's wandb run
    names (reference: CLIPLPIPS_REG_training_sweep_example.py:120-127)."""
    parts = [f"{k}-{v}" for k, v in sorted(point.items())]
    return "_".join([prefix] + parts)


def grid_points(axes: Mapping[str, Sequence[Any]]) -> Iterable[Dict[str, Any]]:
    keys = list(axes)
    for values in itertools.product(*(axes[k] for k in keys)):
        yield dict(zip(keys, values))


def make_global_train_fn(csv_path: str, root: str, base_tcfg=None,
                         backbone: str = "resnet50_clip",
                         backbone_params=None, **train_kw):
    """Grid point {depth} → one global-regressor training run
    (reference: CLIPLPIPS_REG_training_sweep_example.py:118-199).
    ``backbone_params``: the tower every point trains on (CLI
    ``--backbone-checkpoint``); ``train_kw`` (``device``, ``fused_tower``)
    go to ``run_training``."""

    def train_fn(point):
        tcfg = base_tcfg or TrainConfig()
        cfg = GlobalModelConfig(backbone=BackboneConfig(kind=backbone),
                                head="stages_cnn", depth=point["depth"])
        pre = Preprocess.for_backbone(backbone, cfg.backbone.image_size)
        ds = UserStudyScores(csv_path, root, pre)
        tr, va = seeded_split(len(ds), tcfg.val_fraction, tcfg.seed)
        result = train_global(
            cfg, tcfg,
            Loader(Subset(ds, tr), tcfg.batch_size, shuffle=True, seed=tcfg.seed),
            Loader(Subset(ds, va), tcfg.batch_size),
            backbone_params=backbone_params, **train_kw)
        return result.val_metrics

    return train_fn


def make_clu_train_fn(csv_path: str, base_tcfg=None, backbone_params=None,
                      **train_kw):
    """Grid point {imgamincaps, only_hq, lora_rank, threshold,
    backbone_kind} → one CLU training run
    (reference: CLU_training_sweep_example.py:92-180).  The dataset
    binarizes the maps (``threshold``), then resizes them, as the
    reference does."""

    def train_fn(point):
        tcfg = base_tcfg or TrainConfig(batch_size=80, epochs=60)
        cfg = LocalModelConfig(
            backbone=BackboneConfig(kind=point["backbone_kind"]),
            lora_rank=point["lora_rank"])
        pre = Preprocess.for_backbone(point["backbone_kind"],
                                      cfg.backbone.image_size)
        ds = KoniqPairsMapsDataset(
            csv_path, pre, only_hq=point["only_hq"],
            imgamincaps=point["imgamincaps"], threshold=point["threshold"])
        tr, va = seeded_split(len(ds), tcfg.val_fraction, tcfg.seed)
        result = train_local(
            cfg, tcfg,
            Loader(Subset(ds, tr), tcfg.batch_size, shuffle=True, seed=tcfg.seed),
            Loader(Subset(ds, va), tcfg.batch_size),
            backbone_params=backbone_params, **train_kw)
        return result.val_metrics

    return train_fn


def _check_points(points: List[Dict[str, Any]]) -> None:
    """Points that train the tower raise before any point trains."""
    lora = [p for p in points if p.get("lora_rank") is not None]
    if lora:
        raise NotImplementedError(
            f"{len(lora)} grid points set lora_rank (LoRA or the full "
            "fine-tune), which is not ported yet (ROADMAP A7): restrict "
            "the axis, e.g. --limit-axis lora_rank=None")


def run_sweep(
    train_fn: Callable[[Dict[str, Any]], Mapping[str, Any]],
    axes: Mapping[str, Sequence[Any]],
    summary_path: Optional[str] = None,
) -> list:
    """Run ``train_fn(point)`` for every grid point; collect summaries."""
    points = list(grid_points(axes))
    _check_points(points)
    results = []
    f = open(summary_path, "a") if summary_path else None
    try:
        for point in points:
            t0 = time.time()
            summary = dict(train_fn(point))
            rec = {"name": run_name(point), "point": point,
                   "seconds": time.time() - t0, **summary}
            results.append(rec)
            if f:
                f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
    finally:
        if f:
            f.close()
    return results


def run_clu_sweep(
    csv_path: str,
    axes: Mapping[str, Sequence[Any]],
    base_tcfg=None,
    summary_path: Optional[str] = None,
    shared_thresholds: bool = False,
    backbone_params=None,
    **train_kw,
) -> list:
    """The CLU grid, one standalone run a point.  ``shared_thresholds``
    (one run for a cell's whole threshold axis, srsem/train/multisweep.py)
    waits for ROADMAP A8."""
    if shared_thresholds:
        raise NotImplementedError(
            "the shared-threshold CLU sweep (multisweep) is not ported yet "
            "(ROADMAP A8)")
    return run_sweep(
        make_clu_train_fn(csv_path, base_tcfg,
                          backbone_params=backbone_params, **train_kw),
        axes, summary_path=summary_path)
