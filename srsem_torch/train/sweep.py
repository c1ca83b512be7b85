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

``run_clu_sweep(shared_thresholds=True)`` trains a frozen-tower cell's
whole threshold axis in one run (srsem_torch/train/multisweep.py); LoRA and
full fine-tune cells train one run a point.  ``run_global_sweep_amortized``
is ``sweep-global``'s fast paths: the shared tower, the diff cache, the
stat cache and the closed form.
"""

from __future__ import annotations

import contextlib
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
    UserStudyScores,
    split_loaders,
)
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.train.diffcache import train_global_sweep_cached_diffs
from srsem_torch.train.loop import train_global, train_local
from srsem_torch.train.multisweep import (
    depth_grid,
    train_global_sweep_shared_tower,
    train_local_sweep_shared_tower,
)
from srsem_torch.train.statcache import (
    solve_global_sweep_closed_form,
    train_global_sweep_cached_stats,
)

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
        result = train_global(cfg, tcfg, *split_loaders(ds, tcfg),
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
        result = train_local(cfg, tcfg, *split_loaders(ds, tcfg),
                             backbone_params=backbone_params, **train_kw)
        return result.val_metrics

    return train_fn


def _timed(train_fn: Callable, point: Dict[str, Any]) -> Dict[str, Any]:
    """``train_fn(point)``'s summary with the point's name and seconds."""
    t0 = time.time()
    summary = dict(train_fn(point))
    return {"name": run_name(point), "point": point,
            "seconds": time.time() - t0, **summary}


def _record(results: list, f, rec: Dict[str, Any]) -> None:
    results.append(rec)
    if f:
        f.write(json.dumps(rec, default=str) + "\n")
        f.flush()


def run_sweep(
    train_fn: Callable[[Dict[str, Any]], Mapping[str, Any]],
    axes: Mapping[str, Sequence[Any]],
    summary_path: Optional[str] = None,
) -> list:
    """Run ``train_fn(point)`` for every grid point; collect summaries."""
    results: list = []
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(summary_path, "a")) if summary_path else None
        for point in grid_points(axes):
            _record(results, f, _timed(train_fn, point))
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
    """The CLU grid, optionally with the threshold axis trained N-for-1.

    ``shared_thresholds=False`` is ``run_sweep(make_clu_train_fn(...))``.
    With it on, every frozen-tower cell (``lora_rank=None``) trains its
    whole ``threshold`` axis in one run — one tower stream, one host
    decode, one decoder a binarization point
    (srsem_torch/train/multisweep.py::train_local_sweep_shared_tower): the
    reference's 72 frozen-tower agent runs
    (CLU_training_sweep_example.py:78-89,184-197) become 24.  LoRA and
    full points train the tower, so they run standalone a point."""
    plain_fn = make_clu_train_fn(csv_path, base_tcfg,
                                 backbone_params=backbone_params, **train_kw)
    if not shared_thresholds:
        return run_sweep(plain_fn, axes, summary_path=summary_path)

    thresholds = list(axes.get("threshold", [None]))
    outer = {k: v for k, v in axes.items() if k != "threshold"}
    results: list = []
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(summary_path, "a")) if summary_path else None
        for cell in grid_points(outer):
            if cell.get("lora_rank") is not None:
                # The tower trains: nothing to share.
                for t in thresholds:
                    _record(results, f,
                            _timed(plain_fn, {**cell, "threshold": t}))
                continue
            tcfg = base_tcfg or TrainConfig(batch_size=80, epochs=60)
            cfg = LocalModelConfig(
                backbone=BackboneConfig(kind=cell["backbone_kind"]),
                lora_rank=None)
            pre = Preprocess.for_backbone(cell["backbone_kind"],
                                          cfg.backbone.image_size)
            ds = KoniqPairsMapsDataset(
                csv_path, pre, only_hq=cell["only_hq"],
                imgamincaps=cell["imgamincaps"], thresholds=thresholds)
            t0 = time.time()
            cell_results = train_local_sweep_shared_tower(
                thresholds, cfg, tcfg, *split_loaders(ds, tcfg),
                backbone_params=backbone_params, **train_kw)
            dt = time.time() - t0
            for t, r in zip(thresholds, cell_results):
                point = {**cell, "threshold": t}
                _record(results, f, {
                    "name": run_name(point), "point": point, "seconds": dt,
                    "shared_thresholds": True, "mse": r["val_mse"],
                    "train_loss": r["train_loss"]})
    return results


#: sweep-global's fast paths, by flag.
AMORTIZED_MODES = ("shared_tower", "cached_diffs", "cached_stats",
                   "closed_form")


def run_global_sweep_amortized(csv_path: str, root: str, mode: str,
                               backbone: str = "resnet50_clip",
                               l2: float = 1e-6, backbone_params=None,
                               **train_kw) -> List[Dict]:
    """The reference's global depth grid at the package defaults (batch 5,
    30 epochs, 224 px), one tower stream for every point: ``mode`` is one
    of ``AMORTIZED_MODES`` — the shared tower
    (srsem_torch/train/multisweep.py), the diff cache
    (srsem_torch/train/diffcache.py), the stat cache or the closed form
    with ridge ``l2`` (srsem_torch/train/statcache.py).  ``train_kw``
    (``device``, ``fused_tower``) go to the trainer.  One summary a
    point."""
    tcfg = TrainConfig()
    cfg = GlobalModelConfig(backbone=BackboneConfig(kind=backbone),
                            head="stages_cnn", depth=3)
    pre = Preprocess.for_backbone(backbone, cfg.backbone.image_size)
    loaders = split_loaders(UserStudyScores(csv_path, root, pre), tcfg)
    kw = {"backbone_params": backbone_params, **train_kw}
    if mode == "closed_form":
        return solve_global_sweep_closed_form(depth_grid(), cfg, tcfg,
                                              *loaders, l2=l2, **kw)
    fn = {"shared_tower": train_global_sweep_shared_tower,
          "cached_diffs": train_global_sweep_cached_diffs,
          "cached_stats": train_global_sweep_cached_stats}[mode]
    return fn(depth_grid(), cfg, tcfg, *loaders, **kw)
