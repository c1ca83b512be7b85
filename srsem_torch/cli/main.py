"""``python -m srsem_torch`` — the port's command line (the ``score``,
``score-groups``, ``score-maps-groups``, ``serve``, ``sweep-dataset``,
``train-global``, ``eval-global``, ``train-clu``, ``sweep-global``,
``sweep-clu``, ``folder-metrics``, ``train-nr-iqa``, ``pseudo-c2c``,
``pseudo-captions``, ``maps-build``, ``convert``, ``info``,
``visualize`` and ``saliency`` subcommands of srsem/cli/main.py, all 19,
and the global ``--profile DIR``).

    python -m srsem_torch score pairs.csv --backbone resnet50 [--device cpu]
    python -m srsem_torch score pairs.csv --backbone resnet50_clip \
        --set head=wperlay_cnn --set depth=11 --checkpoint CKPT_DIR
    python -m srsem_torch score pairs.csv --backbone vit_clip \
        --set head=stages_vit --backbone-checkpoint vit.msgpack
    python -m srsem_torch score-groups GT_DIR SR_DIR... [--device cpu] \
        [--backbone vit_clip --set head=wperlay_vit --set depth=11]
    python -m srsem_torch score-maps-groups GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch serve --warmup-k 1 4 --with-maps < requests.jsonl
    python -m srsem_torch sweep-dataset GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch train-global study.csv ROOT [--device cpu] \
        [--checkpoint-dir DIR] [--train-set epochs=1]
    python -m srsem_torch eval-global study.csv ROOT --checkpoint DIR
    python -m srsem_torch train-clu pairs.csv [--checkpoint-dir DIR] \
        [--set lora_rank=32 | --cached-diffs | --thresholds none 0.4 0.9]
    python -m srsem_torch sweep-global study.csv ROOT [--shared-tower | \
        --cached-diffs | --cached-stats | --closed-form [--l2 1e-6]]
    python -m srsem_torch sweep-clu pairs.csv [--shared-thresholds]
    python -m srsem_torch folder-metrics GT_DIR SR_DIR... \
        [--koniqpp-checkpoint DIR] [--lpips-checkpoint alex.pth]
    python -m srsem_torch train-nr-iqa IMAGE_DIR --checkpoint-dir DIR
    python -m srsem_torch pseudo-c2c ROOT [--embedder minilm:CKPT:TOK_DIR]
    python -m srsem_torch maps-build pairs.csv [--out-dir DIR]
    python -m srsem_torch convert vit.pt --kind clip_vit --out vit.msgpack
    python -m srsem_torch info [--native] [--devices]
    python -m srsem_torch visualize overlay --image IMG --map MAP.npy --out o.png
    python -m srsem_torch saliency --images IMG_DIR --out SaliencyMaps \
        --checkpoint transalnet.msgpack [--device cpu]
    python -m srsem_torch --profile DIR score-groups GT_DIR SR_DIR...

Flags follow srsem/cli/main.py (:957-1072, :1119-1205, :1206-1246,
:1275-1295 and :1297-1328), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path) and
``--no-fused-tower`` / ``--no-fused-decoder`` (the port runs its Hopper
kernels by default; the fused tower serves the frozen base tower only, so
by default a LoRA or trained tower runs as the module, and
``--fused-tower`` with one raises; the ViT always runs as its module).
``--checkpoint DIR`` reads the JAX package's
checkpoint directories (``latest.json`` + ``step_N.msgpack``, through
srsem_torch/train/checkpoint.py) and loads their ``trainable`` subset, and
for CLU maps their ``batch_stats``, over the model, as the JAX CLI's
``merge_params`` does.  ``--backbone-checkpoint`` takes a converted tower
param tree (``.msgpack``, ``convert``'s output, the port's or the JAX
CLI's) or a torchvision ``resnet50`` / OpenAI-CLIP / timm or HF CLIP ViT
state dict (``.pt``).  ``convert`` writes the bytes ``srsem convert``
writes for all 14 kinds (``resnet50``, ``resnet50_clip``, ``clip_vit``,
``hf_clip_vit``, ``global_head``, ``clu_decoder``, ``lpips``,
``hf_clip_text``, ``clip_text``, ``minilm``, ``slip``, ``albef``,
``albef_fusion``, ``transalnet``).  Without either, the weights are
seeded random ones.  The training commands train the head or decoder,
and with ``--set enc_ft=True`` (global) or ``--set lora_rank=R`` /
``lora_rank='full'`` (CLU) the tower
(srsem_torch/train/loop.py), and write the JAX package's checkpoint
layout.  Their fast paths amortize the frozen tower: ``train-clu
--cached-diffs`` (srsem_torch/train/diffcache.py) and ``--thresholds``
(srsem_torch/train/multisweep.py, one checkpoint directory a threshold),
``sweep-global --shared-tower`` / ``--cached-diffs`` / ``--cached-stats``
/ ``--closed-form`` (srsem_torch/train/statcache.py) and ``sweep-clu
--shared-thresholds``.

Under ``torchrun`` (one process a card) the commands run over a mesh of
the world's ranks (srsem_torch/core/meshes.py): ``serve``, ``score*``,
``eval-global`` and ``sweep-dataset`` shard each batch over all of them,
the training and sweep commands over every rank on the data axis
(``train-global`` / ``train-clu``: ``--train-set mesh.data_axis=N``), and
only rank 0 writes files and prints.  One process runs as before.

    torchrun --nproc-per-node 2 -m srsem_torch train-global study.csv ROOT
    torchrun --nproc-per-node 2 -m srsem_torch serve < requests.jsonl
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import os
import sys
from typing import Any, Dict, List


def _is_main() -> bool:
    """``core.meshes.is_main``: the rank that writes files and prints
    (imported here, as this module imports no torch at its top)."""
    from srsem_torch.core.meshes import is_main

    return is_main()


def _parse_sets(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def _torch_load(path):
    """A torch ``.pth``/``.pt`` state dict, read as the JAX CLI reads a
    reference checkpoint: a pickled module gives its ``state_dict()``, and
    a dict wrapping one under ``state_dict`` or ``model`` is unwrapped.
    Unpickling runs the file's code: read only files you trust."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return sd


def _read_backbone(path):
    """A tower file's weights: a converted JAX tower param tree
    (``.msgpack``, ``srsem convert``) or a torchvision ``resnet50`` /
    OpenAI-CLIP state dict (``.pt``); None without a path."""
    if not path:
        return None
    if str(path).endswith(".msgpack"):
        from srsem_torch.train.checkpoint import msgpack_restore

        with open(path, "rb") as f:
            return msgpack_restore(f.read())
    return _torch_load(path)


def _load_backbone(backbone, kind: str, path) -> None:
    """A tower file (``_read_backbone``) into the tower."""
    params = _read_backbone(path)
    if params is not None:
        from srsem_torch.utils.convert import load_backbone_params

        load_backbone_params(backbone, kind, params)


def _load_checkpoint(model, directory) -> None:
    """The latest checkpoint under ``directory``: its ``trainable`` tree
    (and a CluUnet's ``batch_stats``) over the model's weights."""
    if not directory:
        return
    from srsem_torch.models.local_models import CluUnet
    from srsem_torch.train.checkpoint import restore_checkpoint
    from srsem_torch.utils.convert import (
        load_jax_global_params,
        load_jax_local_params,
    )

    restored = restore_checkpoint(directory)
    if isinstance(model, CluUnet):
        load_jax_local_params(model, {
            "params": restored["trainable"],
            "batch_stats": restored.get("batch_stats") or {}}, partial=True)
    else:
        load_jax_global_params(model, {"params": restored["trainable"]},
                               partial=True)


def cmd_score(args) -> int:
    import numpy as np
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig, override
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model

    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
    _load_checkpoint(model, args.checkpoint)

    with open(args.pairs_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    pairs = [(r[args.col_a], r[args.col_b]) for r in rows]
    scorer = PairScorer(cfg, model, batch_size=args.batch_size,
                        fused_tower=args.fused_tower,
                        fast_jpeg=args.fast_jpeg, device=args.device)
    scores = scorer.score_paths(pairs)
    if not _is_main():
        return 0
    fields = list(rows[0].keys()) if rows else [args.col_a, args.col_b]
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields + ["score"])
        writer.writeheader()
        for row, s in zip(rows, scores):
            writer.writerow({**row, "score": repr(float(s))})
    print(json.dumps({"pairs": len(pairs),
                      "nan": int(np.isnan(scores).sum()),
                      "device": str(scorer.device),
                      "out": args.out}))
    return 0


def _write_rows(path: str, rows: List[dict], key: str = "image_name") -> int:
    """Write row dicts (a ``key`` name column + float columns) with
    ``csv``; returns the number of rows holding a NaN."""
    import math

    fields = list(rows[0]) if rows else [key]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        for row in rows:
            writer.writerow({k: v if k == key else repr(float(v))
                             for k, v in row.items()})
    return sum(any(isinstance(v, float) and math.isnan(v) for v in r.values())
               for r in rows)


def cmd_score_groups(args) -> int:
    """Grouped GT-vs-K-SR scoring: one shared GT tower pass per group and
    one head launch a batch (srsem_torch/eval/grouped.py::GroupedPairScorer).
    ``--set`` overrides the configuration (``head=wperlay_vit``), which the
    JAX CLI fixes at stages_cnn."""
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig, override
    from srsem_torch.eval.grouped import GroupedPairScorer
    from srsem_torch.models.global_models import make_global_model

    cfg = override(GlobalModelConfig(
        backbone=BackboneConfig(kind=args.backbone, image_size=args.image_size,
                                compute_dtype=args.dtype),
        head="stages_cnn", depth=args.depth), _parse_sets(args.set))
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
    _load_checkpoint(model, args.checkpoint)
    scorer = GroupedPairScorer(cfg, model, k=len(args.sr_folders),
                               batch_size=args.batch_size,
                               fused_tower=args.fused_tower,
                               fast_jpeg=args.fast_jpeg, device=args.device)
    rows = scorer.score_folder_set(args.gt_folder, args.sr_folders)
    if not _is_main():
        return 0
    nan = _write_rows(args.out, rows)
    print(json.dumps({"groups": len(rows), "sr_models": len(args.sr_folders),
                      "nan_groups": nan, "device": str(scorer.device),
                      "out": args.out}))
    return 0


def cmd_score_maps_groups(args) -> int:
    """Grouped GT-vs-K-SR CLU map scoring: one shared GT tower pass per
    group (srsem_torch/eval/grouped.py::GroupedMapScorer)."""
    import torch

    from srsem_torch.config import BackboneConfig, LocalModelConfig, override
    from srsem_torch.eval.grouped import GroupedMapScorer
    from srsem_torch.models.local_models import make_local_model

    cfg = override(LocalModelConfig(
        backbone=BackboneConfig(kind=args.backbone, image_size=args.image_size,
                                compute_dtype=args.dtype),
        v2=args.v2), _parse_sets(args.set))
    model = make_local_model(cfg, generator=torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
    _load_checkpoint(model, args.checkpoint)
    scorer = GroupedMapScorer(cfg, model, k=len(args.sr_folders),
                              batch_size=args.batch_size,
                              fused_tower=args.fused_tower,
                              fused_decoder=args.fused_decoder,
                              fast_jpeg=args.fast_jpeg, device=args.device)
    rows = scorer.score_folder_set(args.gt_folder, args.sr_folders,
                                   maps_dir=args.maps_dir if _is_main()
                                   else None)
    if not _is_main():
        return 0
    nan = _write_rows(args.out, rows)
    print(json.dumps({"groups": len(rows), "sr_models": len(args.sr_folders),
                      "nan_groups": nan, "device": str(scorer.device),
                      "out": args.out, "maps_dir": args.maps_dir}))
    return 0


def cmd_serve(args) -> int:
    """Persistent scoring service (srsem_torch/cli/serve.py)."""
    from srsem_torch.cli.serve import run_serve

    return run_serve(args)


def cmd_sweep_dataset(args) -> int:
    """Global scores + CLU maps over GT/SR folders with one shared tower
    pass (srsem_torch/eval/dataset_sweep.py::DualScorer); one CSV a SR
    folder."""
    import torch

    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.eval.dataset_sweep import DualScorer
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import make_local_model

    bb = BackboneConfig(kind=args.backbone)
    gcfg = GlobalModelConfig(backbone=bb, head="stages_cnn", depth=3)
    lcfg = LocalModelConfig(backbone=bb)
    gmodel = make_global_model(gcfg, torch.Generator().manual_seed(0))
    lmodel = make_local_model(lcfg, generator=torch.Generator().manual_seed(1))
    scorer = DualScorer(gcfg, lcfg, gmodel, lmodel,
                        batch_size=args.batch_size,
                        fused_tower=args.fused_tower,
                        fused_decoder=args.fused_decoder,
                        fast_jpeg=args.fast_jpeg, device=args.device)
    summary = {}
    for sr_folder in args.sr_folders:
        rows = scorer.score_folders(args.gt_folder, sr_folder)
        out = args.out_template.format(
            folder=sr_folder.rstrip("/").split("/")[-1])
        if _is_main():
            nan = _write_rows(out, rows, key="image")
            summary[sr_folder] = {"pairs": len(rows), "nan": nan, "out": out}
    if _is_main():
        print(json.dumps({**summary, "device": str(scorer.device)}))
    return 0


def _train_kw(args) -> Dict[str, Any]:
    """run_training's keywords from the flags; a missing card fails here,
    before any data or weights load."""
    from srsem_torch.device import resolve_device

    return {"device": resolve_device(args.device),
            "fused_tower": args.fused_tower,
            "backbone_params": _read_backbone(args.backbone_checkpoint)}


def cmd_train_global(args) -> int:
    """Train a global regressor's head on the frozen tower
    (srsem_torch/train/loop.py::train_global)."""
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        TrainConfig,
        override,
    )
    from srsem_torch.data.datasets import UserStudyScores, split_loaders
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.train.loop import train_global

    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    tcfg = override(TrainConfig(checkpoint_dir=args.checkpoint_dir),
                    _parse_sets(args.train_set))
    pre = Preprocess.for_backbone(cfg.backbone.kind, cfg.backbone.image_size)
    ds = UserStudyScores(args.csv, args.root, pre)
    result = train_global(cfg, tcfg, *split_loaders(ds, tcfg),
                          **_train_kw(args))
    if _is_main():
        print(json.dumps({"val_metrics": result.val_metrics,
                          "steps": result.step}))
    return 0


def cmd_eval_global(args) -> int:
    """SRCC/MSE of a (trained) global regressor against the user-study
    labels, scored through PairScorer (the bottleneck and head kernels on
    the card) — the reference's README table numbers (reference:
    README.md:98-105)."""
    import numpy as np
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig, override
    from srsem_torch.data.datasets import UserStudyScores, seeded_split
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.train.metrics import mse, srcc

    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
    _load_checkpoint(model, args.checkpoint)

    pre = Preprocess.for_backbone(cfg.backbone.kind, cfg.backbone.image_size)
    ds = UserStudyScores(args.csv, args.root, pre)
    idx = list(range(len(ds)))
    if args.val_only:
        # The held-out 20% of the seeded split (reference: split seed 42).
        _, val_idx = seeded_split(len(ds), 0.2, args.seed)
        idx = [int(i) for i in val_idx]
    pairs = [ds.paths(i) for i in idx]
    labels = np.array([ds.label(i) for i in idx])
    scorer = PairScorer(cfg, model, batch_size=args.batch_size,
                        fused_tower=args.fused_tower, device=args.device)
    scores = scorer.score_paths(pairs)
    if not _is_main():
        return 0
    valid = ~np.isnan(scores)
    print(json.dumps({"n": int(valid.sum()),
                      "srcc": srcc(scores[valid], labels[valid]),
                      "mse": mse(scores[valid], labels[valid])}))
    return 0


def cmd_train_clu(args) -> int:
    """Train a CLU map model's decoder, and with ``lora_rank`` the tower
    (srsem_torch/train/loop.py::train_local); ``--thresholds`` trains one
    decoder a threshold over one tower stream, ``--cached-diffs`` the
    decoder on a diff cache built in one tower pass."""
    from srsem_torch.config import (
        BackboneConfig,
        LocalModelConfig,
        TrainConfig,
        override,
    )
    from srsem_torch.data.datasets import KoniqPairsMapsDataset, split_loaders
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.train.checkpoint import save_checkpoint
    from srsem_torch.train.loop import train_local

    cfg = override(
        LocalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    tcfg = override(
        TrainConfig(batch_size=80, epochs=60, checkpoint_dir=args.checkpoint_dir),
        _parse_sets(args.train_set))
    pre = Preprocess.for_backbone(cfg.backbone.kind, cfg.backbone.image_size)
    thresholds = None
    if args.thresholds:
        thresholds = [None if t.lower() in ("none", "null") else float(t)
                      for t in args.thresholds]
        if args.cached_diffs:
            raise SystemExit("--thresholds and --cached-diffs are separate "
                             "fast paths; pick one")
    kw = _train_kw(args)
    ds = KoniqPairsMapsDataset(args.csv, pre, only_hq=args.only_hq,
                               imgamincaps=args.min_caps,
                               threshold=tcfg.map_threshold,
                               thresholds=thresholds)
    train_loader, val_loader = split_loaders(ds, tcfg)
    if thresholds is not None:
        from srsem_torch.train.multisweep import train_local_sweep_shared_tower

        results = train_local_sweep_shared_tower(
            thresholds, cfg, tcfg, train_loader, val_loader, **kw)
        if not _is_main():
            return 0
        if tcfg.checkpoint_dir:
            for r in results:
                save_checkpoint(os.path.join(tcfg.checkpoint_dir, r["name"]),
                                tcfg.epochs, {"trainable": r["trainable"],
                                              "batch_stats": r["batch_stats"]})
        print(json.dumps([{k: r[k] for k in ("name", "train_loss", "val_mse")}
                          for r in results]))
        return 0
    if args.cached_diffs:
        from srsem_torch.train.diffcache import train_local_cached_diffs

        result = train_local_cached_diffs(cfg, tcfg, train_loader, val_loader,
                                          **kw)
        if not _is_main():
            return 0
        if tcfg.checkpoint_dir:
            save_checkpoint(tcfg.checkpoint_dir, tcfg.epochs, {
                "trainable": result["trainable"],
                "batch_stats": result["batch_stats"]})
        print(json.dumps({"val_metrics": {"mse": result["val_mse"]},
                          "train_loss": result["train_loss"]}))
        return 0
    result = train_local(cfg, tcfg, train_loader, val_loader, **kw)
    if _is_main():
        print(json.dumps({"val_metrics": result.val_metrics,
                          "steps": result.step}))
    return 0


def cmd_sweep_global(args) -> int:
    """The reference's global depth grid: one training run a point, or
    with a fast path every point over one tower stream (the shared tower,
    the diff cache, the stat cache, the closed form)."""
    from srsem_torch.train.sweep import (
        AMORTIZED_MODES,
        GLOBAL_SWEEP,
        make_global_train_fn,
        run_global_sweep_amortized,
        run_sweep,
    )

    # The first flag set, in JAX's order of precedence.
    mode = next((m for m in reversed(AMORTIZED_MODES) if getattr(args, m)),
                None)
    if mode:
        results = run_global_sweep_amortized(
            args.csv, args.root, mode, backbone=args.backbone, l2=args.l2,
            **_train_kw(args))
        if _is_main():
            print(json.dumps([{"name": r["name"], "val_srcc": r["val_srcc"],
                               "val_mse": r["val_mse"]} for r in results]))
        return 0
    results = run_sweep(
        make_global_train_fn(args.csv, args.root, backbone=args.backbone,
                             **_train_kw(args)),
        GLOBAL_SWEEP, summary_path=args.summary if _is_main() else None)
    if not _is_main():
        return 0
    print(json.dumps([{"name": r["name"],
                       "val_srcc": r.get("srcc"),
                       "val_mse": r.get("mse")} for r in results]))
    return 0


def cmd_sweep_clu(args) -> int:
    """The reference's CLU grid, one training run a point
    (``--limit-axis key=value`` restricts an axis)."""
    from srsem_torch.train.sweep import CLU_SWEEP, run_clu_sweep

    axes = dict(CLU_SWEEP)
    for spec in args.limit_axis:
        key, _, raw = spec.partition("=")
        axes[key] = [ast.literal_eval(raw) if raw != "None" else None]
    results = run_clu_sweep(args.csv, axes,
                            summary_path=args.summary if _is_main() else None,
                            shared_thresholds=args.shared_thresholds,
                            **_train_kw(args))
    if _is_main():
        print(json.dumps({"points": len(results)}))
    return 0


def cmd_folder_metrics(args) -> int:
    """SSIM, PSNR, LPIPS (and with ``--koniqpp-checkpoint`` the five
    KonIQ++ columns) of each SR folder against the GT folder: one
    ``metrics.csv`` a folder (srsem_torch/eval/folder_metrics.py)."""
    from srsem_torch.device import resolve_device
    from srsem_torch.eval.folder_metrics import (
        ImageQualityMetrics,
        run_folder_sweep,
    )

    device = resolve_device(args.device)
    lpips_fn = None
    if args.lpips_checkpoint:
        from srsem_torch.eval.lpips import make_lpips

        lpips_fn = make_lpips(
            args.lpips_net, lin_sd=_torch_load(args.lpips_checkpoint),
            tower_sd=(_torch_load(args.lpips_tower) if args.lpips_tower
                      else None), device=device)
    koniqpp = None
    if args.koniqpp_checkpoint:
        from srsem_torch.eval.nr_iqa import NrIqaScorer
        from srsem_torch.train.nr_iqa import load_nr_iqa_head

        koniqpp = NrIqaScorer(load_nr_iqa_head(args.koniqpp_checkpoint),
                              device=device)
    calc = ImageQualityMetrics(batch_size=args.batch_size,
                               lpips_net=args.lpips_net, lpips_fn=lpips_fn,
                               koniqpp=koniqpp, device=device)
    results = run_folder_sweep(args.gt_folder, args.eval_folders, calc)
    print(json.dumps({f: len(rows) for f, rows in results.items()}))
    return 0


def cmd_train_nr_iqa(args) -> int:
    """Train the NR-IQA head on synthetic degradations of a folder's
    images (srsem_torch/train/nr_iqa.py)."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from srsem_torch.data.preprocess import IMG_EXTENSIONS
    from srsem_torch.device import resolve_device
    from srsem_torch.train.nr_iqa import train_nr_iqa

    device = resolve_device(args.device)
    paths = sorted(p for p in Path(args.image_folder).iterdir()
                   if p.suffix.lower() in IMG_EXTENSIONS)
    if args.limit:
        paths = paths[: args.limit]
    imgs = np.stack([
        np.asarray(Image.open(p).convert("RGB").resize(
            (args.image_size, args.image_size), Image.BICUBIC), np.float32)
        / 255.0 for p in paths])
    result = train_nr_iqa(imgs, epochs=args.epochs,
                          batch_size=args.batch_size, lr=args.lr,
                          checkpoint_dir=args.checkpoint_dir, device=device)
    print(json.dumps({"images": len(imgs), "steps": len(result.losses),
                      "final_loss": result.losses[-1],
                      "val_mse": result.val_mse}))
    return 0


def _make_embedder(kind: str, device):
    """``hashing``, or ``minilm:<torch_ckpt>:<tokenizer_dir>``: an HF
    MiniLM state dict and the WordPiece ``vocab.txt`` in
    ``tokenizer_dir`` (the port's own tokenizer; the JAX CLI reads the
    directory with transformers' AutoTokenizer)."""
    if kind == "hashing":
        from srsem_torch.pseudo.text_embed import HashingTextEmbedder

        return HashingTextEmbedder()
    if kind.startswith("minilm:"):
        from srsem_torch.pseudo.text_embed import (
            MiniLMEmbedder,
            MiniLMEncoder,
            load_hf_minilm,
        )
        from srsem_torch.pseudo.tokenizer import WordPieceTokenizer

        _, ckpt, tok_dir = kind.split(":", 2)
        model = load_hf_minilm(MiniLMEncoder(), _torch_load(ckpt))
        tokenizer = WordPieceTokenizer(os.path.join(tok_dir, "vocab.txt"))
        return MiniLMEmbedder(model, tokenizer, device=device)
    raise ValueError(f"unknown embedder {kind!r}")


def _write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def cmd_pseudo_c2c(args) -> int:
    """Caption-to-caption cosines over the KonIQ SR folder layout: every
    (HQ, SR) and (SR, SR) pair of one image (srsem_torch/pseudo)."""
    from srsem_torch.device import resolve_device
    from srsem_torch.pseudo.captions import (
        default_folders,
        enumerate_pairs,
        merge_caption_dicts,
        parse_caption_file,
    )
    from srsem_torch.pseudo.scoring import score_caption_pairs

    device = resolve_device(args.device)
    folders = [f for f in default_folders(args.root) if os.path.isdir(f)]
    listings = {f: sorted(os.listdir(f)) for f in folders}
    captions = merge_caption_dicts(
        [parse_caption_file(os.path.join(f, args.captions_name))
         for f in folders], folders)
    pairs = enumerate_pairs(folders, listings)
    embedder = _make_embedder(args.embedder, device)
    cosines = score_caption_pairs(captions, pairs, embedder)
    out = args.out or os.path.join(args.root, "wholeim_pairs_cosines.csv")
    _write_csv(out, ["img_a_pth", "img_b_pth", "cosine"],
               [(a, b, repr(float(c))) for (a, b), c in zip(pairs, cosines)])
    print(json.dumps({"pairs": len(pairs), "out": out}))
    return 0


def cmd_pseudo_captions(args) -> int:
    """Whole-image captioning over the KonIQ folder layout
    (srsem_torch/pseudo/vlm.py; ``static`` or ``transformers:<model>``)."""
    from srsem_torch.pseudo.captions import default_folders
    from srsem_torch.pseudo.vlm import (
        StaticCaptioner,
        TransformersCaptioner,
        caption_folder_batch,
    )

    if args.backend == "static":
        captioner = StaticCaptioner()
    elif args.backend.startswith("transformers:"):
        captioner = TransformersCaptioner(args.backend.split(":", 1)[1])
    else:
        raise SystemExit(f"unknown captioner backend {args.backend!r}")
    counts = {folder: caption_folder_batch(captioner, folder,
                                           batch_size=args.batch_size)
              for folder in default_folders(args.root)
              if os.path.isdir(folder)}
    print(json.dumps(counts))
    return 0


def cmd_maps_build(args) -> int:
    """Per-pair cosine maps and ``filt_refs.csv`` from the panoptic
    pickles and per-region caption files (srsem_torch/maps/cosmap.py)."""
    import pickle

    from srsem_torch.device import resolve_device
    from srsem_torch.maps.cosmap import (
        read_region_captions,
        write_cosine_map_dataset,
    )
    from srsem_torch.maps.panoptic import panoptic_to_masks

    device = resolve_device(args.device)
    with open(args.pairs_csv, newline="") as f:
        pairs = list(csv.DictReader(f))
    records = []
    for row in pairs:
        a, b = row["img_a_pth"], row["img_b_pth"]
        stem_a = os.path.splitext(os.path.basename(a))[0]
        stem_b = os.path.splitext(os.path.basename(b))[0]
        pan_dir_a = os.path.join(os.path.dirname(a), "general_panoptic")
        pan_dir_b = os.path.join(os.path.dirname(b), "general_panoptic")
        with open(os.path.join(pan_dir_a, stem_a + ".pkl"), "rb") as f:
            panoptic = pickle.load(f)
        ids = list(panoptic_to_masks(panoptic))
        caps_a = read_region_captions(
            os.path.join(pan_dir_a, stem_a + ".txt"), ids)
        caps_b = read_region_captions(
            os.path.join(pan_dir_b, stem_b + ".txt"), ids)
        records.append((a, b, panoptic, caps_a, caps_b))
    embedder = _make_embedder(args.embedder, device)
    write_cosine_map_dataset(records, embedder, args.out_dir, args.out_csv)
    print(json.dumps({"pairs": len(records), "csv": args.out_csv}))
    return 0


def cmd_convert(args) -> int:
    """Convert torch pretrained or reference-trained checkpoints to the
    JAX package's param trees, with the bytes ``srsem convert`` writes: a
    flax-msgpack file for the towers (``--backbone-checkpoint``), a
    checkpoint directory for ``global_head`` and ``clu_decoder``
    (``--checkpoint``)."""
    from srsem_torch.train.checkpoint import msgpack_serialize, save_checkpoint
    from srsem_torch.train.partition import flatten_dict
    from srsem_torch.utils import convert as cv

    kind = args.kind
    if args.image_size is not None and args.image_size <= 0:
        raise SystemExit(f"--image-size must be positive, got {args.image_size}")
    sd = _torch_load(args.input)
    if kind in ("global_head", "clu_decoder"):
        if kind == "global_head":
            ckpt = {"trainable": cv.convert_global_head(
                sd, shared=args.shared_head)}
        else:
            dec = cv.convert_clu_decoder(sd)
            ckpt = {"trainable": dec["params"],
                    "batch_stats": dec["batch_stats"]}
        path = save_checkpoint(args.out, 0, cv.jax_key_order(ckpt))
        print(json.dumps({"kind": kind, "out": args.out, "ckpt": path,
                          "n_arrays": len(flatten_dict(ckpt))}))
        return 0
    if kind == "lpips":
        from srsem_torch.eval.lpips import convert_lpips

        if not args.tower:
            raise SystemExit("--tower (AlexNet/VGG16 feature sd) is "
                             "required for kind=lpips")
        tree = convert_lpips(sd, _torch_load(args.tower), net=args.lpips_net)
    elif kind == "minilm":
        from srsem_torch.pseudo.text_embed import convert_hf_minilm

        tree = convert_hf_minilm(sd)
    elif kind == "albef":
        tree = cv.convert_albef(sd, image_size=args.image_size or 384,
                                patch=args.patch)
    elif kind == "albef_fusion":
        # The full retrieval checkpoint: the itm_head from the same dict.
        from srsem_torch.explain.fusion import convert_albef_fusion

        itm = {k: v for k, v in sd.items() if k.startswith("itm_head.")}
        tree = convert_albef_fusion(sd, itm_sd=itm or None)
    else:
        tree = {"resnet50": cv.convert_torch_resnet50,
                "resnet50_clip": cv.convert_clip_resnet50,
                "clip_vit": cv.convert_clip_vit,
                "hf_clip_vit": cv.convert_hf_clip_vit,
                "hf_clip_text": cv.convert_hf_clip_text,
                "clip_text": cv.convert_clip_text,
                "slip": cv.convert_slip,
                "transalnet": cv.convert_transalnet}[kind](sd)
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(cv.jax_key_order(tree)))
    print(json.dumps({"kind": kind, "out": args.out,
                      "n_arrays": len(flatten_dict(tree))}))
    return 0


def cmd_info(args) -> int:
    """Deployment diagnostic: versions, host, nvcc, native decoder, env
    knobs.  Headless by default: without ``--devices`` nothing here
    initializes CUDA, so it is safe next to a live ``serve``.  ``--native``
    builds/loads the C++ decoder.  One JSON object on stdout."""
    import os
    import platform
    from importlib import metadata

    import torch

    from srsem_torch.ops import _build

    def _version(dist: str) -> str:
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            return "not-installed"

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    out: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "versions": {d: _version(d) for d in ("torch", "numpy", "Pillow")},
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "env": {k: os.environ[k] for k in ("CUDA_VISIBLE_DEVICES",
                                           "CUDA_HOME")
                if k in os.environ},
        # torchrun's world, read from its environment (no process group
        # starts here); the default mesh puts every rank on the data axis.
        "distributed": {
            "rank": int(os.environ.get("RANK", "0")),
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "world": int(os.environ.get("WORLD_SIZE", "1")),
            "mesh": {"data": int(os.environ.get("WORLD_SIZE", "1")),
                     "model": 1}},
    }
    if args.native:
        from srsem_torch import native

        out["native_decoder"] = {"available": native.available(),
                                 "build_error": native.build_error()}
    if args.devices:
        # THIS initializes CUDA.
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out["cuda"] = {"device_count": count,
                       "devices": [torch.cuda.get_device_name(i)
                                   for i in range(count)]}
    print(json.dumps(out))
    return 0


def cmd_saliency(args) -> int:
    """The ``SaliencyMaps/`` .npy tree of an image folder
    (srsem_torch/explain/saliency.py), which eval/approaches.py's overlap
    metrics read.  Weights from ``convert --kind transalnet`` (the msgpack,
    read by srsem_torch/train/checkpoint.py), or seeded random ones only
    behind ``--random-init`` (``torch.Generator().manual_seed(0)``: JAX's
    ``PRNGKey(0)`` draw cannot be rebuilt here)."""
    import torch

    from srsem_torch.device import resolve_device
    from srsem_torch.explain.saliency import (TranSalNetDense,
                                              generate_saliency_maps)
    from srsem_torch.train.checkpoint import msgpack_restore
    from srsem_torch.utils.convert import load_transalnet

    device = resolve_device(args.device)
    model = TranSalNetDense((args.height, args.width))
    if args.checkpoint:
        with open(args.checkpoint, "rb") as f:
            tree = msgpack_restore(f.read())
        load_transalnet(model, {"params": tree["params"],
                                "batch_stats": tree.get("batch_stats", {})})
    elif args.random_init:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        raise SystemExit(
            "saliency needs --checkpoint (convert --kind transalnet) or an "
            "explicit --random-init for smoke runs")
    n = generate_saliency_maps(model, args.images, args.out,
                               image_size=(args.height, args.width),
                               geometry=args.geometry,
                               channel_order=args.channel_order,
                               device=device)
    print(json.dumps({"images_dir": args.images, "out": args.out,
                      "written": n}))
    return 0


def cmd_visualize(args) -> int:
    """Render scoring artifacts to image files — the reference's notebook
    plotting surface (additional_approaches/src/visual_utils.py:9-219) as a
    CLI over srsem_torch/explain/visual.py (srsem/cli/main.py:839-903).  Kinds:

    * ``overlay`` — blend a fidelity/cosine map (.npy from ``serve``/
      ``score-maps-groups``, or a cosine-map .pkl) onto its image;
    * ``grid``    — tile images (e.g. GT + the K SR outputs) into one PNG;
    * ``heatmap`` — a similarity-matrix .npy/.pkl as an annotated heatmap;
    * ``splice``  — SpLiCE word-weight bars from a {word: weight} JSON
      (``srsem_torch.decompose.splice.weights2words`` output).

    Headless by construction (matplotlib Agg) and device-free: nothing on
    this path calls ``torch.cuda``, so the command never claims a card a
    running ``serve`` holds (the map resize is pure numpy,
    srsem_torch/explain/visual.py::_resize_bilinear_np)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from PIL import Image

    from srsem_torch.explain.visual import (overlay_cam, plot_image_grid,
                                            plot_similarity_heatmap,
                                            plot_splice_weights)

    def _need(name: str) -> None:
        if getattr(args, name.replace("-", "_"), None) in (None, []):
            raise SystemExit(
                f"visualize {args.kind}: --{name} is required")

    def _load01(path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("RGB"),
                          np.float32) / 255.0

    def _load_array(path: str) -> np.ndarray:
        """.npy or .pkl → float32 array (maps and similarity matrices are
        emitted in both formats by the pipelines)."""
        if path.endswith(".pkl"):
            import pickle

            with open(path, "rb") as f:
                return np.asarray(pickle.load(f), np.float32)
        if path.endswith(".npy"):
            return np.asarray(np.load(path), np.float32)
        raise SystemExit(f"{path}: unsupported extension (expected .npy "
                         f"or .pkl)")

    def _load_map(path: str) -> np.ndarray:
        m = np.squeeze(_load_array(path))
        if m.ndim != 2:
            raise SystemExit(f"map {path}: expected a 2-D map, got "
                             f"shape {m.shape}")
        lo, hi = float(m.min()), float(m.max())
        if args.normalize:
            return ((m - lo) / (hi - lo) if hi > lo else np.zeros_like(m))
        # Tiny float overshoots (e.g. a sigmoid map saved as 1.0000001)
        # are clipped, not rescaled — a silent min-max remap would change
        # the rendered contrast of an effectively-[0,1] map.
        if -1e-3 <= lo and hi <= 1.0 + 1e-3:
            return np.clip(m, 0.0, 1.0)
        print(f"visualize: map {path} has range [{lo:g}, {hi:g}] — "
              f"min-max rescaling to [0,1] (pass --normalize to silence)",
              file=sys.stderr)
        return ((m - lo) / (hi - lo) if hi > lo else np.zeros_like(m))

    if args.kind == "overlay":
        _need("image"), _need("map")
        arr = overlay_cam(_load01(args.image), _load_map(args.map),
                          alpha=args.alpha)
        Image.fromarray(arr).save(args.out)
    elif args.kind == "grid":
        _need("images")
        fig = plot_image_grid([_load01(p) for p in args.images],
                              titles=args.titles, cols=args.cols)
        fig.savefig(args.out, dpi=150)
        plt.close(fig)
    elif args.kind == "heatmap":
        _need("matrix")
        mat = np.atleast_2d(_load_array(args.matrix))
        ax = plot_similarity_heatmap(mat, labels=args.labels,
                                     title=args.title,
                                     annotate=mat.size <= 400)
        ax.figure.savefig(args.out, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    else:  # splice
        _need("json")
        with open(args.json) as f:
            weights = json.load(f)
        items = (list(weights.items()) if isinstance(weights, dict)
                 else [tuple(kv) for kv in weights])
        items.sort(key=lambda kv: -abs(float(kv[1])))
        items = items[: args.top]
        ax = plot_splice_weights([w for w, _ in items],
                                 [float(s) for _, s in items],
                                 title=args.title or "SpLiCE decomposition")
        ax.figure.savefig(args.out, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    print(json.dumps({"kind": args.kind, "out": args.out}))
    return 0


def _float32_without_tf32() -> None:
    """float32 means float32 on the command line: PyTorch runs cuDNN's
    float32 convolutions in TF32 by default, which moves a ``train-clu``
    step's loss past the port's rtol of 1e-5 (PERF.md, the precision
    finding).  Library callers keep PyTorch's default; the Hopper kernels'
    float32 is 3xTF32 either way."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srsem_torch")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace (CPU, and CUDA where a card "
             "is present) of the subcommand into DIR/trace.json (Chrome "
             "trace format) and its spans and counters into DIR/spans.json "
             "(goes BEFORE the subcommand)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_training_flags(p):
        p.add_argument("--fused-tower", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="the frozen base tower through the Hopper "
                            "bottleneck kernel (the default for a frozen "
                            "tower without LoRA; a trained or LoRA tower runs "
                            "as the module); --no-fused-tower runs the "
                            "module's F.conv2d chain")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (plain PyTorch path)")

    p = sub.add_parser("score", help="batch-score GT/SR pairs from a CSV")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack, srsem "
                        "convert) or torchvision resnet50 / OpenAI-CLIP "
                        "state dict (.pt) to load into the tower")
    p.add_argument("pairs_csv")
    p.add_argument("--col-a", default="img_a_pth")
    p.add_argument("--col-b", default="img_b_pth")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint",
                   help="checkpoint directory (latest.json + step_N.msgpack) "
                        "whose trained head is loaded over the model")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--fused-tower", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tower interiors through the Hopper bottleneck "
                        "kernel (default); --no-fused-tower runs the plain "
                        "F.conv2d chain")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode (PIL draft semantics): "
                        "~LSB-scale pixel differences vs the full decode")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.add_argument("--out", default="scores.csv")
    p.add_argument("--set", action="append", default=[])
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("score-groups", help="score each GT against K SR "
                       "folders with one shared GT tower pass per group")
    p.add_argument("gt_folder")
    p.add_argument("sr_folders", nargs="+")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--checkpoint",
                   help="checkpoint directory (latest.json + step_N.msgpack) "
                        "whose trained head is loaded over the model")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="tower compute dtype — bfloat16 serves fastest; "
                        "float32 for reproducibility (squared tap-diffs of "
                        "near-identical pairs amplify bf16 rounding)")
    p.add_argument("--fused-tower", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tower interiors through the Hopper bottleneck "
                        "kernel (default); --no-fused-tower runs the plain "
                        "F.conv2d chain")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack, srsem "
                        "convert) or torchvision resnet50 / OpenAI-CLIP "
                        "state dict (.pt) to load into the tower")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode (PIL draft semantics): "
                        "~LSB-scale pixel differences vs the full decode")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.add_argument("--out", default="group_scores.csv")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. head=wperlay_vit (a "
                        "grouped head: stages_cnn, wperlay_cnn or a ViT "
                        "head with --backbone vit_clip)")
    p.set_defaults(fn=cmd_score_groups)

    p = sub.add_parser("score-maps-groups", help="CLU fidelity maps for "
                       "each GT against K SR folders with one shared GT "
                       "tower pass per group")
    p.add_argument("gt_folder")
    p.add_argument("sr_folders", nargs="+")
    p.add_argument("--backbone", default="resnet50_clip",
                   choices=["resnet50_clip", "resnet50"])
    p.add_argument("--v2", action="store_true",
                   help="pixel-diff channel variant")
    p.add_argument("--checkpoint",
                   help="checkpoint directory (latest.json + step_N.msgpack) "
                        "whose trained decoder and batch_stats are loaded "
                        "over the model")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--maps-dir", default=None,
                   help="save full per-pair maps as .npy here")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="tower compute dtype")
    p.add_argument("--fused-tower", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tower interiors through the Hopper bottleneck "
                        "kernel (default, unless --set lora_rank=...: a "
                        "LoRA or fine-tuned tower runs as the module)")
    p.add_argument("--fused-decoder", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="every decoder level through the Hopper decoder "
                        "kernel, serving BN folded (default); "
                        "--no-fused-decoder runs the module's decoder")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack, srsem "
                        "convert) or OpenAI-CLIP / torchvision resnet50 "
                        "state dict (.pt) to load into the tower")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode (PIL draft semantics)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.add_argument("--out", default="group_map_scores.csv")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. decoder_dtype=bfloat16")
    p.set_defaults(fn=cmd_score_maps_groups)

    p = sub.add_parser(
        "serve", help="persistent scoring service: JSONL requests over "
        "stdio (or --http PORT) against a model built once — see "
        "srsem_torch/cli/serve.py for the protocol")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--head", default="stages_cnn",
                   choices=["stages_cnn", "wperlay_cnn", "single_lin_vit",
                            "stages_vit", "wperlay_vit"],
                   help="a grouped-scorable head (wperlay_cnn needs "
                        "--backbone resnet50_clip, the ViT heads "
                        "--backbone vit_clip)")
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--checkpoint",
                   help="checkpoint directory (latest.json + step_N.msgpack) "
                        "whose trained head is loaded over the model")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack, srsem "
                        "convert) or torchvision resnet50 / OpenAI-CLIP "
                        "state dict (.pt) to load into the tower")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--group-batch", type=int, default=8,
                   help="largest device group batch G: requests are padded "
                        "to (G, K) with G from a power-of-two bucket ladder "
                        "up to this")
    p.add_argument("--num-workers", type=int, default=16,
                   help="host decode thread pool size")
    p.add_argument("--decode-cache", type=int, default=256,
                   help="decoded-image LRU entries (repeat GTs skip host "
                        "decode; keyed on path+mtime; 0 disables)")
    p.add_argument("--linger-ms", type=float, default=None,
                   help="micro-batch collection window: wait up to this "
                        "long for more same-K requests before the device "
                        "call (0 = score whatever is already queued; "
                        "default 0 for stdio, 2 ms for the HTTP batcher)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve an embedded HTTP endpoint (POST /, same "
                        "JSON schema) instead of stdio; 0 binds a free port")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode for large SR outputs")
    p.add_argument("--with-maps", action="store_true",
                   help="also serve CLU fidelity-map requests "
                        '({"maps": true[, "maps_dir": DIR]} in the '
                        "request: map mean/min summaries, full maps as "
                        ".npy under maps_dir)")
    p.add_argument("--clu-backbone", default="resnet50_clip",
                   choices=["resnet50_clip", "resnet50"],
                   help="CLU backbone for --with-maps")
    p.add_argument("--clu-checkpoint", default=None,
                   help="trained CLU decoder checkpoint for --with-maps")
    p.add_argument("--warmup-k", type=int, nargs="*", default=[1],
                   help="build the kernels and run every (G, K) bucket for "
                        "these K values before accepting requests (prints "
                        "a ready line on stderr)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("sweep-dataset", help="global scores + CLU maps "
                       "over GT/SR folders with one shared tower pass")
    p.add_argument("gt_folder")
    p.add_argument("sr_folders", nargs="+")
    p.add_argument("--backbone", default="resnet50_clip")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--fused-tower", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tower interiors through the Hopper bottleneck "
                        "kernel (default)")
    p.add_argument("--fused-decoder", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="every decoder level through the Hopper decoder "
                        "kernel, serving BN folded (default)")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode (PIL draft semantics)")
    p.add_argument("--out-template", default="scores_{folder}.csv")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_sweep_dataset)

    p = sub.add_parser("train-global", help="train a global regressor's "
                       "head on the frozen tower")
    p.add_argument("csv")
    p.add_argument("root")
    p.add_argument("--backbone", default="resnet50_clip")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack) or "
                        "torchvision resnet50 / OpenAI-CLIP state dict "
                        "(.pt) to train the heads on")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--train-set", action="append", default=[])
    add_training_flags(p)
    p.set_defaults(fn=cmd_train_global)

    p = sub.add_parser("eval-global",
                       help="SRCC/MSE vs the user-study labels")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack) or "
                        "torchvision resnet50 / OpenAI-CLIP state dict "
                        "(.pt) to load into the tower")
    p.add_argument("csv")
    p.add_argument("root")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint")
    p.add_argument("--val-only", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--set", action="append", default=[])
    add_training_flags(p)
    p.set_defaults(fn=cmd_eval_global)

    p = sub.add_parser("train-clu", help="train a CLU map model's decoder "
                       "on the frozen tower")
    p.add_argument("csv")
    p.add_argument("--backbone", default="resnet50_clip")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="converted tower param tree (.msgpack) or "
                        "OpenAI-CLIP / torchvision resnet50 state dict "
                        "(.pt) to train the decoder on")
    p.add_argument("--only-hq", action="store_true")
    p.add_argument("--min-caps", type=int, default=2)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--train-set", action="append", default=[])
    p.add_argument("--cached-diffs", action="store_true",
                   help="decoder-only fast path: the frozen tower runs once "
                        "over the dataset, epochs train the decoder on the "
                        "diff cache on the device")
    p.add_argument("--thresholds", nargs="+", metavar="T",
                   help="train one decoder per map threshold (e.g. none 0.4 "
                        "0.9) over ONE tower stream; checkpoints go to "
                        "CHECKPOINT_DIR/threshold-T")
    add_training_flags(p)
    p.set_defaults(fn=cmd_train_clu)

    p = sub.add_parser("sweep-global", help="the reference's global depth "
                       "grid")
    p.add_argument("csv")
    p.add_argument("root")
    p.add_argument("--backbone", default="resnet50_clip")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="tower (.msgpack or .pt) shared by every grid point")
    p.add_argument("--summary", default="sweep_global.jsonl")
    p.add_argument("--shared-tower", action="store_true",
                   help="train all depth points on one frozen-tower stream")
    p.add_argument("--cached-diffs", action="store_true",
                   help="run the tower once; train every epoch on the "
                        "diff cache on the device")
    p.add_argument("--cached-stats", action="store_true",
                   help="run the tower once; train on per-layer "
                        "spatial-mean diffs (~15 KB a pair, exact for "
                        "conv heads)")
    p.add_argument("--closed-form", action="store_true",
                   help="solve each point's conv head exactly (ridge "
                        "least squares) from the stat cache: no epochs")
    p.add_argument("--l2", type=float, default=1e-6,
                   help="ridge penalty for --closed-form")
    add_training_flags(p)
    p.set_defaults(fn=cmd_sweep_global)

    p = sub.add_parser("sweep-clu", help="the reference's CLU grid")
    p.add_argument("csv")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="tower (.msgpack or .pt) shared by every grid cell")
    p.add_argument("--summary", default="sweep_clu.jsonl")
    p.add_argument("--limit-axis", action="append", default=[])
    p.add_argument("--shared-thresholds", action="store_true",
                   help="train each frozen-tower cell's whole threshold "
                        "axis in one run (one tower stream, one decoder a "
                        "threshold)")
    add_training_flags(p)
    p.set_defaults(fn=cmd_sweep_clu)

    p = sub.add_parser("folder-metrics", help="SSIM/PSNR/LPIPS (and the "
                       "NR-IQA head's KonIQ++ columns) of SR folders "
                       "against a GT folder: metrics.csv a folder")
    p.add_argument("gt_folder")
    p.add_argument("eval_folders", nargs="+")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lpips-net", default="alex", choices=["alex", "vgg"])
    p.add_argument("--lpips-checkpoint", default=None,
                   help="official lpips lin-weights .pth, loaded straight "
                        "into the port's LPIPS")
    p.add_argument("--lpips-tower", default=None,
                   help="torchvision alexnet/vgg16 state dict for the tower")
    p.add_argument("--koniqpp-checkpoint", default=None,
                   help="NR-IQA head checkpoint dir (the port's "
                        "train-nr-iqa; a JAX-written one raises)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_folder_metrics)

    p = sub.add_parser("train-nr-iqa", help="train the KonIQ++-equivalent "
                       "NR-IQA head on synthetic degradations of a folder")
    p.add_argument("image_folder")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--limit", type=int, default=0,
                   help="cap the number of images (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_train_nr_iqa)

    p = sub.add_parser("pseudo-c2c", help="caption-to-caption cosines over "
                       "the KonIQ SR folder layout")
    p.add_argument("root")
    p.add_argument("--captions-name", default="wholeim_captions_batch.txt")
    p.add_argument("--embedder", default="hashing",
                   help="hashing, or minilm:<torch_ckpt>:<tokenizer_dir> "
                        "(tokenizer_dir holds vocab.txt)")
    p.add_argument("--out")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_pseudo_c2c)

    p = sub.add_parser("pseudo-captions", help="whole-image captions over "
                       "the KonIQ SR folder layout")
    p.add_argument("root")
    p.add_argument("--backend", default="static",
                   help='"static" or "transformers:<model-name>"')
    p.add_argument("--batch-size", type=int, default=10)
    p.set_defaults(fn=cmd_pseudo_captions)

    p = sub.add_parser("maps-build", help="per-pair cosine maps and "
                       "filt_refs.csv from panoptic pickles and region "
                       "captions")
    p.add_argument("pairs_csv")
    p.add_argument("--out-dir", default="cosine_maps")
    p.add_argument("--out-csv", default="filt_refs.csv")
    p.add_argument("--embedder", default="hashing")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_maps_build)

    p = sub.add_parser("convert", help="convert torch pretrained or "
                       "reference-trained checkpoints to srsem param trees "
                       "(flax msgpack)")
    p.add_argument("input", help="torch .pt/.pth state dict")
    p.add_argument("--kind", required=True,
                   choices=["resnet50", "resnet50_clip", "clip_vit",
                            "hf_clip_text", "hf_clip_vit", "clip_text",
                            "slip", "minilm", "lpips", "transalnet",
                            "albef", "albef_fusion",
                            "global_head", "clu_decoder"])
    p.add_argument("--shared-head", action="store_true",
                   help="for global_head: the checkpoint is the singleLin "
                        "shared ViT head (w_layer Sequential) rather than "
                        "a per-layer w_layers ModuleList")
    p.add_argument("--image-size", type=int, default=None,
                   help="for albef: the pos-embed target resolution "
                        "(default 384); checked positive, as the JAX CLI "
                        "does (its resnet50_clip tree does not depend on "
                        "it)")
    p.add_argument("--patch", type=int, default=16,
                   help="for albef: the ViT patch size the checkpoint was "
                        "trained with (pos-embed grid = image-size/patch; "
                        "default 16, the reference's deit-base/16)")
    p.add_argument("--tower", default=None,
                   help="for lpips: the torchvision AlexNet/VGG16 state "
                        "dict of the tower")
    p.add_argument("--lpips-net", default="alex", choices=["alex", "vgg"])
    p.add_argument("--out", default="converted.msgpack")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("saliency", help="write the SaliencyMaps .npy tree "
                       "for an image folder (TranSalNet-Dense; reference "
                       "compute_metrics.py:130-134)")
    p.add_argument("--images", required=True, help="input image folder")
    p.add_argument("--out", required=True, help="output SaliencyMaps dir")
    p.add_argument("--checkpoint", default=None,
                   help="converted TranSalNet msgpack (convert --kind "
                        "transalnet)")
    p.add_argument("--random-init", action="store_true",
                   help="allow random-init weights (smoke/shape runs only)")
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--geometry", choices=("pad", "resize"), default="pad",
                   help="'pad' (default) = reference data_process.py "
                        "aspect-preserving pad + crop-back to source "
                        "resolution; 'resize' = distorting bicubic, maps "
                        "saved at height×width")
    p.add_argument("--channel-order", choices=("bgr", "rgb"), default="bgr",
                   help="'bgr' matches the reference's cv2.imread input "
                        "(upstream TranSalNet checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.set_defaults(fn=cmd_saliency)

    p = sub.add_parser(
        "info", help="environment diagnostic: versions, host, nvcc, native "
                     "decoder, env knobs (headless unless --devices)")
    p.add_argument("--devices", action="store_true",
                   help="probe torch.cuda (initializes CUDA)")
    p.add_argument("--native", action="store_true",
                   help="build/load the C++ decoder and report its status")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "visualize",
        help="render artifacts: map overlays, image grids, similarity "
             "heatmaps, SpLiCE weight bars (reference: visual_utils.py)")
    p.add_argument("kind", choices=["overlay", "grid", "heatmap", "splice"])
    p.add_argument("--out", required=True, help="output image path")
    p.add_argument("--image", help="overlay: the image under the map")
    p.add_argument("--map", help="overlay: .npy fidelity map or .pkl "
                                 "cosine map")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="overlay: heatmap blend weight")
    p.add_argument("--normalize", action="store_true",
                   help="overlay: min-max rescale the map to [0,1] "
                        "(automatic when values fall outside [0,1])")
    p.add_argument("--images", nargs="+", help="grid: image paths")
    p.add_argument("--titles", nargs="+", help="grid: per-cell titles")
    p.add_argument("--cols", type=int, default=4)
    p.add_argument("--matrix", help="heatmap: .npy similarity matrix")
    p.add_argument("--labels", nargs="+", help="heatmap: axis labels")
    p.add_argument("--title", default="")
    p.add_argument("--json", help="splice: {word: weight} JSON")
    p.add_argument("--top", type=int, default=20,
                   help="splice: keep the top-N |weight| words")
    p.set_defaults(fn=cmd_visualize)

    args = parser.parse_args(argv)
    if args.cmd != "visualize":  # the one subcommand without torch
        _float32_without_tf32()
    if args.profile:
        from srsem_torch.utils.profiling import capture_trace

        with capture_trace(args.profile):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
