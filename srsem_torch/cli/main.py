"""``python -m srsem_torch`` — the port's command line (the ``score``,
``score-groups``, ``score-maps-groups``, ``serve``, ``sweep-dataset``,
``train-global``, ``eval-global``, ``train-clu``, ``sweep-global``,
``sweep-clu``, ``convert`` and ``info`` subcommands of srsem/cli/main.py
so far, and the global ``--profile DIR``).

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
    python -m srsem_torch convert vit.pt --kind clip_vit --out vit.msgpack
    python -m srsem_torch info [--native] [--devices]
    python -m srsem_torch --profile DIR score-groups GT_DIR SR_DIR...

Flags follow srsem/cli/main.py (:957-1072, :1119-1205, :1206-1246 and
:1297-1328), plus
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
writes for the tower and head kinds (``resnet50``, ``resnet50_clip``,
``clip_vit``, ``hf_clip_vit``, ``global_head``, ``clu_decoder``).  Without
either, the weights are seeded random ones.  The training commands train
the head or decoder, and with ``--set enc_ft=True`` (global) or ``--set
lora_rank=R`` / ``lora_rank='full'`` (CLU) the tower
(srsem_torch/train/loop.py), and write the JAX package's checkpoint
layout.  Their fast paths amortize the frozen tower: ``train-clu
--cached-diffs`` (srsem_torch/train/diffcache.py) and ``--thresholds``
(srsem_torch/train/multisweep.py, one checkpoint directory a threshold),
``sweep-global --shared-tower`` / ``--cached-diffs`` / ``--cached-stats``
/ ``--closed-form`` (srsem_torch/train/statcache.py) and ``sweep-clu
--shared-thresholds``.
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import os
import sys
from typing import Any, Dict, List


def _parse_sets(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


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
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


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
                                   maps_dir=args.maps_dir)
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
        nan = _write_rows(out, rows, key="image")
        summary[sr_folder] = {"pairs": len(rows), "nan": nan, "out": out}
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
    print(json.dumps({"val_metrics": result.val_metrics, "steps": result.step}))
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
        if tcfg.checkpoint_dir:
            save_checkpoint(tcfg.checkpoint_dir, tcfg.epochs, {
                "trainable": result["trainable"],
                "batch_stats": result["batch_stats"]})
        print(json.dumps({"val_metrics": {"mse": result["val_mse"]},
                          "train_loss": result["train_loss"]}))
        return 0
    result = train_local(cfg, tcfg, train_loader, val_loader, **kw)
    print(json.dumps({"val_metrics": result.val_metrics, "steps": result.step}))
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
        print(json.dumps([{"name": r["name"], "val_srcc": r["val_srcc"],
                           "val_mse": r["val_mse"]} for r in results]))
        return 0
    results = run_sweep(
        make_global_train_fn(args.csv, args.root, backbone=args.backbone,
                             **_train_kw(args)),
        GLOBAL_SWEEP, summary_path=args.summary)
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
    results = run_clu_sweep(args.csv, axes, summary_path=args.summary,
                            shared_thresholds=args.shared_thresholds,
                            **_train_kw(args))
    print(json.dumps({"points": len(results)}))
    return 0


#: ``srsem convert``'s kinds not ported yet, with their ROADMAP items.
UNPORTED_CONVERT_KINDS = {
    "lpips": "A10b", "hf_clip_text": "A11", "clip_text": "A11",
    "minilm": "A11", "slip": "A12", "albef": "A12", "albef_fusion": "A12",
    "transalnet": "A12"}


def cmd_convert(args) -> int:
    """Convert torch pretrained or reference-trained checkpoints to the
    JAX package's param trees, with the bytes ``srsem convert`` writes: a
    flax-msgpack file for the towers (``--backbone-checkpoint``), a
    checkpoint directory for ``global_head`` and ``clu_decoder``
    (``--checkpoint``)."""
    import torch

    from srsem_torch.train.checkpoint import msgpack_serialize, save_checkpoint
    from srsem_torch.train.partition import flatten_dict
    from srsem_torch.utils import convert as cv

    kind = args.kind
    if kind in UNPORTED_CONVERT_KINDS:
        raise NotImplementedError(
            f"convert --kind {kind} needs a module that is not ported yet "
            f"(ROADMAP {UNPORTED_CONVERT_KINDS[kind]})")
    if args.image_size is not None and args.image_size <= 0:
        raise SystemExit(f"--image-size must be positive, got {args.image_size}")
    # As the JAX CLI: a reference checkpoint may be a pickled module or
    # wrap its state dict.
    sd = torch.load(args.input, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
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
    tree = {"resnet50": cv.convert_torch_resnet50,
            "resnet50_clip": cv.convert_clip_resnet50,
            "clip_vit": cv.convert_clip_vit,
            "hf_clip_vit": cv.convert_hf_clip_vit}[kind](sd)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srsem_torch")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace (CPU, and CUDA where a card "
             "is present) of the subcommand into DIR/trace.json (Chrome "
             "trace format; goes BEFORE the subcommand)")
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
                   help="decoder levels 0-2 through the Hopper decoder "
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
                   help="decoder levels 0-2 through the Hopper decoder "
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

    p = sub.add_parser("convert", help="convert torch pretrained or "
                       "reference-trained checkpoints to srsem param trees "
                       "(flax msgpack)")
    p.add_argument("input", help="torch .pt/.pth state dict")
    p.add_argument("--kind", required=True,
                   choices=["resnet50", "resnet50_clip", "clip_vit",
                            "hf_clip_text", "hf_clip_vit", "clip_text",
                            "slip", "minilm", "lpips", "transalnet",
                            "albef", "albef_fusion",
                            "global_head", "clu_decoder"],
                   help="resnet50, resnet50_clip, clip_vit, hf_clip_vit, "
                        "global_head and clu_decoder are ported; the others "
                        "raise, naming their ROADMAP item")
    p.add_argument("--shared-head", action="store_true",
                   help="for global_head: the checkpoint is the singleLin "
                        "shared ViT head (w_layer Sequential) rather than "
                        "a per-layer w_layers ModuleList")
    p.add_argument("--image-size", type=int, default=None,
                   help="checked positive, as the JAX CLI does (its "
                        "resnet50_clip tree does not depend on it)")
    p.add_argument("--patch", type=int, default=16,
                   help="for albef (not ported)")
    p.add_argument("--tower", default=None,
                   help="for lpips (not ported)")
    p.add_argument("--lpips-net", default="alex", choices=["alex", "vgg"])
    p.add_argument("--out", default="converted.msgpack")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "info", help="environment diagnostic: versions, host, nvcc, native "
                     "decoder, env knobs (headless unless --devices)")
    p.add_argument("--devices", action="store_true",
                   help="probe torch.cuda (initializes CUDA)")
    p.add_argument("--native", action="store_true",
                   help="build/load the C++ decoder and report its status")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if args.profile:
        from srsem_torch.utils.profiling import capture_trace

        with capture_trace(args.profile):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
