"""``python -m srsem_torch`` — the port's command line (the ``score``,
``score-groups``, ``score-maps-groups``, ``serve``, ``sweep-dataset``,
``train-global``, ``eval-global``, ``train-clu``, ``sweep-global``,
``sweep-clu`` and ``info`` subcommands of srsem/cli/main.py so far, and
the global ``--profile DIR``).

    python -m srsem_torch score pairs.csv --backbone resnet50 [--device cpu]
    python -m srsem_torch score pairs.csv --backbone resnet50_clip \
        --set head=wperlay_cnn --set depth=11 --checkpoint CKPT_DIR
    python -m srsem_torch score-groups GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch score-maps-groups GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch serve --warmup-k 1 4 --with-maps < requests.jsonl
    python -m srsem_torch sweep-dataset GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch train-global study.csv ROOT [--device cpu] \
        [--checkpoint-dir DIR] [--train-set epochs=1]
    python -m srsem_torch eval-global study.csv ROOT --checkpoint DIR
    python -m srsem_torch train-clu pairs.csv [--checkpoint-dir DIR]
    python -m srsem_torch sweep-clu pairs.csv --limit-axis lora_rank=None
    python -m srsem_torch info [--native] [--devices]
    python -m srsem_torch --profile DIR score-groups GT_DIR SR_DIR...

Flags follow srsem/cli/main.py (:957-1072, :1119-1205, :1206-1246 and
:1297-1328), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path) and
``--no-fused-tower`` / ``--no-fused-decoder`` (the port runs its Hopper
kernels by default).  ``--checkpoint DIR`` reads the JAX package's
checkpoint directories (``latest.json`` + ``step_N.msgpack``, through
srsem_torch/train/checkpoint.py) and loads their ``trainable`` subset, and
for CLU maps their ``batch_stats``, over the model, as the JAX CLI's
``merge_params`` does.  ``--backbone-checkpoint`` takes a converted tower
param tree (``.msgpack``, the JAX CLI's ``srsem convert`` output) or a
torchvision ``resnet50`` / OpenAI-CLIP state dict (``.pt``).  Without
either, the weights are seeded random ones.  The training commands train
the head or decoder on the frozen tower (srsem_torch/train/loop.py) and
write the JAX package's checkpoint layout; their fast paths
(``--cached-diffs``, ``--thresholds``, ``--shared-tower``,
``--cached-stats``, ``--closed-form``, ``--shared-thresholds``) raise
until ROADMAP A8, and tower training (``enc_ft``, LoRA) until A7.
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
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
    one head launch a batch (srsem_torch/eval/grouped.py::GroupedPairScorer)."""
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.eval.grouped import GroupedPairScorer
    from srsem_torch.models.global_models import make_global_model

    cfg = GlobalModelConfig(
        backbone=BackboneConfig(kind=args.backbone, image_size=args.image_size,
                                compute_dtype=args.dtype),
        head="stages_cnn", depth=args.depth)
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


def _a8(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs the sweep amortizations (diffcache, statcache, "
        "multisweep), which are not ported yet (ROADMAP A8)")


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
    from srsem_torch.data.datasets import Subset, UserStudyScores, seeded_split
    from srsem_torch.data.loader import Loader
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.train.loop import train_global

    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    tcfg = override(TrainConfig(checkpoint_dir=args.checkpoint_dir),
                    _parse_sets(args.train_set))
    pre = Preprocess.for_backbone(cfg.backbone.kind, cfg.backbone.image_size)
    ds = UserStudyScores(args.csv, args.root, pre)
    train_idx, val_idx = seeded_split(len(ds), tcfg.val_fraction, tcfg.seed)
    train_loader = Loader(Subset(ds, train_idx), tcfg.batch_size, shuffle=True,
                          seed=tcfg.seed)
    val_loader = Loader(Subset(ds, val_idx), tcfg.batch_size)
    result = train_global(cfg, tcfg, train_loader, val_loader,
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
    """Train a CLU map model's decoder on the frozen tower
    (srsem_torch/train/loop.py::train_local)."""
    if args.cached_diffs:
        raise _a8("train-clu --cached-diffs")
    if args.thresholds:
        raise _a8("train-clu --thresholds")
    from srsem_torch.config import (
        BackboneConfig,
        LocalModelConfig,
        TrainConfig,
        override,
    )
    from srsem_torch.data.datasets import (
        KoniqPairsMapsDataset,
        Subset,
        seeded_split,
    )
    from srsem_torch.data.loader import Loader
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.train.loop import train_local

    cfg = override(
        LocalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    tcfg = override(
        TrainConfig(batch_size=80, epochs=60, checkpoint_dir=args.checkpoint_dir),
        _parse_sets(args.train_set))
    pre = Preprocess.for_backbone(cfg.backbone.kind, cfg.backbone.image_size)
    ds = KoniqPairsMapsDataset(args.csv, pre, only_hq=args.only_hq,
                               imgamincaps=args.min_caps,
                               threshold=tcfg.map_threshold)
    train_idx, val_idx = seeded_split(len(ds), tcfg.val_fraction, tcfg.seed)
    train_loader = Loader(Subset(ds, train_idx), tcfg.batch_size, shuffle=True,
                          seed=tcfg.seed)
    val_loader = Loader(Subset(ds, val_idx), tcfg.batch_size)
    result = train_local(cfg, tcfg, train_loader, val_loader,
                         **_train_kw(args))
    print(json.dumps({"val_metrics": result.val_metrics, "steps": result.step}))
    return 0


def cmd_sweep_global(args) -> int:
    """The reference's global depth grid, one training run a point."""
    for flag in ("shared_tower", "cached_diffs", "cached_stats",
                 "closed_form"):
        if getattr(args, flag):
            raise _a8("sweep-global --" + flag.replace("_", "-"))
    from srsem_torch.train.sweep import (
        GLOBAL_SWEEP,
        make_global_train_fn,
        run_sweep,
    )

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
                       default=True,
                       help="the frozen tower through the Hopper bottleneck "
                            "kernel (default); --no-fused-tower runs the "
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
                   default=True,
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
                   default=True,
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
                   default=True,
                   help="tower interiors through the Hopper bottleneck "
                        "kernel (default)")
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
                        "--backbone resnet50_clip; the ViT heads wait for "
                        "the ViT tower, ROADMAP A10)")
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
                   default=True,
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
                   help="decoder-only fast path (not ported yet: ROADMAP A8)")
    p.add_argument("--thresholds", nargs="+", metavar="T",
                   help="the threshold axis in one run (not ported yet: "
                        "ROADMAP A8)")
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
    for flag in ("--shared-tower", "--cached-diffs", "--cached-stats",
                 "--closed-form"):
        p.add_argument(flag, action="store_true",
                       help="not ported yet (ROADMAP A8)")
    p.add_argument("--l2", type=float, default=1e-6,
                   help="ridge penalty for --closed-form (ROADMAP A8)")
    add_training_flags(p)
    p.set_defaults(fn=cmd_sweep_global)

    p = sub.add_parser("sweep-clu", help="the reference's CLU grid")
    p.add_argument("csv")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="tower (.msgpack or .pt) shared by every grid cell")
    p.add_argument("--summary", default="sweep_clu.jsonl")
    p.add_argument("--limit-axis", action="append", default=[])
    p.add_argument("--shared-thresholds", action="store_true",
                   help="one run a cell's threshold axis (not ported yet: "
                        "ROADMAP A8)")
    add_training_flags(p)
    p.set_defaults(fn=cmd_sweep_clu)

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
