"""``python -m srsem_torch`` — the port's command line (the ``score``,
``score-groups`` and ``score-maps-groups`` subcommands of srsem/cli/main.py
so far).

    python -m srsem_torch score pairs.csv --backbone resnet50 [--device cpu]
    python -m srsem_torch score-groups GT_DIR SR_DIR... [--device cpu]
    python -m srsem_torch score-maps-groups GT_DIR SR_DIR... [--device cpu]

Flags follow srsem/cli/main.py (:957-979, :1119-1150 and :1206-1246), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path) and
``--no-fused-tower`` / ``--no-fused-decoder`` (the port runs its Hopper
kernels by default).  ``--backbone-checkpoint`` takes a torchvision
``resnet50`` or an OpenAI-CLIP state dict (``.pt``): the JAX package's
msgpack trees need flax.  ``--checkpoint`` (trained heads or decoders)
waits for the checkpoint port (ROADMAP A6).
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


def _no_checkpoint(args) -> None:
    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint (trained heads and decoders) is not ported yet: it "
            "needs srsem/train/checkpoint.py (ROADMAP A6)")


def _load_backbone(backbone, kind: str, path) -> None:
    """A torchvision ``resnet50`` or OpenAI-CLIP state dict into the tower."""
    if not path:
        return
    import torch

    from srsem_torch.utils.convert import load_clip_resnet50, load_torch_resnet50

    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    if kind == "resnet50_clip":
        load_clip_resnet50(backbone, sd)
    else:
        load_torch_resnet50(backbone, sd)


def cmd_score(args) -> int:
    import numpy as np
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig, override
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model

    _no_checkpoint(args)
    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)

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


def _write_rows(path: str, rows: List[dict]) -> int:
    """Write row dicts (``image_name`` + float columns) with ``csv``;
    returns the number of rows holding a NaN."""
    import math

    fields = list(rows[0]) if rows else ["image_name"]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        for row in rows:
            writer.writerow({k: v if k == "image_name" else repr(float(v))
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

    _no_checkpoint(args)
    cfg = GlobalModelConfig(
        backbone=BackboneConfig(kind=args.backbone, image_size=args.image_size,
                                compute_dtype=args.dtype),
        head="stages_cnn", depth=args.depth)
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
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

    _no_checkpoint(args)
    cfg = override(LocalModelConfig(
        backbone=BackboneConfig(kind=args.backbone, image_size=args.image_size,
                                compute_dtype=args.dtype),
        v2=args.v2), _parse_sets(args.set))
    model = make_local_model(cfg, generator=torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srsem_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("score", help="batch-score GT/SR pairs from a CSV")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="torchvision resnet50 (or OpenAI-CLIP) state dict "
                        "(.pt) to load into the tower")
    p.add_argument("pairs_csv")
    p.add_argument("--col-a", default="img_a_pth")
    p.add_argument("--col-b", default="img_b_pth")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint",
                   help="trained-head checkpoint (not ported yet: ROADMAP A6)")
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
                   help="trained-head checkpoint (not ported yet: ROADMAP A6)")
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
                   help="torchvision resnet50 (or OpenAI-CLIP) state dict "
                        "(.pt) to load into the tower")
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
                   help="trained CLU decoder (not ported yet: ROADMAP A6)")
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
                   help="OpenAI-CLIP (or torchvision resnet50) state dict "
                        "(.pt) to load into the tower")
    p.add_argument("--fast-jpeg", action="store_true",
                   help="DCT-scaled JPEG decode (PIL draft semantics)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")
    p.add_argument("--out", default="group_map_scores.csv")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. decoder_dtype=bfloat16")
    p.set_defaults(fn=cmd_score_maps_groups)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
