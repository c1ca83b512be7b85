"""``python -m srsem_torch`` — the port's command line (the ``score``
subcommand of srsem/cli/main.py so far).

    python -m srsem_torch score pairs.csv --backbone resnet50 [--device cpu]

Flags follow srsem/cli/main.py:957-979, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and ``--no-fused-tower``
(the port's tower runs its Hopper kernels by default).
``--backbone-checkpoint`` takes a torchvision ``resnet50`` state dict
(``.pt``): the JAX package's msgpack trees need flax.  ``--checkpoint``
(trained heads) waits for the checkpoint port (ROADMAP A6).
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


def cmd_score(args) -> int:
    import numpy as np
    import torch

    from srsem_torch.config import BackboneConfig, GlobalModelConfig, override
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.utils.convert import load_torch_resnet50

    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint (trained heads) is not ported yet: it needs "
            "srsem/train/checkpoint.py (ROADMAP A6)")
    cfg = override(
        GlobalModelConfig(backbone=BackboneConfig(kind=args.backbone)),
        _parse_sets(args.set))
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    if args.backbone_checkpoint:
        sd = torch.load(args.backbone_checkpoint, map_location="cpu",
                        weights_only=True)
        load_torch_resnet50(model.backbone, sd.get("state_dict", sd))

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srsem_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("score", help="batch-score GT/SR pairs from a CSV")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="torchvision resnet50 state dict (.pt) to load into "
                        "the tower")
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
