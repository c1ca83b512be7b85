#!/usr/bin/env python3
"""Time the head kernel (srsem_torch/csrc/fused_head.cu) at the global
path's four taps (224 px, bf16) under other launch plans.

    python3 sweep_head_plan.py       # from the root of a checkout, one card

The plan is made by srsem_torch/ops/fused_head.py::kernel_plan from three
constants, which this script sets for each line and then restores: the
chunk granularity (``_UNROLL``: 2048-element steps, or the kernel's
unrolled group of four), the work items a block the chunk size aims at
(``_ITEMS_PER_BLOCK``) and the grid's blocks an SM (``_BLOCKS_PER_SM``;
four are resident, more run as a second wave).  Each line: the form
(pairwise batch 64, or grouped G = 16, K = 4), the plan's chunk, items and
grid, and the ms a launch (CUDA events over 50 back-to-back launches,
device-bound: the host needs far less a call) against the bound.  The
card's name and power limit come first.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
TAPS = [(56, 56, 256), (28, 28, 512), (14, 14, 1024), (7, 7, 2048)]
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_head_plan: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from srsem_torch.models.global_models import ConvHeadAggregator
    from srsem_torch.ops import fused_head as fh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = [f"tap{j}" for j in range(len(TAPS))]
    head = ConvHeadAggregator([c for _, _, c in TAPS]).to(dev)
    packed = fh.pack_head(head)

    def taps(n):
        return {nm: torch.randn((n, *s), device=dev, generator=gen)
                .abs().bfloat16() for nm, s in zip(names, TAPS)}

    elems = sum(h * w * c for h, w, c in TAPS)
    forms = {"pairwise": (taps(64), taps(64), fh.fused_global_score, 128),
             "grouped": (taps(16), taps(64), fh.fused_grouped_score, 80)}
    saved = (fh._UNROLL, fh._ITEMS_PER_BLOCK, fh._BLOCKS_PER_SM)
    try:
        for form, (tg, ts, fn, images) in forms.items():
            for unroll, per_block, per_sm in itertools.product(
                    (fh._STEP, 4 * fh._STEP), (4, 8, 16), (4, 8)):
                fh._UNROLL, fh._ITEMS_PER_BLOCK, fh._BLOCKS_PER_SM = (
                    unroll, per_block, per_sm)
                fh._plan.cache_clear()
                fh._descriptor.cache_clear()
                plan = fh.kernel_plan([(tg[n], ts[n]) for n in names], 132)
                for _ in range(3):
                    fn(tg, ts, packed, names)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    fn(tg, ts, packed, names)
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({
                    "form": form, "unroll": unroll, "items_per_block": per_block,
                    "blocks_per_sm": per_sm, "chunk": plan.chunk,
                    "items": plan.items, "grid": plan.grid,
                    "ms": start.elapsed_time(end) / 50,
                    "bound_ms": images * elems * 2 / HBM_BYTES_PER_S * 1e3}),
                    flush=True)
    finally:
        fh._UNROLL, fh._ITEMS_PER_BLOCK, fh._BLOCKS_PER_SM = saved
        fh._plan.cache_clear()
        fh._descriptor.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
