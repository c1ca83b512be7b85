#!/usr/bin/env python3
"""Time the port's float32 conv paths in two or more checkouts, in turns,
on one CUDA card.

    python3 compare_f32_conv.py --tree before=OLD_CHECKOUT --tree after=. \
        --order before,after,after,before --out f32.jsonl

Each turn runs this script again in a process of its own, with ``--measure``
and the checkout's ``srsem_torch`` first on ``sys.path`` (it builds that
checkout's kernels into its own ``build/``), and prints one JSON line:

* ``bottleneck``: ms a call of the float32 bottleneck at train-nr-iqa's
  shapes (batch 8, 224 px; the 56x56 stage through the tiled wrapper),
  weights packed once, CUDA events over 20 calls;
* ``decoder``: ms a call of the float32 decoder levels 0-4 at the CLU
  model's shapes (batch 32, 224 px) and of the v2 model's
  (``v2_level4`` .. ``v2_level0``: skip diffs one pixel channel wider,
  Cd = 2049, 1025, 513, 257, 65), as fused_serving_decode calls them: the
  skip and w1d at the width the checkout's ``kernel_args`` gives them
  (padded for the tensor cores where it pads), the weights packed once
  where the checkout packs them (``pack_level``), CUDA events over 5
  calls; ``routes`` the route each took;
* ``maps_per_s``: PairScorer(model_kind="local").score_arrays at batch 32
  with the default LocalModelConfig(resnet50_clip) (bf16 tower, float32
  decoder), seeded weights, steady state over at least 5 s after a warm
  call; ``v2_maps_per_s`` the same with ``v2=True``;
* ``errors``: max |kernel - float64| and max |plain - float64| of each
  bottleneck shape and of each decoder level (v2's too) at batch 4, the float64
  reference rounding h1 and h2 to float32 where the kernel does;
* ``nr_train_step_ms``: a train_nr_iqa step at batch 8 (float32 tower),
  the difference of a 12-epoch and a 2-epoch run over 32 images over the
  30 steps between them (a validation batch an epoch included), after a
  warm one-epoch run.

TF32 is off.  The card's name and power limit (nvidia-smi) go beside each
turn.  Without a card the script exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BOTTLENECKS = [((8, 28, 28, 512), 128, None), ((8, 14, 14, 1024), 256, None),
               ((8, 7, 7, 2048), 512, None), ((8, 56, 56, 256), 64, 8)]
# (h, cd, cu, cm, co, final_kernel, row tile) at batch 32; the v2 model's
# levels take one more skip channel, the pixel error.
LEVELS = {"level4": (7, 2048, 0, 2048, 2048, 3, None),
          "level3": (14, 1024, 2048, 1024, 1024, 3, None),
          "level2": (28, 512, 1024, 512, 512, 3, None),
          "level1": (56, 256, 512, 256, 256, 3, 7),
          "level0": (112, 64, 256, 64, 1, 1, 7)}
LEVELS.update({f"v2_{key}": (h, cd + 1, *rest)
               for key, (h, cd, *rest) in LEVELS.items()})
BATCH, WINDOW_S = 32, 5.0
NR_EPOCHS = (2, 12)


def f64_bottleneck(x, ws):
    """The float32 bottleneck's float64 reference (JAX-layout weights): h1
    and h2 rounded to float32 where the kernel rounds them."""
    import torch.nn.functional as F

    w1, b1, w2, b2, w3, b3 = (t.double() for t in ws)
    x64 = x.double()
    h1 = F.relu(x64 @ w1 + b1).float().double()
    h2 = F.conv2d(h1.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                  padding=1).permute(0, 2, 3, 1)
    h2 = F.relu(h2 + b2).float().double()
    return F.relu(h2 @ w3 + b3 + x64)


def f64_decoder(d, u, w1d, w1u, b1, w2, b2, fk):
    """A float32 decoder level's float64 reference (JAX layouts; u may be
    None): h1 rounded to float32 where the kernel rounds it."""
    import torch.nn.functional as F

    oihw = lambda k: k.double().permute(3, 2, 0, 1)  # noqa: E731
    acc = F.conv2d(d.double().permute(0, 3, 1, 2), oihw(w1d), padding=1)
    if u is not None:
        acc = acc + F.conv2d(u.double().permute(0, 3, 1, 2), oihw(w1u),
                             padding=1)
    h1 = F.relu(acc + b1.double().view(1, -1, 1, 1)).float().double()
    y = (F.conv2d(h1, oihw(w2), padding=1).permute(0, 2, 3, 1) if fk == 3
         else h1.permute(0, 2, 3, 1) @ w2.double())
    return F.relu(y + b2.double())


def max_err(got, ref) -> float:
    return float((got.double() - ref).abs().max())


def cuda_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("compare_f32_conv: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from srsem_torch.config import BackboneConfig, LocalModelConfig
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.local_models import make_local_model
    from srsem_torch.ops import _build
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_decoder as fd
    from srsem_torch.train.nr_iqa import train_nr_iqa

    out = {"package": str(Path(fb.__file__).resolve().parents[1])}
    t0 = time.perf_counter()
    _build.build_all()
    out["build_s"] = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)  # noqa: E731

    out["bottleneck"], out["errors"] = {}, {}
    for shape, wd, row_tile in BOTTLENECKS:
        c = shape[-1]
        ws = (randn(c, wd) * c ** -0.5, randn(wd) * 0.1,
              randn(3, 3, wd, wd) * (9 * wd) ** -0.5, randn(wd) * 0.1,
              randn(wd, c) * wd ** -0.5, randn(c) * 0.1)
        x = randn(*shape)
        packed = fb.pack_weights(ws, torch.float32)
        call = ((lambda: fb.fused_bottleneck_tiled(x, packed,
                                                   row_tile=row_tile))
                if row_tile else (lambda: fb.fused_bottleneck(x, packed)))
        key = "x".join(map(str, shape))
        out["bottleneck"][key] = cuda_ms(torch, call, 20)
        ref = f64_bottleneck(x, ws)
        out["errors"][key] = {
            "kernel_vs_f64": max_err(call(), ref),
            "plain_vs_f64": max_err(fb.plain_bottleneck(x, ws), ref)}

    out["decoder"], out["routes"] = {}, {}
    for key, (h, cd, cu, cm, co, fk, row_tile) in LEVELS.items():
        k2 = 9 if fk == 3 else 1
        mk = lambda *s, fan: randn(*s) * fan ** -0.5  # noqa: E731
        ws = [mk(3, 3, cd, cm, fan=9 * (cd + cu)),
              mk(3, 3, cu, cm, fan=9 * (cd + cu)) if cu else None,
              randn(cm) * 0.1,
              mk(*((3, 3) if fk == 3 else ()), cm, co, fan=k2 * cm),
              randn(co) * 0.1]
        d = randn(BATCH, h, h, cd).square()
        u = randn(BATCH, h, h, cu).abs() if cu else None
        # The skip and w1d at the width the checkout's kernel_args gives
        # them (padded once, as fused_serving_decode passes them), and the
        # weights packed once where the checkout packs them.
        args = fd.kernel_args(d, u, *ws, fk)
        pad = args[0].shape[-1] - cd
        d, ws[0] = F.pad(d, (0, pad)), F.pad(ws[0], (0, 0, 0, pad))
        level = ((fd.pack_level(*ws, fk, torch.float32),)
                 if hasattr(fd, "pack_level") else ws)
        call = ((lambda: fd.fused_decoder_level_tiled(
                    d, u, *level, row_tile=row_tile, final_kernel=fk))
                if row_tile else
                (lambda: fd.fused_decoder_level(d, u, *level,
                                                final_kernel=fk)))
        out["decoder"][key] = cuda_ms(torch, call, 5)
        out["routes"][key] = fd.kernel_plan(args, fk).route
        d = d[:4]  # call() now reads these: batch 4
        u = None if u is None else u[:4]
        ref = f64_decoder(d, u, *ws, fk)
        out["errors"][key] = {
            "kernel_vs_f64": max_err(call(), ref),
            "plain_vs_f64": max_err(
                fd.plain_decoder_level(d, u, *ws, fk, row_tile), ref)}
        del d, u, ref, args

    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    for key, v2 in (("maps_per_s", False), ("v2_maps_per_s", True)):
        cfg = LocalModelConfig(backbone=BackboneConfig(
            kind="resnet50_clip", image_size=224), v2=v2)
        model = make_local_model(cfg,
                                 generator=torch.Generator().manual_seed(0))
        scorer = PairScorer(cfg, model.to(dev).eval(), batch_size=BATCH,
                            model_kind="local")
        scorer.score_arrays(a, b)
        torch.cuda.synchronize()
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < WINDOW_S:
            scorer.score_arrays(a, b)
            torch.cuda.synchronize()
            calls += 1
        out[key] = BATCH * calls / (time.perf_counter() - t0)
        del scorer, model
    out["decoder_dtype"] = cfg.decoder_dtype

    imgs = rng.random((32, 224, 224, 3), dtype=np.float32)
    train_nr_iqa(imgs, epochs=1, batch_size=8, device=dev)  # warm
    took = {}
    for epochs in NR_EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_nr_iqa(imgs, epochs=epochs, batch_size=8, device=dev)
        torch.cuda.synchronize()
        took[epochs] = time.perf_counter() - t0
    # 32 images at batch 8: three train steps an epoch (and a validation
    # batch), so the runs differ by 3 * (12 - 2) steps.
    lo, hi = NR_EPOCHS
    out["nr_train_step_ms"] = (took[hi] - took[lo]) / (3 * (hi - lo)) * 1e3
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", type=Path, help="time one checkout")
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=CHECKOUT (repeat)")
    ap.add_argument("--order", help="labels in the order to run them")
    ap.add_argument("--out", type=Path, help="write every turn here too")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    card = nvidia_smi()
    turns = []
    for i, label in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             trees[label]], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        turn = {"turn": i, "label": label, "card": card,
                **json.loads(proc.stdout.strip().splitlines()[-1])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(t) + "\n" for t in turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
