#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failure exits non-zero):

1. device  — the card's name and power limit (nvidia-smi) and the count.
2. build   — nvcc builds every csrc/*.cu kernel from the checkout (one
             nvcc per source, in parallel); the -Xptxas -v lines.
3. kernels — each kernel against its plain PyTorch version at every
             main-path shape (batch 64, 224 px), in float32 with TF32 off
             and in bf16, with the stated tolerances; then CUDA-event times
             in bf16 (the serving dtype) of the kernel, its plain version,
             a one-call PyTorch yardstick, and the card's bound.
4. slice   — the full-width flagship scorer GlobalModelConfig(resnet50,
             224, bfloat16, stages_cnn, depth 3) with seeded random
             weights: PairScorer.score_paths over synthetic JPEG/PNG pairs
             and a corrupt file (NaN on exactly that row), with every
             launch count reset just before and read just after; float32
             kernel-path scores against the plain module (TF32 off, 1e-3);
             score_arrays pairs/s at batch 64; a torch.profiler window
             over three batches (device busy share, device time by
             kernel); ``python -m srsem_torch score`` as a subprocess.
5. result  — the card line, the ``kernels`` line (per kernel: launches in
             the slice run, worst bf16 error, and times summed over one
             scored batch's launches), the device line.

Bounds use an H100 SXM's published peaks: 3.35 TB/s, 989 TFLOP/s bf16
tensor cores, 67 TFLOP/s float32 outside them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
BATCH = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
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


def bound(nbytes: float, flops: float, peak_flops: float):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# Main-path shapes at batch 64, 224 px, and launches per scored batch
# (two tower passes; one head call per tapped stage).
HEAD_SHAPES = [((BATCH, 56, 56, 256), 1), ((BATCH, 28, 28, 512), 1),
               ((BATCH, 14, 14, 1024), 1), ((BATCH, 7, 7, 2048), 1)]
BOTTLENECK_SHAPES = [((BATCH, 28, 28, 512), 128, 6),
                     ((BATCH, 14, 14, 1024), 256, 10),
                     ((BATCH, 7, 7, 2048), 512, 4)]
TILED_SHAPES = [((BATCH, 56, 56, 256), 64, 4)]


def check_kernels(torch):
    """Phase 3; returns {kernel name: summary}."""
    import torch.nn.functional as F

    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)  # noqa: E731
    summary = {}

    def add(name, err, ms, plain, lib, bms, by, count):
        s = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                      "plain_ms": 0.0, "library_ms": 0.0,
                                      "bound_ms": 0.0, "by": {}})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms)):
            s[key] += v * count
        s["by"][by] = s["by"].get(by, 0.0) + bms * count

    # -- head (Triton) ----------------------------------------------------
    for shape, count in HEAD_SHAPES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            fa = randn(*shape).abs().to(dtype)  # taps are post-ReLU
            fb_ = randn(*shape).abs().to(dtype)
            w = randn(shape[-1]) * 0.05
            got = fh.fused_stage_score(fa, fb_, w, 0.25)
            want = fh.plain_stage_sums(fa, fb_, w) / (shape[1] * shape[2]) + 0.25
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-5 + 1e-5 * float(want.abs().max())
            errs[str(dtype)] = err
            if not err <= tol:
                raise AssertionError(f"fused_stage_score {shape} {dtype}: "
                                     f"max |err| {err} > {tol}")
        # bf16 inputs (the serving taps) for the times.
        ms = cuda_ms(torch, lambda: fh.fused_stage_score(fa, fb_, w, 0.25), 20)
        plain = cuda_ms(torch, lambda: fh.plain_stage_sums(fa, fb_, w), 20)
        lib = cuda_ms(torch, lambda: ((fa - fb_) ** 2 * w).sum((1, 2, 3)), 20)
        elems = fa.numel()
        bms, by = bound(2 * elems * fa.element_size() + 4 * shape[-1]
                        + 4 * shape[0], 4 * elems, F32_FLOPS)
        emit("kernel", name="fused_stage_score", shape=list(shape),
             max_abs_err=errs, tolerance="1e-5 + 1e-5*max|want| (f32 sums "
             "in another order)", ms=ms, plain_ms=plain, library_ms=lib,
             bound_ms=bms, bound_by=by)
        add("fused_stage_score", errs[str(torch.bfloat16)], ms, plain, lib,
            bms, by, count)

    # -- bottleneck (CUDA C++) -------------------------------------------
    def weights(c, wd):
        mk = lambda *s, f: randn(*s) * f  # noqa: E731
        return (mk(c, wd, f=c ** -0.5), mk(wd, f=0.1),
                mk(3, 3, wd, wd, f=(9 * wd) ** -0.5), mk(wd, f=0.1),
                mk(wd, c, f=wd ** -0.5), mk(c, f=0.1))

    for name, shapes in (("fused_bottleneck", BOTTLENECK_SHAPES),
                         ("fused_bottleneck_tiled", TILED_SHAPES)):
        wrapper = getattr(fb, name)
        for shape, wd, count in shapes:
            row_tile = 8 if name == "fused_bottleneck_tiled" else None
            kw = {"row_tile": row_tile} if row_tile else {}
            ws = weights(shape[-1], wd)
            errs = {}
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = randn(*shape).to(dtype)
                got = wrapper(x, *ws, **kw)
                want = fb.plain_bottleneck(x, ws, row_tile)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                errs[str(dtype)] = err
                limit = tol + tol * want.float().abs()
                if not bool((diff <= limit).all()):
                    raise AssertionError(f"{name} {shape} {dtype}: max |err| "
                                         f"{err} beyond rtol=atol={tol}")
            th, tw = fb.kernel_tile(x, wd, row_tile)
            ms = cuda_ms(torch, lambda: wrapper(x, *ws, **kw), 5)
            plain = cuda_ms(torch, lambda: fb.plain_bottleneck(x, ws, row_tile),
                            3)
            # Yardstick: the cuDNN chain of three convs with the same folded
            # weights, channels_last bf16.
            xc = x.permute(0, 3, 1, 2)
            k1 = ws[0].t()[:, :, None, None].to(x.dtype)
            k2 = ws[2].permute(3, 2, 0, 1).contiguous().to(x.dtype)
            k3 = ws[4].t()[:, :, None, None].to(x.dtype)
            c1, c2, c3 = (b.to(x.dtype) for b in (ws[1], ws[3], ws[5]))

            def chain():
                h = F.relu(F.conv2d(xc, k1, c1))
                h = F.relu(F.conv2d(h, k2, c2, padding=1))
                return F.relu(F.conv2d(h, k3, c3) + xc)

            lib = cuda_ms(torch, chain, 5)
            n, h, w_, c = shape
            flops = 2 * n * h * w_ * (c * wd + 9 * wd * wd + wd * c)
            nbytes = (2 * x.numel() * 2 + 2 * (2 * c * wd + 9 * wd * wd)
                      + 4 * (2 * wd + c))
            bms, by = bound(nbytes, flops, BF16_TC_FLOPS)
            emit("kernel", name=name, shape=list(shape), wd=wd,
                 tile=[th, tw], max_abs_err=errs,
                 tolerance="f32 (TF32 off) rtol=atol=1e-4; bf16 "
                 "rtol=atol=2e-2 (bf16 ulps where f32 sums round apart)",
                 ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, tflops=flops / ms / 1e9)
            add(name, errs[str(torch.bfloat16)], ms, plain, lib, bms, by,
                count)
    return summary


def seeded_model(torch, np, cfg, seed: int = 0):
    """Full-width GlobalPairScorer with seeded random weights: Kaiming
    convs, random frozen-BN statistics (small gammas closing each residual
    branch keep activations O(1)), nonnegative head weights, biases +1."""
    from srsem_torch.backbones.resnet import FrozenBatchNorm
    from srsem_torch.models.global_models import make_global_model

    model = make_global_model(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.backbone.named_modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                closing = name.endswith(("bn3", "downsample.1"))
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if closing
                                   else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))
        # Nonnegative head weights scaled so the squared-diff term, not the
        # +1 bias, carries each score; biases +1 keep the ReLU open.
        for layer in model.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
    return model


def write_pairs(np, root: Path, n: int):
    from PIL import Image

    rng = np.random.default_rng(1)
    pairs = []
    for i in range(n):
        size = [(256, 320), (300, 240), (224, 224), (480, 512)][i % 4]
        a = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        noise = rng.integers(-20, 21, a.shape)
        b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
        pa, pb = root / f"gt{i}.png", root / f"sr{i}.jpg"
        Image.fromarray(a).save(pa)
        Image.fromarray(b).save(pb, quality=90)
        pairs.append((str(pa), str(pb)))
    bad = root / "corrupt.jpg"
    bad.write_bytes(b"\xff\xd8 truncated, not a JPEG")
    pairs.append((pairs[0][0], str(bad)))
    return pairs


def _kernel_group(name: str) -> str:
    if "fused_bottleneck" in name:
        return "bottleneck kernel"
    if name in ("partials", "total"):
        return "head kernel"
    if "memcpy" in name.lower():
        return "memcpy"
    if any(k in name.lower() for k in ("conv", "xmma", "cudnn", "implicit",
                                       "gemm", "cutlass", "sm90")):
        return "cudnn conv"
    return "other (elementwise, pooling, casts)"


def profile_scoring(torch, scorer, a, b, reps: int = 3) -> dict:
    """torch.profiler over ``reps`` scored batches: the device's busy and
    idle share of the host wall time, and device ms a batch by group and
    by kernel.  Busy time is the union of the device events' intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            scorer.score_arrays(a, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    if not spans:
        return {"busy_share": None, "note": "the profiler saw no device "
                "events: device time not measured"}
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy, last = busy + end - start, end
        elif end > last:
            busy, last = busy + end - last, end
    groups = {}
    for name, us in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / reps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"batches": reps, "wall_ms_per_batch": wall_us / reps / 1e3,
            "device_busy_ms_per_batch": busy / reps / 1e3,
            "busy_share": busy / wall_us, "idle_share": 1 - busy / wall_us,
            "device_ms_per_batch_by_group": groups,
            "top_kernels_ms_per_batch": {n[:90]: us / reps / 1e3
                                         for n, us in top}}


def run_slice(torch, np, card: str):
    """Phase 4; returns {kernel name: launches in the main-path run}."""
    import dataclasses

    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_head as fh

    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50", image_size=224, compute_dtype="bfloat16"),
        head="stages_cnn", depth=3)
    model = seeded_model(torch, np, cfg)
    scorer = PairScorer(cfg, model, batch_size=BATCH)
    wrappers = {"fused_stage_score": fh.fused_stage_score,
                "fused_bottleneck": fb.fused_bottleneck,
                "fused_bottleneck_tiled": fb.fused_bottleneck_tiled}
    with tempfile.TemporaryDirectory() as tmp:
        pairs = write_pairs(np, Path(tmp), 8)
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        scores = scorer.score_paths(pairs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        nan = np.isnan(scores)
        if not (nan[-1] and not nan[:-1].any() and (scores[:-1] > 0).all()):
            raise AssertionError(f"score_paths: want NaN on exactly the "
                                 f"corrupt last row, got {scores.tolist()}")
        emit("slice", step="score_paths", pairs=len(pairs),
             scores=[float(s) for s in scores], seconds=seconds,
             launches=launches)
        # float32 kernel path vs the plain module, TF32 off.
        decode = scorer.preprocess.decode_uint8
        a = np.stack([decode(p[0]) for p in pairs[:-1]])
        b = np.stack([decode(p[1]) for p in pairs[:-1]])
        cfg32 = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, compute_dtype="float32"))
        model32 = seeded_model(torch, np, cfg32)
        kernel32 = PairScorer(cfg32, model32, batch_size=BATCH)
        got = kernel32.score_arrays(a, b)
        plain32 = PairScorer(cfg32, model32, batch_size=BATCH,
                             fused_tower=False).score_arrays(a, b)
        pre = kernel32.preprocess
        with torch.inference_mode():
            module = model32(pre.device_normalize(torch.tensor(a).cuda()),
                             pre.device_normalize(torch.tensor(b).cuda()))
        for name, want in (("plain_tower_scorer", plain32),
                           ("plain_module", module)):
            rel = float(((got - want).abs() / want.abs()).max())
            if not torch.allclose(got, want, rtol=1e-3, atol=1e-3):
                raise AssertionError(f"f32 kernel path vs {name}: max rel "
                                     f"err {rel} beyond 1e-3")
            emit("slice", step=f"f32_kernel_path_vs_{name}", max_rel_err=rel,
                 tolerance="rtol=atol=1e-3", scores=got.tolist())
        if not torch.isfinite(scorer.score_arrays(a, b)).all():
            raise AssertionError("bf16 scores are not finite")

        # Throughput of score_arrays at batch 64, bf16.
        rng = np.random.default_rng(2)
        a64 = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        b64 = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        for _ in range(2):
            scorer.score_arrays(a64, b64)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = scorer.score_arrays(a64, b64)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        if not torch.isfinite(out).all():
            raise AssertionError("score_arrays at batch 64 not finite")
        emit("slice", step="score_arrays_throughput", batch=BATCH,
             dtype="bfloat16", image=224, ms_per_batch=dt * 1e3,
             pairs_per_s=BATCH / dt, card=card)
        emit("slice", step="profile", card=card,
             **profile_scoring(torch, scorer, a64, b64))

        # The CLI entry point, as a user runs it.
        csv_path = Path(tmp) / "pairs.csv"
        csv_path.write_text("img_a_pth,img_b_pth\n"
                            + "".join(f"{x},{y}\n" for x, y in pairs))
        out_csv = Path(tmp) / "scores.csv"
        proc = subprocess.run(
            [sys.executable, "-m", "srsem_torch", "score", str(csv_path),
             "--batch-size", "16", "--out", str(out_csv)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        rows = out_csv.read_text().splitlines()
        if result["nan"] != 1 or len(rows) != len(pairs) + 1:
            raise AssertionError(f"CLI result {result}, {len(rows)} rows")
        emit("slice", step="cli", result=result)
    return launches


def main() -> int:
    if not (REPO / "srsem_torch" / "csrc").is_dir():
        return fail(f"no srsem_torch package beside {__file__}")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"import: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", nvidia_smi=card, kind=kind, count=count,
         torch=torch.__version__, cuda=torch.version.cuda)

    from srsem_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": b.seconds,
                      "ptxas": [ln.strip() for ln in b.log.splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, b in built.items()})

    summary = check_kernels(torch)
    launches = run_slice(torch, np, card)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        return fail(f"main path launched no {missing}")

    meta = {
        "fused_stage_score": ("triton", "srsem_torch/ops/fused_head.py",
                              "srsem/ops/fused_head.py:89"),
        "fused_bottleneck": ("cuda", "srsem_torch/csrc/fused_bottleneck.cu",
                             "srsem/ops/fused_bottleneck.py:123"),
        "fused_bottleneck_tiled": ("cuda",
                                   "srsem_torch/csrc/fused_bottleneck.cu",
                                   "srsem/ops/fused_bottleneck.py:276"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": max(s["by"], key=s["by"].get),
            "library_ms": s["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
