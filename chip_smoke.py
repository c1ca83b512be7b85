#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failure exits non-zero):

1. device  — the card's name and power limit (nvidia-smi) and the count.
2. build   — nvcc builds every csrc/*.cu kernel from the checkout (one
             nvcc per source, in parallel); the -Xptxas -v lines, and per
             head-kernel instance its registers, stack frame and spills
             (fails if a stack frame grew past HEAD_STACK_FRAMES or the
             pairwise bf16 instance spills).
3. kernels — each kernel against its plain PyTorch version at every
             main-path shape (224 px; batch 64 on the global path, 32 on
             the CLU path, whose CLIP tower runs the bottleneck kernels
             too), in float32 with TF32 off and in bf16, with the
             stated tolerances (the bottleneck also at a ragged shape, the
             decoder at a v2 shape and at the u=None level-4 shape); then
             CUDA-event times in bf16 (the serving dtype) of the kernel,
             its plain version, a one-call PyTorch yardstick, and the
             card's bound; for the bottleneck also its plan and each of
             its three launches' device time (torch.profiler).  The head
             kernel is checked per stage (off the path), as the whole
             head in one launch at batch 64 (the path) and in its grouped
             form at G = 16, K = 4, each also for identical bits from two
             launches, with its device time; and so is wperlay_cnn's head
             at 12 taps (depth 11) and at 4 (depth 3), and the ViT token
             head on float32 (64, 197, 768) taps: stages_vit's 4 (the vit
             path; also timed on the general path, the W = 768 plan before
             the 1536-element step), wperlay_vit's and single_lin_vit's
             (shared head) 12 at depth 11, and stages_vit grouped at G =
             16, K = 4 and at G = 8, K = 8 (the instance streaming the
             most SR images), each line with the plan's vec flags and
             steps.
4. slice   — the full-width flagship scorer GlobalModelConfig(resnet50,
             224, bfloat16, stages_cnn, depth 3) with seeded random
             weights: PairScorer.score_paths over synthetic JPEG/PNG pairs
             and a corrupt file (NaN on exactly that row), with every
             launch count reset just before and read just after; float32
             kernel-path scores against the plain module (TF32 off, 1e-3);
             score_arrays pairs/s at batch 64; a torch.profiler window
             over three batches (device busy share, device time by
             kernel); ``python -m srsem_torch score`` as a subprocess;
             GroupedPairScorer pairs/s at G = 16, K = 4, its float32
             scores against PairScorer's on the repeated pairs (1e-4),
             and ``python -m srsem_torch score-groups`` as a subprocess.
5. clu     — the CLU map model LocalModelConfig(resnet50_clip, 224,
             bfloat16, decoder bfloat16, v2 off), full width, seeded
             weights: PairScorer(model_kind="local").score_paths (NaN map
             on exactly the corrupt row, the rest finite in [0.5, 1]) with
             the launch counts reset just before and read just after;
             float32 kernel-path maps against the plain module (TF32 off,
             2e-3); score_arrays maps/s at batch 32; a profile of three
             batches; ``python -m srsem_torch score-maps-groups`` (K = 2)
             as a subprocess.
6. heads   — wperlay_cnn (depth 11, 12 taps) on the full-width CLIP tower,
             bf16, with a trained head written by the port's checkpoint
             writer and read back bit-equal (a CluUnet's decoder and
             batch_stats too): score_paths with the launch counts reset
             just before and read just after (the wperlay path), pairs/s
             and one head launch a batch for PairScorer (batch 64) and
             GroupedPairScorer (G = 16, K = 4), a profile of three
             batches, float32 grouped vs pairwise (1e-4) and kernel path
             vs plain module (1e-3);
             stages_cnn_pooling, emb_lin (batch 64) and unet_global
             (batch 32, maps, 2e-3) against their plain modules in
             float32, finite in bf16; ``python -m srsem_torch score
             --checkpoint DIR --set head=wperlay_cnn --set depth=11`` as a
             subprocess (NaN on exactly the corrupt row).
7. serve   — ScoreService over the flagship global model and, with
             maps, the CLU model (bf16 decoder), group_batch 8, warmed at
             K = 1 and 4 (peak device memory after warmup): one score and
             one maps batch of G = 8, K = 4 with the launch counts reset
             just before and read just after (one grouped head launch,
             four tower passes, three decoder calls; a null on exactly the
             corrupt SR); a profile of one score batch; serve_http on a
             free port, driven by client processes of their own: lone
             K = 4 latency p50/p99 with the decode cache off and warm, 32
             concurrent clients (pairs/s, device batches, mean fill > 1,
             the collector's busy share and its device calls' ms); float32
             service scores and map means against the grouped scorers
             (1e-5 + 1e-5*max); ``python -m srsem_torch serve --warmup-k 1
             4 --with-maps`` over stdio fed a script (ping, K = 4, scalar,
             corrupt GT -> nulls, malformed line, maps with maps_dir,
             stats, shutdown; exit 0).
8. dual    — DualScorer(resnet50_clip, 224, bf16): score_folders with one
             corrupt SR (its row NaN, the only one) and the counts reset
             around it (24 bottleneck calls for 32 pairs, one head launch,
             three decoder calls); float32 scores and maps against the
             global and the local PairScorer (1e-5 + 1e-5*max); pairs/s at
             batch 32 against the two scorers one after the other, in
             turns; the discarded attention pool's ms; a profile;
             ``python -m srsem_torch sweep-dataset`` as a subprocess.  Its
             ``native`` line: whether the C++ decoder built (and why not),
             host seconds an image through it and through PIL with the
             host's cpu count, and when built its bytes against PIL's
             (mean < 0.5, 99.9% <= 6, max <= 16) and
             PairScorer(decode_backend="native") with a NaN row on exactly
             the corrupt file.
9. train   — the training slice with a CLIP tower with random BN
             statistics, written as an OpenAI-CLIP state dict and read
             through ``--backbone-checkpoint``: ``train-global`` in process
             at its defaults (resnet50_clip, 224, bf16 tower, stages_cnn
             depth 3, batch 5) for two epochs over a synthetic user-study
             set (SR = GT blended with a permuted copy at strength alpha,
             label alpha) with a checkpoint directory; ``eval-global
             --checkpoint --val-only``; ``score --checkpoint`` on the
             validation pairs against the trained model's validation
             predictions (1e-3 + 1e-3*max); ``train-clu`` at batch 80 over
             a KonIQ-style pairs CSV with pickled maps (every decoder BN's
             running statistics moved); the train path: one global step at
             batch 5 and one CLU step at batch 80 with the launch counts
             reset just before and read just after (a tower pass over the
             2N images: 10 + 2 bottleneck calls each); throughput at batch
             5 and 64 (global) and 80 (CLU): steps/s, pairs/s or maps/s,
             peak memory, losses and a profile of three steps; one
             float32 train step through the fused tower against the module
             tower (loss rtol 1e-5, head atol 1e-6); the SRCC rehearsal
             at 224 px (tests/test_srcc_rehearsal.py's planted signal:
             40 train and 16 validation pairs, batch 8, 30 epochs,
             stages_cnn depth 2): the port's ``train_global`` (kernel
             tower) beside a plain-module loop (module tower, the same
             head and Adam, the same batches), in float32 (TF32 off) and
             in bf16; each SRCC and the two deltas (fails if the float32
             delta exceeds 0.005; bf16 recorded).
10. finetune — tower training at full width from the train phase's
             tower: the CLU at batch 80 with LoRA (rank 32) on every tower
             conv and with the whole tower trained under activation
             checkpointing ("full"), the global ``enc_ft`` step at batch
             5 and 64: ms a step, maps or pairs/s, memory, profiles.  A
             trained tower runs as the module: no bottleneck kernel may
             launch.  Card checks: a LoRA step moves only the factors and
             the decoder, a "full" step the tower's BN running means and
             variances; float32 (TF32 off): the first LoRA forward (A =
             0) equals the frozen module tower's (1e-6), the checkpointed
             tower's gradients an un-checkpointed pass's (1e-4 of each
             tensor's max); ``fused_tower=True`` on a LoRA model raises.
11. sweeps — the frozen-tower amortizations: the global depth grid (1-3)
             at batch 5 over a 300-pair user study (240 train pairs,
             decoded once, in bulk): the shared tower (one epoch), the
             diff cache and the stat cache (4 epochs; build seconds,
             bytes, epochs/s from the cache), the closed form (each
             solve's ms); ``train-clu --cached-diffs`` and ``--thresholds
             none 0.4 0.9`` at batch 80 in process; the sweeps path is
             those timed runs, the launch counts reset just before each
             and read just after: 10 + 2 bottleneck calls a tower pass,
             one pass a batch.  Card checks: a cached step's loss and
             head gradients equal an uncached one's (1e-6), a stat-cache
             step's a diff-cache step's (1e-5), the closed form's train
             MSE at most the Adam heads'.
12. vit    — stages_vit (depth 3) on the full-width CLIP ViT-B/16 (224
             px, bf16 tower, float32 taps), seeded weights: the tower as a
             timm state dict through ``convert --kind clip_vit`` (bits
             equal after the round trip); score_paths with the counts reset
             just before and read just after (one head launch a batch, no
             bottleneck launch; NaN on exactly the corrupt row); float32
             kernel path against the module (TF32 off, 1e-3); pairs/s at
             batch 64 and a profile (busy share; device ms for GEMMs,
             attention, copies and casts, other elementwise, the head);
             GroupedPairScorer at G = 16, K = 4 (pairs/s, float32 against
             pairwise, 1e-4); ``score-groups --set head=wperlay_vit --set
             depth=11`` and ``score --backbone-checkpoint`` (subprocesses,
             one corrupt file each); a frozen and an enc_ft train step at
             batch 5 (ms a step); the plain attention against
             ``F.scaled_dot_product_attention`` on the same q, k, v.
13. nr_train — ``train-nr-iqa`` at its defaults (224 px, batch 8,
             float32 tower) for one epoch over 32 images (three steps and
             a validation batch: four float32 tower passes of 8), the
             counts reset just before and read just after; ms a train
             step; the float32 GAP features and scores through the kernel
             tower against the module tower (1e-3).
14. iqa    — ``folder-metrics`` over 64 synthetic pairs (224 px) at
             batch 32 with LPIPS alex and the nr_train phase's NR-IQA
             head (bf16 tower: two passes of 32), then the pyramid LPIPS
             (``make_pyramid_lpips``: two 2N = 64 passes), the counts
             reset before the first and read after the second; pairs/s
             of each metric set in the steady state (at least 5 s after a
             warm pass; set-up timed apart); four pairs in float32 on the
             card against the CPU (1e-3 + 1e-3·|x|; the pyramid on a
             float32 copy of its tower, 1e-3·|x|); a corrupt SR file
             gives a NaN row.
15. text   — ``score_caption_pairs`` over 2,048 captions through a seeded
             full-width MiniLM (6 layers, 384; WordPiece on a written
             30,522-entry vocab.txt), ``embed_image_folder`` over 128
             images (one corrupt: a NaN row) at batch 64 through the CLIP
             ResNet-50 (bf16: two passes of 64) and ``score_c2i`` with the
             full-width CLIP text tower; counts reset before the captions
             and read after the C2I scores; captions/s, images/s in the
             steady state (as iqa's; set-up timed apart); MiniLM
             and float32 C2I embeddings on the card against the CPU
             (1e-3).
16. result — a ``timing`` line (seconds of each phase), the card line,
             the ``kernels`` line (per kernel: launches in the runs of
             the paths that use it, worst bf16 error, and times summed
             over one scored batch's launches of each path at that
             path's shapes; under ``paths``, each path's own launches
             and times: global, clu, wperlay, serve (one score and one
             maps batch), dual, train (one global and one CLU train
             step), sweeps (the train path's tower passes at 10 and 160
             images, times ``SWEEP_PASSES``), vit (one scored batch),
             nr_train (its four float32 passes of 8, timed in float32),
             iqa (the clu and the global path's passes), text (the
             global path's); the head's entry, ``fused_stage_score``
             after the TPU kernel it replaces, counts the whole-head
             launches of ``fused_global_score`` and, on the serve path,
             ``fused_grouped_score``), the device line.

Bounds use an H100 SXM's published peaks: 3.35 TB/s, 989 TFLOP/s bf16
tensor cores, 67 TFLOP/s float32 outside them.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
BATCH = 64
CLU_BATCH = 32


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


def launch_ms(torch, fn, name: str, per_call: int, reps: int = 5):
    """Device ms of each of the ``per_call`` CUDA launches a call of ``fn``
    makes (kernels whose name holds ``name``, in launch order), averaged
    over ``reps`` calls, from torch.profiler; None when it saw no launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and name in e.name)
    if len(spans) != reps * per_call:
        return None
    return [sum(end - start for start, end in spans[i::per_call]) / reps / 1e3
            for i in range(per_call)]


def bound(nbytes: float, flops: float, peak_flops: float):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# Main-path shapes at 224 px, per path ("global": the global scorer at
# batch 64; "clu": the CLU map model at batch 32), and launches per scored
# batch (two tower passes; one head launch over the four tapped stages).
# Both towers run the same interior bottlenecks: the CLIP tower's stride-1
# blocks are the ImageNet ones.
PATH_BATCH = {"global": BATCH, "clu": CLU_BATCH}
HEAD_TAPS = [(56, 56, 256), (28, 28, 512), (14, 14, 1024), (7, 7, 2048)]
# wperlay_cnn's taps on the CLIP tower: at depth 11 the 12 per-block taps,
# three of each stage's shape; at depth 3 (the reference's deepest sweep
# setting) the last four.
WPERLAY_TAPS = {11: [s for s in HEAD_TAPS for _ in range(3)]}
WPERLAY_TAPS[3] = WPERLAY_TAPS[11][-4:]
# The grouped scorer's batch: G GT images against K SR images each.
GROUP_G, GROUP_K = 16, 4
# A ViT-B/16 token tap at 224 px: the class token and 14x14 patches, width
# 768 (float32: the residual stream's dtype).
VIT_TOKENS = (197, 768)
# The service's top bucket (serve --group-batch, the JAX default) and the
# K its device batches are measured at: a score batch runs the ImageNet
# tower over G GT and G·K SR images, a maps batch the CLIP tower over the
# same; the dual scorer's batch (the JAX DualScorer default).
SERVE_G, SERVE_K = 8, 4
DUAL_BATCH = 32
IMAGE = 224  # the serve and dual phases' image size
# Bottleneck wrapper calls a tower pass (interior stride-1 blocks; the
# first block of each stage downsamples) — either tower.
PASS_CALLS = {"fused_bottleneck": 3 + 5 + 2, "fused_bottleneck_tiled": 2}
BOTTLENECK_SHAPES = {path: [((n, 28, 28, 512), 128, 6),
                            ((n, 14, 14, 1024), 256, 10),
                            ((n, 7, 7, 2048), 512, 4)]
                     for path, n in PATH_BATCH.items()}
# The serve path's GT passes (G = 8 images, one a tower: the score and the
# maps batch); its G·K = 32-image SR passes run the CLU path's shapes,
# which check_kernels adds to it, as it gives the dual path the CLU path's.
BOTTLENECK_SHAPES["serve"] = [((SERVE_G, 28, 28, 512), 128, 6),
                              ((SERVE_G, 14, 14, 1024), 256, 10),
                              ((SERVE_G, 7, 7, 2048), 512, 4)]
# The train path: one global train step at batch 5 and one CLU train step
# at batch 80, each one tower pass over its 2N images (10 and 160).
BOTTLENECK_SHAPES["train"] = [((n, h, h, c), wd, k)
                              for n in (10, 160)
                              for (h, c, wd, k) in ((28, 512, 128, 3),
                                                    (14, 1024, 256, 5),
                                                    (7, 2048, 512, 2))]
# The nr_train path: ``train-nr-iqa`` at its batch of 8 over NR_IMAGES
# images for one epoch (three train steps, one validation batch of 8),
# one float32 ImageNet tower pass a batch (the trainer's default tower
# dtype, timed in float32: ``TIMED_DTYPE``).
NR_IMAGES, NR_BATCH = 32, 8
NR_PASSES = NR_IMAGES // NR_BATCH
BOTTLENECK_SHAPES["nr_train"] = [((NR_BATCH, h, h, c), wd, k * NR_PASSES)
                                 for (h, c, wd, k) in ((28, 512, 128, 3),
                                                       (14, 1024, 256, 5),
                                                       (7, 2048, 512, 2))]
TIMED_DTYPE = {"nr_train": "float32"}
# Checked and not on the main path: ragged H and W (a ragged last flat
# tile, ragged patches, an odd patch count).
BOTTLENECK_SHAPES["global"].append(((9, 13, 11, 1024), 256, 0))
TILED_SHAPES = {path: [((n, 56, 56, 256), 64, 4)]
                for path, n in {**PATH_BATCH, "serve": SERVE_G}.items()}
TILED_SHAPES["train"] = [((10, 56, 56, 256), 64, 2),
                         ((160, 56, 56, 256), 64, 2)]
TILED_SHAPES["nr_train"] = [((NR_BATCH, 56, 56, 256), 64, 2 * NR_PASSES)]
# CLU decoder levels at batch 32, 224 px: (n, h, w, cd, cu, cm, co,
# final_kernel, row tile, wrapper calls per scored batch).  The last two
# rows are checked and not on the default path (v2's odd skip width;
# level 4, u=None).  A call makes one or two CUDA launches (``patch``,
# ``cuda_launches`` and ``rows_executed_over_useful`` in its line come
# from the kernel's plan).
DECODER_SHAPES = {
    "fused_decoder_level": [(CLU_BATCH, 28, 28, 512, 1024, 512, 512, 3, None, 1),
                            (CLU_BATCH, 7, 7, 2048, 0, 2048, 2048, 3, None, 0)],
    "fused_decoder_level_tiled": [
        (CLU_BATCH, 56, 56, 256, 512, 256, 256, 3, 7, 1),
        (CLU_BATCH, 112, 112, 64, 256, 64, 1, 1, 7, 1),
        (CLU_BATCH, 56, 56, 257, 512, 256, 256, 3, 7, 0)],
}


def check_kernels(torch):
    """Phase 3; returns {(kernel name, path): summary}: the worst bf16
    error, and ms / plain_ms / library_ms / bound_ms summed over the
    path's launches in one scored batch (``launches``)."""
    import torch.nn.functional as F

    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)  # noqa: E731
    summary = {}

    def add(name, path, err, ms, plain, lib, bms, by, count):
        s = summary.setdefault((name, path), {
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "by": {}})
        s["launches"] += count
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms)):
            s[key] += v * count
        s["by"][by] = s["by"].get(by, 0.0) + bms * count

    # -- head (CUDA C++) ---------------------------------------------------
    from srsem_torch.models.global_models import (
        ConvHeadAggregator,
        grouped_diff_pyramid,
        squared_diffs,
    )

    def check_head(label, make, call, plain):
        """``call(*make(dtype))`` against ``plain`` in float32 and bf16
        within 1e-5 + 1e-5*max|want|, and a second launch on the same
        inputs giving the same bits; returns the errors and the bf16
        inputs (the serving taps), which the times use."""
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args = make(dtype)
            got = call(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-5 + 1e-5 * float(want.abs().max())
            errs[str(dtype)] = err
            if not (err <= tol and bool((want > 0).all())):
                raise AssertionError(f"{label} {dtype}: max |err| {err} > "
                                     f"{tol} (or a score not > 0)")
            if not torch.equal(call(*args), got):
                raise AssertionError(f"{label} {dtype}: two launches differ")
        return errs, args

    head_tol = "1e-5 + 1e-5*max|want| (f32 sums in another order)"

    def conv_head(shapes):
        """A head over ``shapes`` with small nonnegative weights and biases
        +0.25 (the ReLU passes every score), on the card."""
        head = ConvHeadAggregator([c for _, _, c in shapes])
        head.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for layer in head.w_layers:
                layer.weight.abs_().mul_(0.05)
                layer.bias.fill_(0.25)
        return head.to(dev).requires_grad_(False)

    def tap_set(shapes):
        names = [f"tap{j}" for j in range(len(shapes))]

        def taps(n, dtype):  # taps are post-ReLU
            return {nm: randn(n, *s).abs().to(dtype)
                    for nm, s in zip(names, shapes)}

        return names, taps

    def head_bound(images, k, shapes=HEAD_TAPS):
        """bf16 taps of ``images`` images (GT and SR, K SR a GT) read once,
        the packed head read once, one float32 score a pair written: bytes;
        4 operations an element of each pair."""
        elems = sum(h * w * c for h, w, c in shapes)
        cs = sum(c for _, _, c in shapes)
        pairs = images // (1 + k) * k
        return bound(images * elems * 2 + 4 * (cs + len(shapes))
                     + 4 * pairs, 4 * elems * pairs, F32_FLOPS)

    head = conv_head(HEAD_TAPS)
    packed = fh.pack_head(head)
    names, taps = tap_set(HEAD_TAPS)

    # Per stage, as the TPU kernel's wrapper is called (not on the path:
    # the scorer makes one whole-head launch a batch).
    for h, w_, c in HEAD_TAPS:
        shape = (BATCH, h, w_, c)
        errs, (fa, fb_, w) = check_head(
            f"fused_stage_score {shape}",
            lambda dt: (randn(*shape).abs().to(dt),
                        randn(*shape).abs().to(dt), randn(c).abs() * 0.05),
            lambda a, b, w: fh.fused_stage_score(a, b, w, 0.25),
            lambda a, b, w: fh.plain_stage_sums(a, b, w) / (h * w_) + 0.25)
        call = lambda: fh.fused_stage_score(fa, fb_, w, 0.25)  # noqa: E731
        ms = cuda_ms(torch, call, 20)
        dev_ms = launch_ms(torch, call, "fused_head", 1)
        plain = cuda_ms(torch, lambda: fh.plain_stage_sums(fa, fb_, w), 20)
        lib = cuda_ms(torch, lambda: ((fa - fb_) ** 2 * w).sum((1, 2, 3)), 20)
        elems = fa.numel()
        bms, by = bound(2 * elems * fa.element_size() + 4 * c + 4 * BATCH,
                        4 * elems, F32_FLOPS)
        emit("kernel", name="fused_stage_score", path="global",
             on_main_path=False, shape=list(shape), max_abs_err=errs,
             tolerance=head_tol, ms=ms, launch_ms=dev_ms and dev_ms[0],
             plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        add("fused_stage_score", "global", errs[str(torch.bfloat16)], 0, 0,
            0, 0, by, 0)

    # The whole head, as the scorer calls it: one launch a scored batch.
    errs, (ta, tb) = check_head(
        "fused_global_score", lambda dt: (taps(BATCH, dt), taps(BATCH, dt)),
        lambda a, b: fh.fused_global_score(a, b, packed, names),
        lambda a, b: fh.plain_global_score(a, b, packed, names))
    call = lambda: fh.fused_global_score(ta, tb, packed, names)  # noqa: E731
    ms = cuda_ms(torch, call, 20)
    dev_ms = launch_ms(torch, call, "fused_head", 1)
    plain = cuda_ms(torch, lambda: fh.plain_global_score(ta, tb, packed,
                                                         names), 5)
    # Yardstick: the module's eager head over the squared diffs.
    lib = cuda_ms(torch, lambda: head(squared_diffs(ta, tb, names)), 5)
    bms, by = head_bound(2 * BATCH, 1)
    emit("kernel", name="fused_stage_score", path="global", on_main_path=True,
         wrapper="fused_global_score", taps=[[BATCH, *s] for s in HEAD_TAPS],
         max_abs_err=errs, tolerance=head_tol, ms=ms,
         launch_ms=dev_ms and dev_ms[0], plain_ms=plain, library_ms=lib,
         bound_ms=bms, bound_by=by)
    add("fused_stage_score", "global", errs[str(torch.bfloat16)], ms, plain,
        lib, bms, by, 1)
    del ta, tb

    # The grouped (G, K) head: each GT tap read once against its K SR taps.
    errs, (tg, ts) = check_head(
        "fused_grouped_score",
        lambda dt: (taps(GROUP_G, dt), taps(GROUP_G * GROUP_K, dt)),
        lambda a, b: fh.fused_grouped_score(a, b, packed, names),
        lambda a, b: fh.plain_grouped_score(a, b, packed, names))
    call = lambda: fh.fused_grouped_score(tg, ts, packed, names)  # noqa: E731
    ms = cuda_ms(torch, call, 20)
    dev_ms = launch_ms(torch, call, "fused_head", 1)
    plain = cuda_ms(torch, lambda: fh.plain_grouped_score(tg, ts, packed,
                                                          names), 5)
    # Yardstick: the eager broadcast diffs through the module's head.
    lib = cuda_ms(torch, lambda: head(grouped_diff_pyramid(tg, ts, names)), 5)
    bms, by = head_bound(GROUP_G * (1 + GROUP_K), GROUP_K)
    emit("kernel", name="fused_stage_score", path="global",
         on_main_path=False, wrapper="fused_grouped_score", g=GROUP_G,
         k=GROUP_K, taps=[[GROUP_G, *s] for s in HEAD_TAPS],
         max_abs_err=errs, tolerance=head_tol, ms=ms,
         launch_ms=dev_ms and dev_ms[0], plain_ms=plain, library_ms=lib,
         bound_ms=bms, bound_by=by)
    add("fused_stage_score", "global", errs[str(torch.bfloat16)], 0, 0, 0, 0,
        by, 0)
    del tg, ts

    # The serve path's score batch (grouped, G = 8, K = 4) and the dual
    # path's batch (pairwise, 32 pairs on the CLIP tower's stage taps, the
    # same shapes): one head launch each.
    for path, wrapper, plain_fn, g, k in (
            ("serve", fh.fused_grouped_score, fh.plain_grouped_score,
             SERVE_G, SERVE_K),
            ("dual", fh.fused_global_score, fh.plain_global_score,
             DUAL_BATCH, 1)):
        errs, (tg, ts) = check_head(
            f"{wrapper.__name__} {path}",
            lambda dt: (taps(g, dt), taps(g * k, dt)),
            lambda a, b: wrapper(a, b, packed, names),
            lambda a, b: plain_fn(a, b, packed, names))
        call = lambda: wrapper(tg, ts, packed, names)  # noqa: E731
        ms = cuda_ms(torch, call, 20)
        dev_ms = launch_ms(torch, call, "fused_head", 1)
        plain = cuda_ms(torch, lambda: plain_fn(tg, ts, packed, names), 5)
        lib = cuda_ms(torch, lambda: head(
            squared_diffs(tg, ts, names) if k == 1
            else grouped_diff_pyramid(tg, ts, names)), 5)
        bms, by = head_bound(g * (1 + k), k)
        emit("kernel", name="fused_stage_score", path=path, on_main_path=True,
             wrapper=wrapper.__name__, g=g, k=k,
             taps=[[g, *sh] for sh in HEAD_TAPS], max_abs_err=errs,
             tolerance=head_tol, ms=ms, launch_ms=dev_ms and dev_ms[0],
             plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        add("fused_stage_score", path, errs[str(torch.bfloat16)], ms, plain,
            lib, bms, by, 1)
        del tg, ts

    # wperlay_cnn's head, one launch at 12 stages (depth 11) and at 4
    # (depth 3): pairwise at batch 64 and grouped at G = 16, K = 4.  The
    # depth-11 pairwise batch is the wperlay path's (one launch a batch).
    for depth, shapes in WPERLAY_TAPS.items():
        whead = conv_head(shapes)
        wpacked = fh.pack_head(whead)
        wnames, wtaps = tap_set(shapes)
        for form, g, k in (("pairwise", BATCH, 1),
                           ("grouped", GROUP_G, GROUP_K)):
            wrapper = (fh.fused_global_score if k == 1
                       else fh.fused_grouped_score)
            plain_fn = (fh.plain_global_score if k == 1
                        else fh.plain_grouped_score)
            errs, (tg, ts) = check_head(
                f"wperlay depth {depth} {form}",
                lambda dt: (wtaps(g, dt), wtaps(g * k, dt)),
                lambda a, b: wrapper(a, b, wpacked, wnames),
                lambda a, b: plain_fn(a, b, wpacked, wnames))
            on_path = depth == 11 and k == 1
            line = dict(name="fused_stage_score", path="wperlay",
                        on_main_path=on_path, wrapper=wrapper.__name__,
                        depth=depth, g=g, k=k,
                        taps=[[g, *sh] for sh in shapes], max_abs_err=errs,
                        tolerance=head_tol)
            if depth == 3 and k > 1:  # checked, not timed
                emit("kernel", **line)
                add("fused_stage_score", "wperlay",
                    errs[str(torch.bfloat16)], 0, 0, 0, 0, "bytes", 0)
                continue
            call = lambda: wrapper(tg, ts, wpacked, wnames)  # noqa: E731
            ms = cuda_ms(torch, call, 20)
            dev_ms = launch_ms(torch, call, "fused_head", 1)
            plain = cuda_ms(torch, lambda: plain_fn(tg, ts, wpacked, wnames), 3)
            # Yardstick: the module's eager head over the squared diffs.
            lib = cuda_ms(torch, lambda: whead(
                squared_diffs(tg, ts, wnames) if k == 1
                else grouped_diff_pyramid(tg, ts, wnames)), 3)
            bms, by = head_bound(g * (1 + k), k, shapes)
            emit("kernel", ms=ms, launch_ms=dev_ms and dev_ms[0],
                 plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                 **line)
            add("fused_stage_score", "wperlay", errs[str(torch.bfloat16)],
                *((ms, plain, lib, bms) if on_path else (0, 0, 0, 0)), by,
                int(on_path))
            del tg, ts

    # The ViT token heads (B7): (N, 197, 768) float32 taps, the vit path's
    # dtype, on the 1536-element fixed-channel path.  stages_vit pairwise
    # at batch 64 is the vit path's launch; wperlay_vit's and
    # single_lin_vit's 12 taps at depth 11 and the grouped form are checked
    # and timed beside it.
    from srsem_torch.models.global_models import (
        TokenHeadAggregator,
        grouped_token_head,
    )

    def token_head(n_layers, shared):
        head = TokenHeadAggregator(VIT_TOKENS[1], n_layers, shared=shared)
        head.reset_parameters(torch.Generator().manual_seed(n_layers))
        with torch.no_grad():
            for layer in dict.fromkeys(head.linears()):
                layer.weight.abs_().mul_(0.05)
                layer.bias.fill_(0.25)
        return head.to(dev).requires_grad_(False)

    def token_bound(images, k, n_layers, shared):
        """float32 token taps of ``images`` images read once, the packed
        head once, one score a pair written: bytes; 4 operations an
        element of each pair."""
        elems = n_layers * VIT_TOKENS[0] * VIT_TOKENS[1]
        pairs = images // (1 + k) * k
        weights = (1 if shared else n_layers) * (VIT_TOKENS[1] + 1)
        return bound(images * elems * 4 + 4 * weights + 4 * pairs,
                     4 * elems * pairs, F32_FLOPS)

    for label, n_layers, shared, g, k, on_path in (
            ("stages_vit", 4, False, BATCH, 1, True),
            ("wperlay_vit depth 11", 12, False, BATCH, 1, False),
            ("single_lin_vit depth 11", 12, True, BATCH, 1, False),
            ("stages_vit grouped", 4, False, GROUP_G, GROUP_K, False),
            # K = 8: the instance that streams the most SR images an item.
            ("stages_vit grouped K = 8", 4, False, 8, 8, False)):
        thead = token_head(n_layers, shared)
        tpacked = fh.pack_head(thead)
        tnames = [f"blocks.{j}.ls2" for j in range(n_layers)]

        def ttaps(n, dtype):
            return {nm: randn(n, *VIT_TOKENS).to(dtype) for nm in tnames}

        wrapper = fh.fused_global_score if k == 1 else fh.fused_grouped_score
        plain_fn = fh.plain_global_score if k == 1 else fh.plain_grouped_score
        errs, _ = check_head(
            f"token head {label}", lambda dt: (ttaps(g, dt), ttaps(g * k, dt)),
            lambda a, b: wrapper(a, b, tpacked, tnames),
            lambda a, b: plain_fn(a, b, tpacked, tnames))
        tg, ts = ttaps(g, torch.float32), ttaps(g * k, torch.float32)
        plan = fh.kernel_plan([(tg[n], ts[n]) for n in tnames],
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
        call = lambda: wrapper(tg, ts, tpacked, tnames)  # noqa: E731
        ms = cuda_ms(torch, call, 20)
        dev_ms = launch_ms(torch, call, "fused_head", 1)
        plain = cuda_ms(torch, lambda: plain_fn(tg, ts, tpacked, tnames), 3)
        # Yardstick: the module's eager head over the squared diffs.
        lib = cuda_ms(torch, lambda: thead(squared_diffs(tg, ts, tnames))
                      if k == 1 else grouped_token_head(thead, tg, ts, tnames),
                      3)
        bms, by = token_bound(g * (1 + k), k, n_layers, shared)
        line = dict(name="fused_stage_score", path="vit", on_main_path=on_path,
                    wrapper=wrapper.__name__, head=label, shared=shared, g=g,
                    k=k, taps=[[g, *VIT_TOKENS]] * n_layers, dtype="float32",
                    vec=list(plan.vec), step=list(plan.step),
                    max_abs_err=errs, tolerance=head_tol, ms=ms,
                    launch_ms=dev_ms and dev_ms[0], plain_ms=plain,
                    library_ms=lib, bound_ms=bms, bound_by=by)
        if on_path:
            # The W = 768 plan before this kernel's narrow step: one element
            # a thread, its channel by a modulo (the general path).
            fh._VEC_STEPS, steps = (fh._STEP,), fh._VEC_STEPS
            fh._plan.cache_clear()
            fh._descriptor.cache_clear()
            try:
                line["general_path_ms"] = cuda_ms(torch, call, 20)
            finally:
                fh._VEC_STEPS = steps
                fh._plan.cache_clear()
                fh._descriptor.cache_clear()
        emit("kernel", **line)
        add("fused_stage_score", "vit", errs[str(torch.bfloat16)],
            *((ms, plain, lib, bms) if on_path else (0, 0, 0, 0)), by,
            int(on_path))
        del tg, ts

    # -- bottleneck (CUDA C++) -------------------------------------------
    def weights(c, wd):
        mk = lambda *s, f: randn(*s) * f  # noqa: E731
        return (mk(c, wd, f=c ** -0.5), mk(wd, f=0.1),
                mk(3, 3, wd, wd, f=(9 * wd) ** -0.5), mk(wd, f=0.1),
                mk(wd, c, f=wd ** -0.5), mk(c, f=0.1))

    # A call makes three CUDA launches (conv1, conv2, conv3); ``plan`` in
    # its line (tiling, N tile, blocks and rows computed over useful, per
    # conv) comes from the kernel's plan.
    cases = [(name, path, shape)
             for name, table in (("fused_bottleneck", BOTTLENECK_SHAPES),
                                 ("fused_bottleneck_tiled", TILED_SHAPES))
             for path, shapes in table.items() for shape in shapes]
    for name, path, (shape, wd, count) in cases:
        wrapper = getattr(fb, name)
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
        plan = fb.kernel_plan(x, wd)
        line = dict(name=name, path=path, shape=list(shape), wd=wd,
                    cuda_launches=plan.launches,
                    plan=[{"conv": i + 1, "tiling": plan.tilings[i],
                           "nt": plan.nts[i], "blocks": plan.blocks[i],
                           "rows_executed_over_useful": plan.rows_ratio[i]}
                          for i in range(3)],
                    max_abs_err=errs,
                    tolerance="f32 (TF32 off) rtol=atol=1e-4; bf16 "
                    "rtol=atol=2e-2 (bf16 ulps where f32 sums round apart)")
        if count == 0:
            emit("kernel", on_main_path=False, **line)
            add(name, path, errs[str(torch.bfloat16)], 0, 0, 0, 0,
                "operations", 0)
            continue
        # Timed as the tower calls it: weights packed once (fold_tower),
        # in the path's dtype (bf16, the serving dtype, unless
        # TIMED_DTYPE says otherwise).
        x = randn(*shape).to(getattr(torch, TIMED_DTYPE.get(path,
                                                            "bfloat16")))
        packed = fb.pack_weights(ws, x.dtype)
        ms = cuda_ms(torch, lambda: wrapper(x, packed, **kw), 20)
        conv_ms = launch_ms(torch, lambda: wrapper(x, packed, **kw),
                            "fused_bottleneck_conv", plan.launches)
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

        lib = cuda_ms(torch, chain, 20)
        n, h, w_, c = shape
        esz = x.element_size()
        flops = 2 * n * h * w_ * (c * wd + 9 * wd * wd + wd * c)
        nbytes = (2 * x.numel() * esz + esz * (2 * c * wd + 9 * wd * wd)
                  + 4 * (2 * wd + c))
        bms, by = bound(nbytes, flops, BF16_TC_FLOPS if esz == 2
                        else F32_FLOPS)
        emit("kernel", on_main_path=True, ms=ms, conv_ms=conv_ms,
             plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
             tflops=flops / ms / 1e9, timed_dtype=str(x.dtype), **line)
        add(name, path, errs[str(torch.bfloat16)], ms, plain, lib, bms, by,
            count)
        if path == "train":  # the sweeps path's passes run these shapes
            add(name, "sweeps", errs[str(torch.bfloat16)], ms, plain, lib,
                bms, by, count * SWEEP_PASSES[shape[0]])

    # -- decoder level (CUDA C++) -----------------------------------------
    from srsem_torch.ops import fused_decoder as fd

    for name, shapes in DECODER_SHAPES.items():
        wrapper = getattr(fd, name)
        for n, h, w_, cd, cu, cm, co, fk, row_tile, count in shapes:
            kw = {"row_tile": row_tile} if row_tile else {}
            k2 = 9 if fk == 3 else 1
            mk = lambda *s, fan: randn(*s) * fan ** -0.5  # noqa: E731
            ws = (mk(3, 3, cd, cm, fan=9 * (cd + cu)),
                  mk(3, 3, cu, cm, fan=9 * (cd + cu)) if cu else None,
                  randn(cm) * 0.1,
                  mk(*((3, 3) if fk == 3 else ()), cm, co, fan=k2 * cm),
                  randn(co) * 0.1)
            errs = {}
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                # Squared diffs are nonnegative, as are upsampled ReLUs.
                d = randn(n, h, w_, cd).square().to(dtype)
                u = randn(n, h, w_, cu).abs().to(dtype) if cu else None
                got = wrapper(d, u, ws[0], ws[1], ws[2], ws[3], ws[4],
                              final_kernel=fk, **kw)
                want = fd.plain_decoder_level(d, u, *ws, fk, row_tile)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                errs[str(dtype)] = err
                if not bool((diff <= tol + tol * want.float().abs()).all()):
                    raise AssertionError(f"{name} {(n, h, w_, cd, cu)} "
                                         f"{dtype}: max |err| {err} beyond "
                                         f"rtol=atol={tol}")
            plan = fd.kernel_plan(fd.kernel_args(d, u, *ws, fk), fk)
            line = dict(name=name, shape=[n, h, w_, cd, cu, cm, co], final_kernel=fk,
                        patch=[plan.bh, plan.bw],
                        cuda_launches=plan.launches,
                        rows_executed_over_useful=plan.rows_ratio,
                        max_abs_err=errs,
                        tolerance="f32 (TF32 off) rtol=atol=1e-4; bf16 "
                        "rtol=atol=2e-2 (bf16 ulps where f32 sums round "
                        "h1 apart)")
            if count == 0:
                emit("kernel", on_main_path=False, **line)
                add(name, "clu", errs[str(torch.bfloat16)], 0, 0, 0, 0,
                    "operations", 0)
                continue
            # Timed with the weights in the serving dtype, as
            # fused_serving_decode passes them (fold_decoder casts them
            # once); the biases stay float32.
            wsv = [t.to(d.dtype) if t is not None and t.dim() > 1 else t
                   for t in ws]
            call = lambda: wrapper(d, u, *wsv, final_kernel=fk, **kw)  # noqa: E731
            ms = cuda_ms(torch, call, 5)
            plain = cuda_ms(torch, lambda: fd.plain_decoder_level(
                d, u, *ws, fk, row_tile), 2)
            # Yardstick: the cuDNN chain with the same folded weights,
            # channels_last bf16.
            cl = lambda t: t.permute(3, 2, 0, 1).to(d.dtype).contiguous(  # noqa: E731
                memory_format=torch.channels_last)
            dc, uc = d.permute(0, 3, 1, 2), u.permute(0, 3, 1, 2)
            k1d, k1u = cl(ws[0]), cl(ws[1])
            k2w = cl(ws[3] if fk == 3 else ws[3][None, None])
            c1, c2 = ws[2].to(d.dtype), ws[4].to(d.dtype)

            def chain():
                hh = F.relu(F.conv2d(dc, k1d, None, 1, 1)
                            + F.conv2d(uc, k1u, c1, 1, 1))
                return F.relu(F.conv2d(hh, k2w, c2, 1, fk // 2))

            lib = cuda_ms(torch, chain, 5)
            flops = 2 * n * h * w_ * (9 * (cd + cu) * cm + k2 * cm * co)
            nbytes = (2 * n * h * w_ * (cd + cu + co)
                      + 2 * (9 * (cd + cu) * cm + k2 * cm * co) + 4 * (cm + co))
            bms, by = bound(nbytes, flops, BF16_TC_FLOPS)
            emit("kernel", path="clu", on_main_path=True, ms=ms,
                 plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                 tflops=flops / ms / 1e9, **line)
            add(name, "clu", errs[str(torch.bfloat16)], ms, plain, lib, bms,
                by, count)

    # The dual path runs the CLU path's tower and decoder shapes; the serve
    # path runs them too (its SR passes and its maps batch), beside its own
    # batch-8 GT passes.
    for name in ("fused_bottleneck", "fused_bottleneck_tiled",
                 "fused_decoder_level", "fused_decoder_level_tiled"):
        clu = summary[(name, "clu")]
        summary[(name, "dual")] = clu
        own = summary.get((name, "serve"))
        summary[(name, "serve")] = clu if own is None else combine(own, clu)
    # The iqa path's folder-metrics run scores its 64 eval images in two
    # NR-IQA tower passes of 32 (the CLU path's two passes at batch 32),
    # its pyramid-LPIPS run two 2N = 64 passes (the global path's); the
    # text path's C2I folder two CLIP tower passes of 64 (the global
    # path's).
    for name in BOTTLENECK:
        summary[(name, "iqa")] = combine(summary[(name, "clu")],
                                         summary[(name, "global")])
        summary[(name, "text")] = summary[(name, "global")]
    return summary


def combine(*parts: dict) -> dict:
    """check_kernels summaries of launch sets run one after the other: the
    launches and times added, the worst error."""
    by: dict = {}
    for part in parts:
        for b, v in part["by"].items():
            by[b] = by.get(b, 0.0) + v
    return {**{key: sum(p[key] for p in parts) for key in (
        "launches", "ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err": max(p["max_abs_err"] for p in parts), "by": by}


def randomize_bn(torch, np, model, rng) -> None:
    """Random frozen-BN statistics in every BN of ``model``: small gammas
    on the BNs closing each residual branch keep activations O(1) through
    16 blocks."""
    from torch import nn

    from srsem_torch.backbones.resnet import FrozenBatchNorm

    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (FrozenBatchNorm, nn.BatchNorm2d)):
                c = m.weight.shape[0]
                closing = (name.endswith(("bn3", "downsample.1"))
                           and "layer" in name)
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if closing
                                   else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))


def seeded_model(torch, np, cfg, seed: int = 0):
    """Full-width GlobalPairScorer with seeded random weights: Kaiming
    convs, random frozen-BN statistics, nonnegative head weights, biases
    +1."""
    from srsem_torch.models.global_models import make_global_model

    model = make_global_model(cfg, torch.Generator().manual_seed(seed))
    randomize_bn(torch, np, model.backbone, np.random.default_rng(seed))
    with torch.no_grad():
        # Nonnegative head weights scaled so the squared-diff term, not the
        # +1 bias, carries each score; biases +1 keep the ReLU open.
        for layer in model.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
    return model


def seeded_clu(torch, np, cfg, seed: int = 0):
    """Full-width CluUnet with seeded random weights: Kaiming tower convs
    and He decoder convs, random BN statistics in the tower and the
    decoder, and a map head scaled to keep the sigmoid off saturation, with
    a +0.5 bias that keeps its ReLU open."""
    from srsem_torch.models.local_models import make_local_model

    model = make_local_model(cfg, generator=torch.Generator().manual_seed(seed))
    randomize_bn(torch, np, model, np.random.default_rng(seed))
    with torch.no_grad():
        model.decoder[0][3].weight.mul_(0.1)
        model.decoder[0][3].bias.add_(0.5)
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
    if "fused_decoder" in name:
        return "decoder kernel"
    if "fused_head" in name:
        return "head kernel"
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "adam" in low or "multi_tensor_apply" in low:
        return "optimizer (Adam)"
    if any(k in low for k in ("dgrad", "wgrad", "bprop", "backward")):
        return "cudnn conv backward and other backward"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit",
                              "gemm", "cutlass", "sm90")):
        return "cudnn conv"
    return "other (elementwise, pooling, casts)"


def profile_scoring(torch, scorer, a, b, reps: int = 3,
                    host_top: int = 0) -> dict:
    """torch.profiler over ``reps`` scored batches: the device's busy and
    idle share of the host wall time, and device ms a batch by group and
    by kernel; with ``host_top``, the host operations that took the most
    self CPU time, ms a batch.  Busy time is the union of the device
    events' intervals."""
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
    host = {}
    if host_top:
        avgs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        host = {"host_self_cpu_ms_per_batch": {
            e.key[:90]: e.self_cpu_time_total / reps / 1e3
            for e in avgs[:host_top]}}
    return {**host, "batches": reps, "wall_ms_per_batch": wall_us / reps / 1e3,
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
    # The head's kernel replaces the TPU's fused_stage_score; the scorer
    # launches it once a batch through fused_global_score.
    wrappers = {"fused_stage_score": fh.fused_global_score,
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
        run_grouped(torch, np, card, Path(tmp), pairs, (cfg, model),
                    (cfg32, model32))
    return launches


def run_grouped(torch, np, card: str, tmp: Path, pairs, bf16, f32) -> None:
    """The global phase's grouped step: GroupedPairScorer at G = 16, K = 4
    (one head launch a batch; pairs/s), its float32 (G, K) scores against
    PairScorer's on the repeated pairs, and ``score-groups`` over small
    folders with one corrupt SR file."""
    import shutil

    from srsem_torch.eval.grouped import GroupedPairScorer
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.ops import fused_head as fh

    rng = np.random.default_rng(4)
    gt = rng.integers(0, 256, (GROUP_G, 224, 224, 3), dtype=np.uint8)
    noise = rng.integers(-20, 21, (GROUP_G, GROUP_K, 224, 224, 3))
    sr = np.clip(gt[:, None].astype(int) + noise, 0, 255).astype(np.uint8)
    scorer = GroupedPairScorer(*bf16, k=GROUP_K, batch_size=GROUP_G)
    fh.fused_grouped_score.launches = 0
    for _ in range(2):
        scorer.score_arrays(gt, sr)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = scorer.score_arrays(gt, sr)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = fh.fused_grouped_score.launches
    if launches != 2 + reps:
        raise AssertionError(f"grouped scorer: {launches} head launches in "
                             f"{2 + reps} batches")
    if out.shape != (GROUP_G, GROUP_K) or not torch.isfinite(out).all():
        raise AssertionError(f"grouped scores {tuple(out.shape)} not finite")
    emit("slice", step="grouped_throughput", g=GROUP_G, k=GROUP_K,
         dtype="bfloat16", image=224, ms_per_batch=dt * 1e3,
         pairs_per_s=GROUP_G * GROUP_K / dt,
         head_launches_per_batch=launches / (2 + reps), card=card)

    got = GroupedPairScorer(*f32, k=GROUP_K,
                            batch_size=GROUP_G).score_arrays(gt, sr)
    want = PairScorer(*f32, batch_size=GROUP_G * GROUP_K).score_arrays(
        np.repeat(gt, GROUP_K, axis=0), sr.reshape(-1, 224, 224, 3))
    err = float((got.reshape(-1) - want).abs().max())
    if not torch.allclose(got.reshape(-1), want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"f32 grouped vs pairwise: max |err| {err} "
                             "beyond rtol=atol=1e-4")
    emit("slice", step="f32_grouped_vs_pairwise", max_abs_err=err,
         tolerance="rtol=atol=1e-4", scores=got.tolist())

    # The CLI entry point, as a user runs it: K = 2 SR folders, one
    # corrupt SR file.
    root = tmp / "groups"
    dirs = [root / n for n in ("gt", "esrgan", "swinir")]
    for d in dirs:
        d.mkdir(parents=True)
    for i, (pa, pb) in enumerate(pairs[:3]):
        shutil.copy(pa, dirs[0] / f"im{i}.png")
        shutil.copy(pb, dirs[1] / f"im{i}.jpg")
        shutil.copy(pb, dirs[2] / f"im{i}.jpg")
    shutil.copy(pairs[-1][1], dirs[2] / "im1.jpg")
    out_csv = root / "scores.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "score-groups",
         *map(str, dirs), "--batch-size", "8", "--out", str(out_csv)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"score-groups exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = out_csv.read_text().splitlines()
    if result["nan_groups"] != 1 or len(rows) != 4 or ",nan" not in rows[2]:
        raise AssertionError(f"score-groups result {result}, {rows}")
    emit("slice", step="cli_score_groups", result=result)


def run_clu_slice(torch, np, card: str):
    """Phase 5; returns {kernel name: launches in the main-path run}."""
    import dataclasses
    import shutil

    from srsem_torch.config import BackboneConfig, LocalModelConfig
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_decoder as fd

    cfg = LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=224, compute_dtype="bfloat16"),
        decoder_dtype="bfloat16", v2=False)
    model = seeded_clu(torch, np, cfg)
    scorer = PairScorer(cfg, model, batch_size=CLU_BATCH, model_kind="local")
    wrappers = {"fused_bottleneck": fb.fused_bottleneck,
                "fused_bottleneck_tiled": fb.fused_bottleneck_tiled,
                "fused_decoder_level": fd.fused_decoder_level,
                "fused_decoder_level_tiled": fd.fused_decoder_level_tiled}
    with tempfile.TemporaryDirectory() as tmp:
        pairs = write_pairs(np, Path(tmp), 8)
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        maps = scorer.score_paths(pairs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        bad = np.isnan(maps).all(axis=(1, 2))
        ok = maps[:-1]
        if not (maps.shape == (len(pairs), 224, 224) and bad[-1]
                and not np.isnan(ok).any() and np.isfinite(ok).all()
                and (ok >= 0.5).all() and (ok <= 1).all()):
            raise AssertionError(f"score_paths maps: want NaN on exactly the "
                                 f"corrupt last row and [0.5, 1] elsewhere; "
                                 f"NaN rows {bad.tolist()}, range "
                                 f"{np.nanmin(maps)}..{np.nanmax(maps)}")
        emit("clu", step="score_paths", pairs=len(pairs), seconds=seconds,
             launches=launches, map_mean=[float(m.mean()) for m in ok],
             map_min=float(ok.min()), map_max=float(ok.max()))
        if not all(v > 0 for v in launches.values()):
            raise AssertionError(f"CLU path launched a kernel no time: "
                                 f"{launches}")

        # float32 kernel path (tower and decoder kernels) vs the plain
        # module path, TF32 off.
        decode = scorer.preprocess.decode_uint8
        a = np.stack([decode(p[0]) for p in pairs[:-1]])
        b = np.stack([decode(p[1]) for p in pairs[:-1]])
        cfg32 = dataclasses.replace(cfg, decoder_dtype="float32",
                                    backbone=dataclasses.replace(
                                        cfg.backbone, compute_dtype="float32"))
        model32 = seeded_clu(torch, np, cfg32)
        got = PairScorer(cfg32, model32, batch_size=CLU_BATCH,
                         model_kind="local").score_arrays(a, b)
        want = PairScorer(cfg32, model32, batch_size=CLU_BATCH,
                          model_kind="local", fused_tower=False,
                          fused_decoder=False).score_arrays(a, b)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=2e-3, atol=2e-3):
            raise AssertionError(f"CLU f32 kernel path vs plain module: max "
                                 f"|err| {err} beyond 2e-3")
        emit("clu", step="f32_kernel_path_vs_plain_module", max_abs_err=err,
             tolerance="rtol=atol=2e-3 (tests/test_fused_decoder.py:111)",
             map_std=float(want.std()))
        del model32, got, want

        # Throughput of score_arrays at batch 32, bf16.
        rng = np.random.default_rng(3)
        a32 = rng.integers(0, 256, (CLU_BATCH, 224, 224, 3), dtype=np.uint8)
        b32 = np.clip(a32.astype(int) + rng.integers(-20, 21, a32.shape),
                      0, 255).astype(np.uint8)
        for _ in range(2):
            scorer.score_arrays(a32, b32)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = scorer.score_arrays(a32, b32)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        if not torch.isfinite(out).all():
            raise AssertionError("CLU maps at batch 32 not finite")
        emit("clu", step="score_arrays_throughput", batch=CLU_BATCH,
             dtype="bfloat16", image=224, ms_per_batch=dt * 1e3,
             maps_per_s=CLU_BATCH / dt, card=card)
        emit("clu", step="profile", card=card,
             **profile_scoring(torch, scorer, a32, b32))

        # The CLI entry point, as a user runs it: K = 2 SR folders, one
        # corrupt SR file.
        root = Path(tmp) / "groups"
        dirs = [root / n for n in ("gt", "esrgan", "swinir")]
        for d in dirs:
            d.mkdir(parents=True)
        for i, (pa, pb) in enumerate(pairs[:3]):
            shutil.copy(pa, dirs[0] / f"im{i}.png")
            shutil.copy(pb, dirs[1] / f"im{i}.jpg")
            shutil.copy(pb, dirs[2] / f"im{i}.jpg")
        shutil.copy(pairs[-1][1], dirs[2] / "im1.jpg")
        out_csv = root / "maps.csv"
        proc = subprocess.run(
            [sys.executable, "-m", "srsem_torch", "score-maps-groups",
             *map(str, dirs), "--batch-size", "8", "--out", str(out_csv),
             "--set", "decoder_dtype=bfloat16"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"score-maps-groups exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        rows = out_csv.read_text().splitlines()
        if result["nan_groups"] != 1 or len(rows) != 4 or ",nan" not in rows[2]:
            raise AssertionError(f"score-maps-groups result {result}, {rows}")
        emit("clu", step="cli", result=result)
    return launches

def leaves(tree, prefix=()):
    """``{path: leaf}`` of a nested tree, tuples keyed by position as the
    checkpoint writer keys them; empty containers hold no leaf."""
    if isinstance(tree, (tuple, list)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(leaves(v, prefix + (k,)))
    return out


def round_trip(torch, np, directory: Path, params, stats) -> dict:
    """A trainable subset written with the port's writer (a chunked array,
    a bf16 leaf and an Adam-shaped opt_state beside it, the chunk size set
    low) and read back with its reader: every leaf bit-equal.  Returns the
    restored tree."""
    from srsem_torch.train import checkpoint as ck

    rng = np.random.default_rng(11)
    zeros = {k: np.zeros_like(v) for k, v in leaves(params).items()}
    tree = {"trainable": params, "batch_stats": stats,
            "opt_state": ({"count": np.zeros((), np.int32),
                           "mu": list(zeros.values()),
                           "nu": list(zeros.values())}, {}),
            "extra": {"bf16": torch.tensor(rng.standard_normal((3, 5)))
                      .to(torch.bfloat16),
                      "chunked": rng.standard_normal(5000).astype(np.float32),
                      "step": 11}}
    chunk = ck.MAX_CHUNK_SIZE
    ck.MAX_CHUNK_SIZE = 4096  # the 20 KB array goes as five chunks
    try:
        path = ck.save_checkpoint(str(directory), 11, tree)
    finally:
        ck.MAX_CHUNK_SIZE = chunk
    if b"__msgpack_chunked_array__" not in Path(path).read_bytes():
        raise AssertionError("no chunked array in the checkpoint")
    back = ck.restore_checkpoint(str(directory))
    want, got = leaves(tree), leaves(back)
    if sorted(want) != sorted(got):
        raise AssertionError(f"checkpoint paths differ: {sorted(want)[:4]} vs "
                             f"{sorted(got)[:4]}")
    for key, w in want.items():
        g = got[key]
        if isinstance(w, torch.Tensor):
            same = isinstance(g, torch.Tensor) and g.dtype == w.dtype \
                and torch.equal(g, w)
        elif isinstance(w, np.ndarray):
            same = (isinstance(g, np.ndarray) and g.dtype == w.dtype
                    and g.shape == w.shape and g.tobytes() == w.tobytes())
        else:
            same = g == w and type(g) is type(w)
        if not same:
            raise AssertionError(f"checkpoint leaf {key} changed")
    return back


def live_global(torch, np, cfg, seed: int):
    """A full-width global model with seeded weights and random frozen-BN
    statistics; a CluUnet's map head as ``seeded_clu``'s (an MLP head is
    made live on a batch by ``calibrate_mlp``)."""
    from srsem_torch.models.global_models import make_global_model

    model = make_global_model(cfg, torch.Generator().manual_seed(seed))
    randomize_bn(torch, np, model, np.random.default_rng(seed))
    with torch.no_grad():
        if cfg.head == "unet_global":
            model.decoder[0][3].weight.mul_(0.1)
            model.decoder[0][3].bias.add_(0.5)
    return model


def calibrate_mlp(torch, model, scorer, a, b) -> None:
    """An MLP head's last layer rescaled so its scores on the batch (a, b)
    are 1 +- 0.1 (mean, deviation): the pairs' spread, not an offset of
    hundreds, sets the scores, so the float32 check's 1e-3 is tight."""
    last, seen = model.aggregator.fin_lin[-2], []
    hook = last.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    try:
        scorer.score_arrays(a, b)
    finally:
        hook.remove()
    with torch.no_grad():
        z = seen[0].float() @ last.weight[0].float()
        scale = 0.1 / float(z.std())
        last.weight.mul_(scale)
        last.bias.fill_(1.0 - float(z.mean()) * scale)


def calibrate_wperlay(torch, model, scorer, a, b) -> None:
    """Nonnegative conv-head weights scaled so each tap's weighted squared
    diff is about 1 on the batch (a, b), biases +1: the pairs, not the
    biases, carry the scores."""
    with torch.inference_mode():
        _, ta = scorer.tower(scorer.normalize(a))
        _, tb = scorer.tower(scorer.normalize(b))
    with torch.no_grad():
        for name, layer in zip(model.tap_names, model.aggregator.w_layers):
            d = ((ta[name].float() - tb[name].float()) ** 2).mean(dim=(0, 1, 2))
            w = layer.weight.abs_().reshape(-1)
            layer.weight.div_(float(d.cpu() @ w.cpu()))
            layer.bias.fill_(1.0)


def wperlay_model(torch, np, cfg, ckpt: Path):
    """The wperlay_cnn model the heads phase scores with: a seeded
    full-width CLIP tower with random frozen BN and the trained head from
    ``ckpt``, merged over a fresh head as ``--checkpoint`` does."""
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.train.checkpoint import restore_checkpoint
    from srsem_torch.utils.convert import load_jax_global_params

    model = make_global_model(cfg, torch.Generator().manual_seed(6))
    randomize_bn(torch, np, model.backbone, np.random.default_rng(6))
    restored = restore_checkpoint(str(ckpt))
    return load_jax_global_params(model, {"params": restored["trainable"]},
                                  partial=True)


def run_heads(torch, np, card: str):
    """Phase 6 (heads): trained checkpoints through the port's writer and
    reader; wperlay_cnn at depth 11 on the CLIP tower with a trained head
    (the wperlay path: score_paths with the launch counts reset just before
    and read just after, pairs/s and head launches a batch for PairScorer
    at batch 64, with a profile, and GroupedPairScorer at G = 16, K = 4,
    float32 grouped against pairwise and kernel path against plain
    module); the other heads against their plain modules; ``score
    --checkpoint --set head=wperlay_cnn`` as a subprocess.  Returns
    {kernel: launches in the wperlay run}."""
    import dataclasses

    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.eval.grouped import GroupedPairScorer
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_head as fh
    from srsem_torch.train.checkpoint import restore_checkpoint
    from srsem_torch.utils.convert import (
        jax_trainable_params,
        load_jax_global_params,
        load_jax_local_params,
    )

    def f32(c):
        return dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, compute_dtype="float32"))

    clip = BackboneConfig(kind="resnet50_clip", image_size=224,
                          compute_dtype="bfloat16")
    cfg = GlobalModelConfig(backbone=clip, head="wperlay_cnn", depth=11)
    rng = np.random.default_rng(5)
    # Blocky images under noise: noise alone gives nearly equal CLIP
    # embeddings, and then the MLP heads' scores barely differ.
    blocks = rng.integers(0, 256, (BATCH, 4, 4, 3))
    a64 = np.clip(np.kron(blocks, np.ones((1, 56, 56, 1))) + rng.integers(
        -30, 31, (BATCH, 224, 224, 3)), 0, 255).astype(np.uint8)
    b64 = np.clip(a64.astype(int) + rng.integers(-20, 21, a64.shape), 0,
                  255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The trained head: calibrated on the scoring tower, written with
        # the port's writer, read back bit-equal, and merged over a fresh
        # head as --checkpoint does.
        model = make_global_model(cfg, torch.Generator().manual_seed(6))
        randomize_bn(torch, np, model.backbone, np.random.default_rng(6))
        calibrate_wperlay(torch, model, PairScorer(cfg, model, batch_size=8),
                          a64[:8], b64[:8])
        params, stats = jax_trainable_params(model.cpu())
        round_trip(torch, np, tmp / "wperlay", params, stats)
        model.aggregator.reset_parameters(torch.Generator().manual_seed(9))
        load_jax_global_params(model, {"params": restore_checkpoint(
            str(tmp / "wperlay"))["trainable"]}, partial=True)
        for j, layer in enumerate(model.aggregator.w_layers):
            want = params["aggregator"][f"w_layers.{j}"]["kernel"][:, 0]
            if not np.array_equal(layer.weight.reshape(-1).cpu().numpy(), want):
                raise AssertionError(f"merged head w_layers.{j} differs")
        emit("heads", step="checkpoint_round_trip", model="wperlay_cnn",
             leaves=len(leaves(params)), bit_equal=True)

        scorer = PairScorer(cfg, model, batch_size=BATCH)
        wrappers = {"fused_stage_score": fh.fused_global_score,
                    "fused_bottleneck": fb.fused_bottleneck,
                    "fused_bottleneck_tiled": fb.fused_bottleneck_tiled}
        pairs = write_pairs(np, tmp, 8)
        for fn in wrappers.values():
            fn.launches = 0
        scores = scorer.score_paths(pairs)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        nan = np.isnan(scores)
        if not (nan[-1] and not nan[:-1].any() and (scores[:-1] > 0).all()):
            raise AssertionError(f"wperlay score_paths: want NaN on exactly "
                                 f"the corrupt last row, got {scores.tolist()}")
        emit("heads", step="wperlay_score_paths", depth=11, taps=12,
             pairs=len(pairs), scores=[float(x) for x in scores],
             launches=launches)

        def throughput(call, n_pairs, wrapper):
            wrapper.launches = 0
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                out = call()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
            if not torch.isfinite(out).all():
                raise AssertionError("wperlay scores not finite")
            per_batch = wrapper.launches / (2 + reps)
            if per_batch != 1:
                raise AssertionError(f"{per_batch} head launches a batch")
            return dict(ms_per_batch=dt * 1e3, pairs_per_s=n_pairs / dt,
                        head_launches_per_batch=per_batch)

        emit("heads", step="wperlay_throughput", depth=11, batch=BATCH,
             dtype="bfloat16", image=224, card=card,
             **throughput(lambda: scorer.score_arrays(a64, b64), BATCH,
                          fh.fused_global_score))
        emit("heads", step="wperlay_profile", card=card,
             **profile_scoring(torch, scorer, a64, b64))
        gt = a64[:GROUP_G]
        sr = np.clip(gt[:, None].astype(int) + rng.integers(
            -20, 21, (GROUP_G, GROUP_K, 224, 224, 3)), 0, 255).astype(np.uint8)
        grouped = GroupedPairScorer(cfg, model, k=GROUP_K, batch_size=GROUP_G)
        emit("heads", step="wperlay_grouped_throughput", depth=11, g=GROUP_G,
             k=GROUP_K, dtype="bfloat16", image=224, card=card,
             **throughput(lambda: grouped.score_arrays(gt, sr),
                          GROUP_G * GROUP_K, fh.fused_grouped_score))
        del scorer, grouped, model

        # The CLI entry point, as a user runs it, beside the untimed float32
        # checks below (the subprocess would disturb the timed steps).
        csv_path = tmp / "pairs.csv"
        csv_path.write_text("img_a_pth,img_b_pth\n"
                            + "".join(f"{x},{y}\n" for x, y in pairs))
        out_csv = tmp / "scores.csv"
        cli = subprocess.Popen(
            [sys.executable, "-m", "srsem_torch", "score", str(csv_path),
             "--backbone", "resnet50_clip", "--checkpoint",
             str(tmp / "wperlay"), "--set", "head=wperlay_cnn", "--set",
             "depth=11", "--batch-size", "16", "--out", str(out_csv)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            # float32 (TF32 off): grouped vs pairwise on the repeated pairs,
            # and the kernel path vs the plain module.
            cfg32 = f32(cfg)
            model32 = wperlay_model(torch, np, cfg32, tmp / "wperlay")
            got = GroupedPairScorer(cfg32, model32, k=GROUP_K,
                                    batch_size=GROUP_G).score_arrays(gt, sr)
            pair32 = PairScorer(cfg32, model32, batch_size=GROUP_G * GROUP_K)
            want = pair32.score_arrays(np.repeat(gt, GROUP_K, axis=0),
                                       sr.reshape(-1, 224, 224, 3))
            err = float((got.reshape(-1) - want).abs().max())
            if not torch.allclose(got.reshape(-1), want, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"wperlay f32 grouped vs pairwise: max |err| "
                                     f"{err} beyond rtol=atol=1e-4")
            emit("heads", step="wperlay_f32_grouped_vs_pairwise", max_abs_err=err,
                 tolerance="rtol=atol=1e-4", score_range=[float(want.min()),
                                                          float(want.max())])
            checks = [("wperlay_cnn", cfg32, model32, pair32, BATCH)]

            # The other heads on the CLIP tower, float32 kernel path against
            # the plain module, and bf16 finite.
            for head, n in (("stages_cnn_pooling", BATCH), ("emb_lin", BATCH),
                            ("unet_global", CLU_BATCH)):
                c = dataclasses.replace(cfg, head=head, depth=3)
                m32 = live_global(torch, np, f32(c), seed=7)
                sc = PairScorer(f32(c), m32, batch_size=n)
                if head != "unet_global":
                    calibrate_mlp(torch, m32, sc, a64[:n], b64[:n])
                checks.append((head, f32(c), m32, sc, n))
            for head, c32, m32, sc, n in checks:
                a, b = a64[:n], b64[:n]
                got = sc.score_arrays(a, b)
                pre = sc.preprocess
                with torch.inference_mode():
                    want = m32(pre.device_normalize(torch.tensor(a).cuda()),
                               pre.device_normalize(torch.tensor(b).cuda()))
                tol = 2e-3 if head == "unet_global" else 1e-3
                err = float((got - want).abs().max())
                if not (torch.allclose(got, want, rtol=tol, atol=tol)
                        and bool((want > 0).any())):
                    raise AssertionError(f"{head} f32 kernel path vs plain module:"
                                         f" max |err| {err} beyond {tol}")
                # bf16: the wperlay scores' finiteness is the throughput step's.
                finite = head == "wperlay_cnn" or bool(torch.isfinite(PairScorer(
                    dataclasses.replace(c32, backbone=clip),
                    live_global(torch, np, dataclasses.replace(c32, backbone=clip),
                                7), batch_size=n).score_arrays(a, b)).all())
                if not finite:
                    raise AssertionError(f"{head} bf16 results not finite")
                emit("heads", step="f32_kernel_path_vs_plain_module", head=head,
                     batch=n, shape=list(got.shape), max_abs_err=err,
                     tolerance=f"rtol=atol={tol}", bf16_finite=finite,
                     value_range=[float(want.min()), float(want.max())])
                if head == "unet_global":
                    # A CluUnet's trained decoder and batch_stats round trip.
                    params, stats = jax_trainable_params(m32.cpu())
                    back = round_trip(torch, np, tmp / "unet", params, stats)
                    fresh = make_global_model(c32, torch.Generator().manual_seed(8))
                    load_jax_local_params(fresh, {
                        "params": back["trainable"],
                        "batch_stats": back["batch_stats"]}, partial=True)
                    for key, v in m32.decoder.state_dict().items():
                        if not torch.equal(fresh.decoder.state_dict()[key].cpu(),
                                           v.cpu()):
                            raise AssertionError(f"unet_global decoder {key} "
                                                 "changed")
                    emit("heads", step="checkpoint_round_trip",
                         model="unet_global", leaves=len(leaves(params)),
                         bit_equal=True)
                del sc, m32
            del checks
            stdout, stderr = cli.communicate(timeout=300)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
        if cli.returncode != 0:
            raise AssertionError(f"score --checkpoint exit {cli.returncode}: "
                                 f"{stderr[-2000:]}")
        result = json.loads(stdout.strip().splitlines()[-1])
        rows = out_csv.read_text().splitlines()
        if result["nan"] != 1 or len(rows) != len(pairs) + 1:
            raise AssertionError(f"score --checkpoint result {result}, "
                                 f"{len(rows)} rows")
        emit("heads", step="cli_score_checkpoint_wperlay", result=result)
    return launches


# An HTTP load generator run in a process of its own (``python -c``): its
# one argument is a JSON object (url, requests, k, clients, per_client);
# each client thread posts its requests one after another.  Prints the
# wall seconds, every request's latency and the first wrong responses.
HTTP_CLIENTS = r"""
import json, sys, threading, time, urllib.request
cfg = json.loads(sys.argv[1])
reqs, lat, bad = cfg["requests"], [], []


def post(obj):
    req = urllib.request.Request(cfg["url"], data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def client(c):
    for j in range(cfg["per_client"]):
        t0 = time.perf_counter()
        try:
            resp = post(dict(reqs[(c + j) % len(reqs)], id=c * 1000 + j))
        except OSError as e:  # a refused or reset connection
            resp = {"error": repr(e)}
        lat.append(time.perf_counter() - t0)
        if len(resp.get("scores") or []) != cfg["k"]:
            bad.append(resp)


threads = [threading.Thread(target=client, args=(c,))
           for c in range(cfg["clients"])]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"seconds": time.perf_counter() - t0, "latencies": lat,
                  "errors": bad[:3]}))
"""


def serving_images(np, root: Path, n_gt: int, k: int):
    """``n_gt`` GT images (PNG, four sizes as ``write_pairs``) with ``k``
    noisy SR JPEGs each, and a corrupt file; returns (gts, srs, bad)."""
    from PIL import Image

    rng = np.random.default_rng(8)
    gts, srs = [], []
    for i in range(n_gt):
        size = [(256, 320), (300, 240), (224, 224), (480, 512)][i % 4]
        a = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        gts.append(str(root / f"gt{i}.png"))
        Image.fromarray(a).save(gts[-1])
        group = []
        for m in range(k):
            b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                        255).astype(np.uint8)
            group.append(str(root / f"sr{i}_{m}.jpg"))
            Image.fromarray(b).save(group[-1], quality=90)
        srs.append(group)
    bad = root / "corrupt.jpg"
    bad.write_bytes(b"\xff\xd8 truncated, not a JPEG")
    return gts, srs, str(bad)


def percentiles(np, seconds) -> dict:
    ms = np.asarray(seconds) * 1e3
    return {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "mean_ms": float(ms.mean())}


def stdio_script(gts, srs, bad, maps_dir) -> list:
    """The serve subprocess's requests: ping, K = 4, scalar sr, a corrupt
    GT, a malformed line, a maps request with maps_dir, stats, shutdown."""
    return [json.dumps({"cmd": "ping"}),
            json.dumps({"id": 1, "gt": gts[0], "sr": srs[0]}),
            json.dumps({"id": 2, "gt": gts[1], "sr": srs[1][0]}),
            json.dumps({"id": 3, "gt": bad, "sr": srs[2]}),
            "{this is not json",
            json.dumps({"id": 4, "gt": gts[3], "sr": srs[3], "maps": True,
                        "maps_dir": str(maps_dir)}),
            json.dumps({"cmd": "stats"}),
            json.dumps({"cmd": "shutdown"})]


def check_stdio(resps, maps_dir: Path) -> dict:
    """Every response of ``stdio_script``, in order; returns the stats."""
    import math
    import os

    def num(v):
        return isinstance(v, float) and math.isfinite(v)

    want_n = 8
    if len(resps) != want_n:
        raise AssertionError(f"serve stdio: {len(resps)} responses, want "
                             f"{want_n}: {resps}")
    ping, r1, r2, r3, bad_json, r4, stats, bye = resps
    checks = {
        "ping": ping == {"ok": True},
        "k4": r1.get("id") == 1 and len(r1.get("scores", [])) == SERVE_K
        and all(num(v) for v in r1["scores"]),
        "scalar": r2.get("id") == 2 and num(r2.get("score"))
        and r2["scores"] == [r2["score"]],
        "corrupt_gt_null": r3 == {"id": 3, "scores": [None] * SERVE_K},
        "malformed": "bad JSON" in bad_json.get("error", ""),
        "maps": r4.get("id") == 4
        and all(num(v) and 0.0 <= v <= 1.0 for v in r4.get("map_means", []))
        and len(r4.get("maps", [])) == SERVE_K
        and all(p and os.path.exists(p) and str(maps_dir) in p
                for p in r4["maps"]),
        # The stats line may be read before the lines queued beside it are
        # scored: no count is fixed but the errors.
        "stats": stats.get("errors") == 0
        and stats.get("warmed_k") == [1, SERVE_K],
        "shutdown": bye == {"ok": True, "shutdown": True},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve stdio responses wrong at {failed}: "
                             f"{resps}")
    return stats


def run_serve(torch, np, card: str):
    """Phase 7 (serve): the service over the flagship global model and the
    CLU model (``--with-maps``), group_batch 8, warmed at K = 1 and 4.
    Returns {kernel: launches in one score batch and one maps batch}."""
    import dataclasses
    import threading
    import urllib.request

    from srsem_torch.cli.serve import ScoreService, serve_http
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.eval.grouped import GroupedMapScorer, GroupedPairScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_decoder as fd
    from srsem_torch.ops import fused_head as fh

    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50", image_size=IMAGE, compute_dtype="bfloat16"),
        head="stages_cnn", depth=3)
    map_cfg = LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=IMAGE, compute_dtype="bfloat16"),
        decoder_dtype="bfloat16", v2=False)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    service = ScoreService(cfg, seeded_model(torch, np, cfg),
                           group_batch=SERVE_G, map_cfg=map_cfg,
                           map_model=seeded_clu(torch, np, map_cfg))
    t0 = time.perf_counter()
    service.warmup([1, SERVE_K])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    emit("serve", step="warmup", ladder=service._ladder(),
         warmed_k=[1, SERVE_K], seconds=warm_s,
         buckets=len(service._scorers) + len(service._map_scorers),
         shared_cores=len({id(s.pairs) for s in service._scorers.values()})
         + len({id(s.pairs) for s in service._map_scorers.values()}),
         memory_before_bytes=base, max_memory_allocated_bytes=peak,
         max_memory_allocated_gib=peak / 2 ** 30, card=card)
    wrappers = {"fused_stage_score": fh.fused_grouped_score,
                "fused_bottleneck": fb.fused_bottleneck,
                "fused_bottleneck_tiled": fb.fused_bottleneck_tiled,
                "fused_decoder_level": fd.fused_decoder_level,
                "fused_decoder_level_tiled": fd.fused_decoder_level_tiled}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gts, srs, bad = serving_images(np, tmp, SERVE_G, SERVE_K)
        reqs = [{"id": i, "gt": g, "sr": s}
                for i, (g, s) in enumerate(zip(gts, srs))]
        reqs[5] = dict(reqs[5], sr=[*srs[5][:3], bad])  # one null pair

        # The path: one score batch and one maps batch of G = 8, K = 4.
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        scores = service.score_requests(reqs)
        maps = service.map_requests([dict(r, maps=True) for r in reqs])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        want = {"fused_stage_score": 1,
                "fused_bottleneck": 4 * PASS_CALLS["fused_bottleneck"],
                "fused_bottleneck_tiled": 4 * PASS_CALLS[
                    "fused_bottleneck_tiled"],
                "fused_decoder_level": 1, "fused_decoder_level_tiled": 2}
        if launches != want:
            raise AssertionError(f"serve path launched {launches}, want "
                                 f"{want} (one score and one maps batch)")
        nulls = [[v is None for v in r["scores"]] for r in scores]
        mnulls = [[v is None for v in r["map_means"]] for r in maps]
        want_nulls = [[i == 5 and m == 3 for m in range(SERVE_K)]
                      for i in range(SERVE_G)]
        if nulls != want_nulls or mnulls != want_nulls:
            raise AssertionError(f"serve nulls {nulls} / {mnulls}")
        if not all(v > 0 for r in scores for v in r["scores"] if v is not None):
            raise AssertionError(f"serve scores not > 0: {scores}")
        emit("serve", step="score_and_maps_batch", g=SERVE_G, k=SERVE_K,
             seconds=seconds, launches=launches,
             device_batches=service.stats["device_batches"],
             scores=[r["scores"] for r in scores],
             map_means=[r["map_means"] for r in maps])
        # The device side of a full score batch (G = 8, K = 4), as the
        # service calls it.
        pre = service._core.preprocess
        gt = np.stack([pre.decode_uint8(g) for g in gts])
        sr = np.stack([np.stack([pre.decode_uint8(p) for p in group])
                       for group in srs])
        emit("serve", step="profile_score_batch", g=SERVE_G, k=SERVE_K,
             card=card, **profile_scoring(
                 torch, service.scorer(SERVE_K, SERVE_G), gt, sr))

        # HTTP, from client processes of their own (as users' would be):
        # lone K = 4 requests with the decode cache off (every image
        # decoded) and warm (every image cached), then 32 concurrent
        # clients with the cache warm.
        server = serve_http(service, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/"

        def clients(n, per_client):
            proc = subprocess.run(
                [sys.executable, "-c", HTTP_CLIENTS, json.dumps({
                    "url": url, "requests": reqs, "k": SERVE_K,
                    "clients": n, "per_client": per_client})],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"http clients: {proc.stderr[-2000:]}")
            out = json.loads(proc.stdout)
            if out["errors"]:
                raise AssertionError(f"http responses: {out['errors']}")
            return out

        lone = {}
        for name, cache in (("cold_decode_cache_off", 0),
                            ("warm_decode_cache", 256)):
            service.decode_cache = cache
            clients(1, SERVE_G)  # fills the cache (when on)
            lone[name] = percentiles(np, clients(1, 56)["latencies"])
        emit("serve", step="http_lone_latency", k=SERVE_K, card=card, **lone)

        # Where a device batch's time goes: the collector's score_requests
        # calls (decode through the LRU, packing, the device call, the
        # responses), and in them the device call to its .cpu() result.
        n_clients, per_client = 32, 8
        spans, device = [], []
        bucket = service.scorer(SERVE_K, SERVE_G)
        score_requests, score_arrays = (service.score_requests,
                                        bucket.score_arrays)

        def timed(fn, into, sync=False):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                if sync:
                    torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return call

        service.score_requests = timed(score_requests, spans)
        bucket.score_arrays = timed(score_arrays, device, sync=True)
        before = dict(service.stats)
        try:
            out = clients(n_clients, per_client)
        finally:
            del service.score_requests, bucket.score_arrays
        wall = out["seconds"]
        batches = service.stats["device_batches"] - before["device_batches"]
        n_req = service.stats["requests"] - before["requests"]
        fill = n_req / batches
        if n_req != n_clients * per_client or fill <= 1:
            raise AssertionError(f"http batcher: {n_req} requests in "
                                 f"{batches} device batches")
        emit("serve", step="http_concurrent", clients=n_clients,
             requests=n_req, k=SERVE_K, seconds=wall,
             pairs_per_s=n_req * SERVE_K / wall, device_batches=batches,
             mean_fill=fill, linger_ms=service.linger_ms,
             latency=percentiles(np, out["latencies"]),
             collector_busy_share=sum(spans) / wall,
             score_requests_ms=percentiles(np, spans),
             g8_device_call_ms=percentiles(np, device), card=card)
        # {"cmd": "shutdown"} over HTTP stops the server.
        with urllib.request.urlopen(urllib.request.Request(
                url, data=b'{"cmd": "shutdown"}'), timeout=60) as r:
            bye = json.loads(r.read())
        thread.join(timeout=30)
        if bye != {"ok": True, "shutdown": True} or thread.is_alive():
            raise AssertionError(f"http shutdown: {bye}")
        server.server_close()
        service.close()
        del service

        # The CLI over stdio, as a user runs it, beside the untimed float32
        # checks below (the subprocess would disturb the timed steps).
        maps_dir = tmp / "maps"
        script = tmp / "requests.jsonl"
        script.write_text("\n".join(stdio_script(gts, srs, bad, maps_dir))
                          + "\n")
        with open(script) as stdin:
            cli = subprocess.Popen(
                [sys.executable, "-m", "srsem_torch", "serve", "--warmup-k",
                 "1", str(SERVE_K), "--with-maps"],
                cwd=REPO, stdin=stdin, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        try:
            cfg32 = dataclasses.replace(cfg, backbone=dataclasses.replace(
                cfg.backbone, compute_dtype="float32"))
            map32 = dataclasses.replace(
                map_cfg, decoder_dtype="float32",
                backbone=dataclasses.replace(map_cfg.backbone,
                                             compute_dtype="float32"))
            m32, c32 = seeded_model(torch, np, cfg32), seeded_clu(torch, np,
                                                                  map32)
            svc32 = ScoreService(cfg32, m32, group_batch=SERVE_G,
                                 map_cfg=map32, map_model=c32)
            null = lambda v: np.nan if v is None else v  # noqa: E731
            got = np.array([[null(v) for v in r["scores"]]
                            for r in svc32.score_requests(reqs)])
            got_m = np.array([[null(v) for v in r["map_means"]]
                              for r in svc32.map_requests(
                                  [dict(r, maps=True) for r in reqs])])
            svc32.close()

            def arrays(pre):
                """The batch as the service packs it: a failed file is a
                zero image (its pair is null)."""
                def one(p):
                    try:
                        return pre.decode_uint8(p)
                    except Exception:  # the corrupt SR
                        return np.zeros((IMAGE, IMAGE, 3), np.uint8)
                return (np.stack([one(r["gt"]) for r in reqs]),
                        np.stack([np.stack([one(p) for p in r["sr"]])
                                  for r in reqs]))

            want = GroupedPairScorer(cfg32, m32, k=SERVE_K,
                                     batch_size=SERVE_G).score_arrays(
                *arrays(svc32._core.preprocess)).cpu().numpy()
            want_m = GroupedMapScorer(map32, c32, k=SERVE_K,
                                      batch_size=SERVE_G).score_arrays(
                *arrays(svc32._map_core.preprocess)).float().mean(
                dim=(2, 3)).cpu().numpy()
            ok = ~np.isnan(got)
            if not (ok == ~np.isnan(got_m)).all() or ok.sum() != ok.size - 1:
                raise AssertionError("f32 service: nulls differ")
            err = float(np.abs(got - want)[ok].max())
            tol = 1e-5 + 1e-5 * float(np.abs(want[ok]).max())
            err_m = float(np.abs(got_m - want_m)[ok].max())
            if not (err <= tol and err_m <= 1e-5):
                raise AssertionError(f"f32 service vs grouped scorers: scores "
                                     f"{err} (tol {tol}), map means {err_m}")
            emit("serve", step="f32_service_vs_grouped_scorers",
                 max_abs_err=err, tolerance=tol, map_means_max_abs_err=err_m,
                 map_tolerance=1e-5, score_range=[float(want[ok].min()),
                                                  float(want[ok].max())])
            del m32, c32, svc32
            stdout, stderr = cli.communicate(timeout=600)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
        if cli.returncode != 0:
            raise AssertionError(f"serve exit {cli.returncode}: "
                                 f"{stderr[-2000:]}")
        resps = [json.loads(line) for line in stdout.splitlines()]
        stats = check_stdio(resps, maps_dir)
        emit("serve", step="cli_stdio", exit_code=cli.returncode,
             responses=len(resps), stats=stats,
             ready=stderr.strip().splitlines()[-1])
    return launches


def run_dual(torch, np, card: str):
    """Phase 8 (dual): DualScorer(resnet50_clip, 224, bf16) — stages_cnn at
    depth 3 and the CLU decoder (bf16) on ONE tower pass an image.  Returns
    {kernel: launches in one score_folders batch of 32 pairs}."""
    import dataclasses
    import shutil

    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.eval.dataset_sweep import DualScorer
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_decoder as fd
    from srsem_torch.ops import fused_head as fh

    bb = BackboneConfig(kind="resnet50_clip", image_size=IMAGE,
                        compute_dtype="bfloat16")
    gcfg = GlobalModelConfig(backbone=bb, head="stages_cnn", depth=3)
    lcfg = LocalModelConfig(backbone=bb, decoder_dtype="bfloat16", v2=False)

    def models(g, lc):
        gm = seeded_model(torch, np, g)
        lm = seeded_clu(torch, np, lc)
        lm.backbone.load_state_dict(gm.backbone.state_dict())
        return gm, lm

    gm, lm = models(gcfg, lcfg)
    dual = DualScorer(gcfg, lcfg, gm, lm, batch_size=DUAL_BATCH)
    wrappers = {"fused_stage_score": fh.fused_global_score,
                "fused_bottleneck": fb.fused_bottleneck,
                "fused_bottleneck_tiled": fb.fused_bottleneck_tiled,
                "fused_decoder_level": fd.fused_decoder_level,
                "fused_decoder_level_tiled": fd.fused_decoder_level_tiled}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pairs = write_pairs(np, tmp, 8)
        gt_dir, sr_dir = tmp / "HQ", tmp / "sr_out"
        gt_dir.mkdir()
        sr_dir.mkdir()
        for i, (pa, pb) in enumerate(pairs):  # the last SR is corrupt
            shutil.copy(pa, gt_dir / f"{i}.png")
            shutil.copy(pb, sr_dir / f"{i}.jpg")
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rows = dual.score_folders(str(gt_dir), str(sr_dir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        want = {"fused_stage_score": 1,
                "fused_bottleneck": 2 * PASS_CALLS["fused_bottleneck"],
                "fused_bottleneck_tiled": 2 * PASS_CALLS[
                    "fused_bottleneck_tiled"],
                "fused_decoder_level": 1, "fused_decoder_level_tiled": 2}
        if launches != want:
            raise AssertionError(f"dual path launched {launches}, want {want}"
                                 " (one tower pass an image for both heads)")
        nan = [np.isnan(r["score"]) for r in rows]
        last = len(rows) - 1
        if not (nan == [i == last for i in range(len(rows))]
                and all(np.isnan(rows[last][k]) for k in ("map_mean",
                                                          "map_min"))
                and all(r["score"] > 0 and 0.5 <= r["map_min"] <= r["map_mean"]
                        <= 1.0 for r in rows[:last])):
            raise AssertionError(f"dual score_folders rows: {rows}")
        emit("dual", step="score_folders", pairs=len(rows), seconds=seconds,
             launches=launches, rows=rows)

        # float32 (TF32 off): the dual scorer against the two PairScorers.
        decode = dual.preprocess.decode_uint8
        a = np.stack([decode(p[0]) for p in pairs[:-1]])
        b = np.stack([decode(p[1]) for p in pairs[:-1]])
        g32 = dataclasses.replace(gcfg, backbone=dataclasses.replace(
            bb, compute_dtype="float32"))
        l32 = dataclasses.replace(lcfg, decoder_dtype="float32",
                                  backbone=g32.backbone)
        gm32, lm32 = models(g32, l32)
        scores, maps = DualScorer(g32, l32, gm32, lm32,
                                  batch_size=len(a)).score_both(a, b)
        want_s = PairScorer(g32, gm32, batch_size=len(a)).score_arrays(a, b)
        want_m = PairScorer(l32, lm32, batch_size=len(a),
                            model_kind="local").score_arrays(a, b)
        errs = {}
        for key, got, ref in (("scores", scores, want_s),
                              ("maps", maps, want_m)):
            err = float((got - ref).abs().max())
            tol = 1e-5 + 1e-5 * float(ref.abs().max())
            if err > tol:
                raise AssertionError(f"f32 dual {key} vs PairScorer: {err} > "
                                     f"{tol}")
            errs[key] = {"max_abs_err": err, "tolerance": tol}
        emit("dual", step="f32_dual_vs_pair_scorers", **errs,
             score_range=[float(want_s.min()), float(want_s.max())])
        del gm32, lm32, scores, maps, want_s, want_m

        # pairs/s at batch 32: the dual scorer against the global and the
        # local PairScorer run one after the other, in turns.
        rng = np.random.default_rng(3)
        a32 = rng.integers(0, 256, (DUAL_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
        b32 = np.clip(a32.astype(int) + rng.integers(-20, 21, a32.shape),
                      0, 255).astype(np.uint8)
        pg = PairScorer(gcfg, gm, batch_size=DUAL_BATCH)
        pl = PairScorer(lcfg, lm, batch_size=DUAL_BATCH, model_kind="local")

        def rate(call, reps=5):
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            return DUAL_BATCH * reps / (time.perf_counter() - t0)

        both = lambda: dual.score_both(a32, b32)  # noqa: E731
        two = lambda: (pg.score_arrays(a32, b32),  # noqa: E731
                       pl.score_arrays(a32, b32))
        dual_rates, two_rates = [rate(both)], [rate(two)]
        two_rates.append(rate(two))
        dual_rates.append(rate(both))
        # The CLIP attention pool the scorers compute and discard: device
        # ms a call at the batch's layer-4 output (two calls a batch).
        h = torch.randn(DUAL_BATCH, 2048, IMAGE // 32, IMAGE // 32,
                        device=dual.device).to(torch.bfloat16)
        with torch.inference_mode():
            attn_ms = cuda_ms(torch, lambda: gm.backbone.attnpool(h), 20)
        emit("dual", step="throughput", batch=DUAL_BATCH, dtype="bfloat16",
             image=IMAGE, dual_pairs_per_s=dual_rates,
             two_scorers_pairs_per_s=two_rates,
             speedup=sum(dual_rates) / sum(two_rates),
             attnpool_ms_per_call=attn_ms, attnpool_calls_per_batch=2,
             card=card)
        emit("dual", step="profile", card=card,
             **profile_scoring(torch, types.SimpleNamespace(
                 score_arrays=dual.score_both), a32, b32))
        del pg, pl

        # The CLI entry point, as a user runs it.
        template = str(tmp / "scores_{folder}.csv")
        proc = subprocess.run(
            [sys.executable, "-m", "srsem_torch", "sweep-dataset",
             str(gt_dir), str(sr_dir), "--batch-size", "8",
             "--out-template", template],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"sweep-dataset exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        lines = (tmp / "scores_sr_out.csv").read_text().splitlines()
        if (result[str(sr_dir)]["nan"] != 1 or len(lines) != len(pairs) + 1
                or not lines[-1].endswith(",nan,nan,nan")):
            raise AssertionError(f"sweep-dataset result {result}, {lines}")
        emit("dual", step="cli_sweep_dataset", result=result)
        run_native(torch, np, card, pairs, (gcfg, gm))
    return launches


def run_native(torch, np, card: str, pairs, global_model) -> None:
    """The native line: whether the C++ decoder built here (and why not),
    the host seconds an image costs through it and through PIL (one
    thread), its bytes against PIL's within the JAX test's limits, and
    PairScorer(decode_backend="native") with a NaN row on exactly the
    corrupt file.  An unavailable library does not fail the run (the JAX
    package then uses PIL), and no native result is printed without it."""
    import os

    from srsem_torch import native
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.eval.scorer import PairScorer

    ok = native.available()
    pre = Preprocess.for_backbone(global_model[0].backbone.kind, IMAGE)
    files = [p for pair in pairs[:-1] for p in pair]

    def per_image(fn, reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            for f in files:
                fn(f)
        return (time.perf_counter() - t0) / (reps * len(files))

    line = {"available": ok, "build_error": native.build_error(),
            "cpu_count": os.cpu_count(), "images": len(files),
            "pil_seconds_per_image": per_image(pre.decode_uint8),
            "native_seconds_per_image": "not measured: library unavailable"}
    if ok:
        line["native_seconds_per_image"] = per_image(pre.decode_uint8_native)
        diffs = []
        for f in files:
            if f.endswith(".png"):
                diffs.append(np.abs(pre.decode_uint8_native(f).astype(int)
                                    - pre.decode_uint8(f).astype(int)))
        d = np.concatenate([x.ravel() for x in diffs])
        stats = {"mean": float(d.mean()),
                 "q999": float(np.quantile(d, 0.999)), "max": int(d.max())}
        if not (stats["mean"] < 0.5 and stats["q999"] <= 6
                and stats["max"] <= 16):
            raise AssertionError(f"native vs PIL bytes: {stats}")
        scores = PairScorer(*global_model, batch_size=8,
                            decode_backend="native").score_paths(pairs)
        nan = np.isnan(scores)
        if not (nan[-1] and not nan[:-1].any()):
            raise AssertionError(f"native score_paths: NaN rows {nan}")
        line.update(png_vs_pil=stats, score_paths_nan_rows=nan.tolist())
    emit("native", card=card, **line)


# The train phase's batches: the reference batch sizes (TrainConfig's 5
# for train-global, train-clu's 80) and the global scorer's batch of 64;
# a train step runs the frozen tower once over its 2N images.
TRAIN_BATCH, TRAIN_BIG_BATCH, CLU_TRAIN_BATCH = 5, BATCH, 80
# The pairs CSV: 100 rows split 80 / 20, one batch of 80 each (every
# train-clu run makes one train step and one validation batch).
N_STUDY, N_CLU_ROWS = 48, 100
TRAIN_DEVICE = "cuda"


def write_study(np, root: Path):
    """A user-study set at the reference layout: ``HQ/{i}.jpg`` and
    ``SR/x4_{i}.png`` at 256x288, the SR the GT blended with a permuted
    copy at strength alpha and labelled alpha (tests/test_srcc_rehearsal.py
    plants its signal so), its CSV, and a KonIQ-style pairs CSV over the
    same images with pickled 28x28 cosine maps."""
    import pickle

    from PIL import Image

    rng = np.random.default_rng(4)
    for d in ("SR", "HQ", "maps"):
        (root / d).mkdir()
    scores, pairs = [], []
    for i in range(N_STUDY):
        gt = rng.integers(0, 256, (256, 288, 3), dtype=np.uint8)
        alpha = float(rng.uniform(0.05, 0.95))
        perm = rng.permutation(gt.reshape(-1, 3)).reshape(gt.shape)
        sr = ((1 - alpha) * gt + alpha * perm).astype(np.uint8)
        Image.fromarray(gt).save(root / "HQ" / f"{i}.jpg", quality=90)
        Image.fromarray(sr).save(root / "SR" / f"x4_{i}.png")
        scores.append(f"x4_{i}.png,{alpha!r}")
    (root / "study.csv").write_text(
        "img_names,userStudyScores\n" + "\n".join(scores) + "\n")
    rows = ["img_a_pth,img_b_pth,out_paths,ima_ncaps"]
    for r in range(N_CLU_ROWS):
        i = r % N_STUDY
        path = root / "maps" / f"{r}.pkl"
        with open(path, "wb") as f:
            pickle.dump(rng.uniform(0, 1, (28, 28)).astype(np.float32), f)
        rows.append(f"{root / 'HQ' / f'{i}.jpg'},{root / 'SR' / f'x4_{i}.png'},"
                    f"{path},4")
    (root / "pairs.csv").write_text("\n".join(rows) + "\n")


def cli_json(argv) -> dict:
    """``python -m srsem_torch ARGV`` in this process; its JSON line."""
    import contextlib
    import io

    from srsem_torch.cli.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv + ["--device", TRAIN_DEVICE])
    if rc != 0:
        raise AssertionError(f"{argv[0]} exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def train_setup(torch, np, model, is_map: bool, fused: bool = True):
    """The training loop's step functions for ``model`` on the card: Adam
    over everything outside the tower, the steps over the folded tower
    (or the module's, ``fused=False``)."""
    from srsem_torch.train.loop import build_training
    from srsem_torch.train.partition import trainable_predicate

    return build_training(model, is_map, trainable_predicate(), 1e-4,
                          torch.device(TRAIN_DEVICE), fused)[0]


def host_batch(np, n: int, is_map: bool, seed: int):
    """A normalized float32 host batch of ``n`` pairs at 224 px (what the
    loader yields), labels in [0, 1] (maps for the CLU), all rows valid."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)
    b = (a + rng.standard_normal(a.shape)).astype(np.float32)
    y = rng.uniform(0, 1, (n, IMAGE, IMAGE) if is_map else (n,))
    return ((a, b), y.astype(np.float32)), np.ones((n,), np.float32)


def train_rate(torch, np, steps, batch, n: int, reps: int,
               prof_reps: int = 3) -> dict:
    """Train steps/s and items/s over ``reps`` steps of ``batch`` (host to
    card through pinned memory each step, as the loop does; one sync at
    the end), the device memory (resident before the steps: every model
    the phase holds; the peak; their difference, the step's own), the
    losses, and a profile of ``prof_reps`` steps (busy share, device ms by
    group and by kernel, the top host operations; reading a profile of a
    step that trains a 224 px tower takes the host seconds a step)."""
    from srsem_torch.train.loop import batch_to_device

    dev = torch.device(TRAIN_DEVICE)
    step = lambda: steps.train_step(*batch_to_device(batch, dev))  # noqa: E731
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(reps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prof = profile_scoring(torch, types.SimpleNamespace(
        score_arrays=lambda *_: step()), None, None, reps=prof_reps,
        host_top=10)
    return {"batch": n, "steps": reps, "steps_per_s": reps / dt,
            "items_per_s": n * reps / dt, "ms_per_step": dt / reps * 1e3,
            "peak_memory_bytes": peak,
            "resident_bytes_before": resident,
            "step_memory_bytes": peak - resident,
            "losses": [float(v) for v in losses], "profile": prof}


BOTTLENECK = ("fused_bottleneck", "fused_bottleneck_tiled")


def zero_launches(fb) -> None:
    """Set the bottleneck wrappers' launch counts to 0."""
    for name in BOTTLENECK:
        getattr(fb, name).launches = 0


def read_launches(torch, fb) -> dict:
    """The bottleneck wrappers' launch counts, after a sync."""
    torch.cuda.synchronize()
    return {name: getattr(fb, name).launches for name in BOTTLENECK}


class Laps:
    """Seconds between successive ``lap(what)`` calls, by ``what``."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.seconds[what] = now - self._t
        self._t = now


_TOWER: dict = {}


def clip_tower(torch, np) -> dict:
    """The train, finetune and sweeps phases' tower, built once: a
    full-width CLIP tower's state dict (OpenAI-CLIP layout) with seeded
    random weights and random BN statistics."""
    from srsem_torch.backbones.resnet import make_backbone, reset_tower
    from srsem_torch.config import BackboneConfig

    if not _TOWER:
        tower = make_backbone(BackboneConfig(kind="resnet50_clip",
                                             image_size=IMAGE))
        reset_tower(tower, torch.Generator().manual_seed(7))
        randomize_bn(torch, np, tower, np.random.default_rng(7))
        _TOWER.update(tower.state_dict())
    return _TOWER


def run_train(torch, np, card: str):
    """Phase 9 (train): ``train-global`` at its defaults (resnet50_clip,
    224, bf16 tower, stages_cnn depth 3, batch 5) for two epochs with a
    checkpoint directory, ``eval-global`` and ``score`` on that checkpoint
    (the scores are the trained model's validation predictions),
    ``train-clu`` at batch 80 (the BN running statistics moved); the
    launches of one global and one CLU train step (the train path);
    throughput at batch 5, 64 (global) and 80 (CLU); one float32 train
    step through the fused tower against the module tower (TF32 off).
    Returns {kernel: launches in the two counted train steps}."""
    import copy

    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import make_local_model
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.train.checkpoint import restore_checkpoint
    from srsem_torch.train.loop import batch_to_device
    from srsem_torch.train.partition import flatten_dict
    from srsem_torch.utils.convert import jax_trainable_params

    def bb(dtype="bfloat16"):
        return BackboneConfig(kind="resnet50_clip", image_size=IMAGE,
                              compute_dtype=dtype)

    dev = torch.device(TRAIN_DEVICE)

    gcfg = GlobalModelConfig(backbone=bb(), head="stages_cnn", depth=3)
    tower = clip_tower(torch, np)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_study(np, tmp)
        torch.save(tower, tmp / "tower.pt")
        study = [str(tmp / "study.csv"), str(tmp)]
        ck = tmp / "ckpt"
        t0 = time.perf_counter()
        trained = cli_json(["train-global", *study, "--backbone-checkpoint",
                            str(tmp / "tower.pt"), "--checkpoint-dir", str(ck),
                            "--train-set", "epochs=2"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_val = round(N_STUDY * 0.2)
        want_steps = 2 * -(-(N_STUDY - n_val) // TRAIN_BATCH)
        if trained["steps"] != want_steps or not all(
                np.isfinite(v) for v in trained["val_metrics"].values()):
            raise AssertionError(f"train-global: {trained}")
        saved = restore_checkpoint(str(ck))
        emit("train", step="train_global_cli", batch=TRAIN_BATCH, epochs=2,
             result=trained, seconds=seconds,
             steps_per_s_with_data_and_validation=trained["steps"] / seconds,
             checkpoint_keys=sorted(saved),
             adam_count=int(saved["opt_state"]["0"]["count"]), card=card)

        # eval-global on that checkpoint (PairScorer: bottleneck and head
        # kernels), and score --checkpoint on the validation pairs against
        # the trained model's validation predictions (module head, fused
        # tower, the loop's eval step), batch 5 both.
        common = ["--backbone", "resnet50_clip", "--backbone-checkpoint",
                  str(tmp / "tower.pt"), "--checkpoint", str(ck)]
        evaluated = cli_json(["eval-global", *study, *common, "--val-only"])
        if evaluated["n"] != n_val:
            raise AssertionError(f"eval-global: {evaluated}")
        from srsem_torch.cli.main import _load_checkpoint
        from srsem_torch.data.datasets import (
            Subset,
            UserStudyScores,
            seeded_split,
        )
        from srsem_torch.data.loader import Loader
        from srsem_torch.data.preprocess import Preprocess

        ds = UserStudyScores(*study, Preprocess.for_backbone(
            "resnet50_clip", IMAGE))
        _, val_idx = seeded_split(len(ds), 0.2, 42)
        csv_path = tmp / "val_pairs.csv"
        csv_path.write_text("img_a_pth,img_b_pth\n" + "".join(
            "{1},{0}\n".format(*ds.paths(int(i))) for i in val_idx))
        scored = cli_json(["score", str(csv_path), *common, "--batch-size",
                           str(TRAIN_BATCH), "--out", str(tmp / "val.csv")])
        got = np.array([float(r.split(",")[-1]) for r in
                        (tmp / "val.csv").read_text().splitlines()[1:]])
        model = make_global_model(gcfg, torch.Generator().manual_seed(0))
        model.backbone.load_state_dict(tower)
        _load_checkpoint(model, str(ck))
        val_steps = train_setup(torch, np, model, False)
        preds = []
        for batch in Loader(Subset(ds, val_idx), TRAIN_BATCH):
            pred, _ = val_steps.eval_step(*batch_to_device(batch, dev))
            preds.append(pred.float().cpu().numpy()[batch[1] > 0])
        want = np.concatenate(preds)
        err = float(np.abs(got - want).max())
        tol = 1e-3 + 1e-3 * float(np.abs(want).max())
        if scored["nan"] or err > tol:
            raise AssertionError(f"score --checkpoint vs the trained model's "
                                 f"validation predictions: {err} > {tol}")
        val_mse = float(np.mean((want - np.array(
            [ds.label(int(i)) for i in val_idx])) ** 2))
        emit("train", step="eval_global_and_score", eval_global=evaluated,
             score_vs_validation_predictions={"max_abs_err": err,
                                              "tolerance": tol},
             validation_mse_recomputed=val_mse,
             validation_mse_logged=trained["val_metrics"]["mse"])
        del model, val_steps

        # train-clu at its batch of 80 (one epoch, with the tower above).
        ckc = tmp / "ckpt_clu"
        t0 = time.perf_counter()
        clu = cli_json(["train-clu", str(tmp / "pairs.csv"),
                        "--backbone-checkpoint", str(tmp / "tower.pt"),
                        "--checkpoint-dir", str(ckc),
                        "--train-set", "epochs=1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = flatten_dict(restore_checkpoint(str(ckc))["batch_stats"])
        still = [k for k, v in stats.items()
                 if np.allclose(v, 0.0 if k[-1] == "mean" else 1.0)]
        if still or not np.isfinite(clu["val_metrics"]["mse"]):
            raise AssertionError(f"train-clu: {clu}; unmoved BN stats {still}")
        emit("train", step="train_clu_cli", batch=CLU_TRAIN_BATCH, result=clu,
             seconds=seconds, bn_statistics_moved=len(stats), card=card)

    # The train path: one global train step at batch 5 and one CLU train
    # step at batch 80, launch counts reset just before and read just
    # after.
    gmodel = make_global_model(gcfg, torch.Generator().manual_seed(1))
    gmodel.backbone.load_state_dict(tower)
    gsteps = train_setup(torch, np, gmodel, False)
    lmodel = make_local_model(LocalModelConfig(backbone=bb()),
                              generator=torch.Generator().manual_seed(2))
    lmodel.backbone.load_state_dict(tower)
    lsteps = train_setup(torch, np, lmodel, True)
    g5 = host_batch(np, TRAIN_BATCH, False, 10)
    c80 = host_batch(np, CLU_TRAIN_BATCH, True, 11)
    zero_launches(fb)
    losses = [gsteps.train_step(*batch_to_device(g5, dev)),
              lsteps.train_step(*batch_to_device(c80, dev))]
    launches = read_launches(torch, fb)
    want = {k: 2 * v for k, v in PASS_CALLS.items()}
    if launches != want or not all(torch.isfinite(v) for v in losses):
        raise AssertionError(f"train path launched {launches}, want {want}; "
                             f"losses {losses}")
    emit("train", step="train_path", launches=launches,
         losses=[float(v) for v in losses])

    # Throughput (bf16 tower, float32 head and decoder, TF32 off).
    rates = {
        "global_batch5": train_rate(torch, np, gsteps, g5, TRAIN_BATCH, 20),
        "global_batch64": train_rate(
            torch, np, gsteps, host_batch(np, TRAIN_BIG_BATCH, False, 12),
            TRAIN_BIG_BATCH, 10),
        "clu_batch80": train_rate(torch, np, lsteps, c80, CLU_TRAIN_BATCH, 5,
                                  prof_reps=1),
    }
    for key, rate in rates.items():
        if not all(np.isfinite(rate["losses"])):
            raise AssertionError(f"{key} losses {rate['losses']}")
        emit("train", step="throughput", path=key, card=card,
             unit="maps/s" if key.startswith("clu") else "pairs/s", **rate)
    del gmodel, gsteps, lmodel, lsteps

    # float32, TF32 off: one train step through the fused tower against
    # the module tower, from the same weights on the same batch.
    cfg32 = GlobalModelConfig(backbone=bb("float32"), head="stages_cnn",
                              depth=3)
    fused = make_global_model(cfg32, torch.Generator().manual_seed(3))
    fused.backbone.load_state_dict(tower)
    module = copy.deepcopy(fused)
    out = {}
    for name, m, use_fused in (("fused", fused, True),
                               ("module", module, False)):
        steps = train_setup(torch, np, m, False, fused=use_fused)
        loss = float(steps.train_step(*batch_to_device(g5, dev)))
        out[name] = (loss, flatten_dict(jax_trainable_params(m)[0]))
    (lf, pf), (lm, pm) = out["fused"], out["module"]
    rel = abs(lf - lm) / abs(lm)
    perr = max(float(np.abs(pf[k] - pm[k]).max()) for k in pm)
    if rel > 1e-5 or perr > 1e-6:
        raise AssertionError(f"f32 train step, fused vs module tower: loss "
                             f"rel {rel} (1e-5), head params {perr} (1e-6)")
    emit("train", step="f32_fused_vs_module_train_step",
         losses={"fused": lf, "module": lm}, loss_rel_err=rel,
         head_param_max_abs_err=perr,
         tolerance="loss rtol 1e-5, head params atol 1e-6")
    del fused, module, steps
    run_rehearsal(torch, np, card, tower)
    return launches


# The SRCC rehearsal (tests/test_srcc_rehearsal.py's planted signal) at
# 224 px: 40 train and 16 validation pairs, batch 8, 30 epochs.
REHEARSAL = {"train": 40, "val": 16, "batch": 8, "epochs": 30}


def rehearsal_batches(np, n: int, rng) -> list:
    """GT textures in [0,1]; each SR the GT blended with a pixel-permuted
    copy at strength alpha plus noise; label alpha; full batches."""
    gt = rng.uniform(0, 1, (n, IMAGE, IMAGE, 3)).astype(np.float32)
    alpha = rng.uniform(0.05, 0.95, n).astype(np.float32)
    perm = np.stack([rng.permutation(g.reshape(-1, 3)).reshape(g.shape)
                     for g in gt])
    a = alpha[:, None, None, None]
    sr = np.clip((1 - a) * gt + a * perm
                 + 0.02 * rng.standard_normal(gt.shape), 0, 1)
    b = REHEARSAL["batch"]
    return [(((gt[i:i + b], sr[i:i + b].astype(np.float32)), alpha[i:i + b]),
             np.ones((b,), np.float32)) for i in range(0, n - b + 1, b)]


def run_rehearsal(torch, np, card: str, tower: dict) -> None:
    """The train phase's SRCC rehearsal: the port's ``train_global``
    (stages_cnn depth 2 on the train phase's CLIP tower, the fused kernel
    tower) beside a plain-module loop (the module tower, the same head
    and Adam at 1e-4, the same batches), in float32 (TF32 off) and in
    bf16; each run's validation SRCC and the two deltas.  Fails if the
    float32 delta exceeds 0.005 (the north star) or an SRCC is not
    finite; the bf16 delta is recorded, not gated."""
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        TrainConfig,
    )
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.train.logging import MultiWriter
    from srsem_torch.train.loop import batch_to_device, train_global
    from srsem_torch.train.metrics import srcc
    from srsem_torch.train.steps import masked_mse
    from srsem_torch.utils.convert import jax_tower_params, jax_trainable_params

    dev = torch.device(TRAIN_DEVICE)
    rng = np.random.default_rng(31)
    train = rehearsal_batches(np, REHEARSAL["train"], rng)
    val = rehearsal_batches(np, REHEARSAL["val"], rng)
    targets = np.concatenate([y for ((_, _), y), _ in val])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = GlobalModelConfig(backbone=BackboneConfig(
            kind="resnet50_clip", image_size=IMAGE, compute_dtype=dtype),
            head="stages_cnn", depth=2)
        model = make_global_model(cfg, torch.Generator().manual_seed(12))
        model.backbone.load_state_dict(tower)
        # The test's heads: torch's default Conv2d init, biases in [0.05,
        # 0.15] (a live final ReLU).
        g = torch.Generator().manual_seed(13)
        with torch.no_grad():
            for conv in model.aggregator.w_layers:
                bound_ = conv.weight[0].numel() ** -0.5
                conv.weight.uniform_(-bound_, bound_, generator=g)
                conv.bias.uniform_(0.05, 0.15, generator=g)
        variables = {"params": {
            "backbone": jax_tower_params(model.backbone,
                                         model.backbone.state_dict(),
                                         lambda t: t),
            **jax_trainable_params(model)[0]}}
        t0 = time.perf_counter()
        res = train_global(cfg, TrainConfig(
            lr=1e-4, batch_size=REHEARSAL["batch"],
            epochs=REHEARSAL["epochs"], log_every=10 ** 6), train, val,
            writer=MultiWriter(), variables=variables, device=dev)
        t_kernel = time.perf_counter() - t0

        plain = model.to(dev)  # make_global_model froze every parameter
        head = [p.requires_grad_(True) for n, p in plain.named_parameters()
                if not n.startswith("backbone.")]
        opt = torch.optim.Adam(head, lr=1e-4)
        t0 = time.perf_counter()
        for _ in range(REHEARSAL["epochs"]):
            for batch in train:
                a, b, y, m = batch_to_device(batch, dev)
                loss = masked_mse(plain(a, b), y, m)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        with torch.no_grad():
            preds = np.concatenate([
                plain(*batch_to_device(batch, dev)[:2]).float().cpu().numpy()
                for batch in val])
        t_plain = time.perf_counter() - t0
        out[dtype] = {"srcc_kernel_tower": res.val_metrics["srcc"],
                      "srcc_module_tower": srcc(preds, targets),
                      "seconds": {"kernel_tower": t_kernel,
                                  "module_tower": t_plain}}
        out[dtype]["delta"] = abs(out[dtype]["srcc_kernel_tower"]
                                  - out[dtype]["srcc_module_tower"])
        del model, plain, opt, res
    emit("train", step="srcc_rehearsal_224", **REHEARSAL, image=IMAGE,
         f32_tf32_off=out["float32"], bf16=out["bfloat16"],
         srcc_delta={"float32": out["float32"]["delta"],
                     "bfloat16": out["bfloat16"]["delta"]},
         gate="float32 delta <= 0.005; bf16 recorded", card=card)
    vals = [v for d in out.values() for v in
            (d["srcc_kernel_tower"], d["srcc_module_tower"])]
    if not np.isfinite(vals).all() or out["float32"]["delta"] > 0.005:
        raise AssertionError(f"SRCC rehearsal: {out}")


# The finetune phase: the reference's LoRA rank on every tower conv, at
# the train phase's batches (80 for the CLU, 5 and 64 for the global
# regressor).
LORA_RANK = 32


def moved_keys(torch, before: dict, model) -> list:
    """State-dict keys whose values changed since ``before``."""
    return sorted(k for k, v in model.state_dict().items()
                  if not torch.equal(v, before[k]))


def run_finetune(torch, np, card: str) -> dict:
    """Phase 10 (finetune): tower training at full width — the CLU at batch
    80 with LoRA (rank 32) on every tower conv and with the whole tower
    trained under activation checkpointing ("full"), and the global
    regressor's ``enc_ft`` step at batch 5 and 64: ms a step, maps or
    pairs/s, peak and step memory, a profile.  The tower trains, so it
    runs as the module: the bottleneck kernels must launch no time.  Card
    checks: a LoRA step moves only the factors and the decoder; a "full"
    step moves the tower's BN running means and variances; in float32
    (TF32 off) the first LoRA forward (A = 0) equals the frozen module
    tower's, and the checkpointed tower's gradients equal an
    un-checkpointed pass's; ``fused_tower=True`` on a LoRA model raises.
    Returns the bottleneck launches of its steps (all zero)."""
    from srsem_torch.backbones.resnet import make_backbone
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import make_local_model
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.train.loop import batch_to_device, build_training
    from srsem_torch.train.partition import trainable_predicate
    from srsem_torch.train.steps import masked_mse
    from srsem_torch.utils.convert import load_backbone_params

    dev = torch.device(TRAIN_DEVICE)
    tower = clip_tower(torch, np)
    lap = Laps()

    def bb(dtype="bfloat16"):
        return BackboneConfig(kind="resnet50_clip", image_size=IMAGE,
                              compute_dtype=dtype)

    def clu(rank, dtype="bfloat16", width=1.0):
        model = make_local_model(
            LocalModelConfig(backbone=bb(dtype), lora_rank=rank),
            width_mult=width, generator=torch.Generator().manual_seed(2))
        load_backbone_params(model.backbone, "resnet50_clip", tower)
        return model

    zero_launches(fb)
    c80 = host_batch(np, CLU_TRAIN_BATCH, True, 11)
    rates, checks = {}, {}
    for key, rank, pred in (
            ("clu_lora32_batch80", LORA_RANK, trainable_predicate(lora=True)),
            ("clu_full_batch80", "full",
             trainable_predicate(full_finetune=True))):
        model = clu(rank)
        steps, _ = build_training(model, True, pred, 1e-4, dev)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loss = float(steps.train_step(*batch_to_device(c80, dev)))
        moved = moved_keys(torch, before, model)
        tower_moved = [k for k in moved if k.startswith("backbone.")]
        if rank == "full":
            stats = [k for k in tower_moved
                     if k.endswith(("running_mean", "running_var"))]
            if not stats or not np.isfinite(loss):
                raise AssertionError(f"a full step moved no BN statistics: "
                                     f"{tower_moved[:5]}, loss {loss}")
            checks["full_step"] = {"tower_leaves_moved": len(tower_moved),
                                   "bn_statistics_moved": len(stats),
                                   "loss": loss}
        else:
            bad = [k for k in moved if not k.startswith("decoder.")
                   and not k.endswith(("lora_a", "lora_b"))]
            if bad or not tower_moved or not np.isfinite(loss):
                raise AssertionError(f"a LoRA step moved {bad[:5]} (tower "
                                     f"{len(tower_moved)} leaves), loss {loss}")
            checks["lora_step"] = {"factors_moved": len(tower_moved),
                                   "decoder_leaves_moved":
                                   len(moved) - len(tower_moved),
                                   "other_leaves_moved": 0, "loss": loss}
        lap(f"{key}_build_and_checked_step")
        rates[key] = train_rate(torch, np, steps, c80, CLU_TRAIN_BATCH, 3,
                                prof_reps=1)
        del model, steps, before
        torch.cuda.empty_cache()
        lap(f"{key}_rate")
    gmodel = make_global_model(GlobalModelConfig(
        backbone=bb(), head="stages_cnn", depth=3, enc_ft=True),
        torch.Generator().manual_seed(1))
    load_backbone_params(gmodel.backbone, "resnet50_clip", tower)
    gsteps, _ = build_training(gmodel, False, trainable_predicate(enc_ft=True),
                               1e-4, dev)
    rates["global_enc_ft_batch5"] = train_rate(
        torch, np, gsteps, host_batch(np, TRAIN_BATCH, False, 10),
        TRAIN_BATCH, 8, prof_reps=1)
    rates["global_enc_ft_batch64"] = train_rate(
        torch, np, gsteps, host_batch(np, TRAIN_BIG_BATCH, False, 12),
        TRAIN_BIG_BATCH, 4, prof_reps=1)
    del gmodel, gsteps
    torch.cuda.empty_cache()
    lap("global_enc_ft_rates")
    launches = read_launches(torch, fb)
    if any(launches.values()):
        raise AssertionError(f"a trained tower launched the folded tower's "
                             f"kernels: {launches}")
    for key, rate in rates.items():
        if not all(np.isfinite(rate["losses"])):
            raise AssertionError(f"{key} losses {rate['losses']}")
        emit("finetune", step="throughput", path=key, card=card,
             unit="maps/s" if key.startswith("clu") else "pairs/s", **rate)

    # float32, TF32 off, batch 4: the LoRA tower (A = 0) against the
    # frozen module tower, tap by tap.  These checks are of the tower: the
    # decoder is at width 1/8.
    small = host_batch(np, 4, True, 13)
    a, b, y, mask = batch_to_device(small, dev)
    frozen = make_backbone(bb("float32"))
    load_backbone_params(frozen, "resnet50_clip", tower)
    lora = clu(LORA_RANK, "float32", 0.125).to(dev)
    with torch.no_grad():
        _, got = lora.backbone(torch.cat([a, b]))
        _, want = frozen.to(dev)(torch.cat([a, b]))
    first = max(float((got[k] - want[k]).abs().max()) for k in want)
    del frozen, got, want
    if first > 1e-6:
        raise AssertionError(f"first LoRA forward vs frozen tower: {first}")
    full = clu("full", "float32", 0.125).to(dev).requires_grad_(True)
    grads = {}
    for name, tower_fn in (("checkpointed", full.tower),
                           ("plain", full.backbone)):
        full.zero_grad(set_to_none=True)
        _, taps = tower_fn(torch.cat([a, b]))
        n = a.shape[0]
        pred = full.decode_from_taps({k: v[:n] for k, v in taps.items()},
                                     {k: v[n:] for k, v in taps.items()},
                                     a, b, train=True)
        masked_mse(pred, y, mask).backward()
        grads[name] = {k: p.grad.clone() for k, p in full.named_parameters()
                       if p.grad is not None and k.startswith("backbone.")}
    worst = 0.0
    for k, g in grads["plain"].items():
        err = float((grads["checkpointed"][k] - g).abs().max())
        scale = float(g.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
    if set(grads["plain"]) != set(grads["checkpointed"]) or worst > 1e-4:
        raise AssertionError(f"checkpointed tower gradients vs plain: worst "
                             f"relative error {worst}")
    del full, grads
    refused = []
    lcfg = LocalModelConfig(backbone=bb("float32"), lora_rank=LORA_RANK)
    for what, call in (
            ("build_training", lambda: build_training(
                lora, True, trainable_predicate(lora=True), 1e-4, dev,
                fused_tower=True)),
            ("PairScorer", lambda: PairScorer(lcfg, lora, model_kind="local",
                                              fused_tower=True, device=dev))):
        try:
            call()
        except ValueError as e:
            refused.append({"where": what, "error": str(e)})
        else:
            raise AssertionError(f"{what}: fused_tower=True on a LoRA model "
                                 "did not raise")
    del lora
    torch.cuda.empty_cache()
    lap("float32_checks")
    emit("finetune", step="checks", card=card, **checks, seconds=lap.seconds,
         first_lora_forward_vs_frozen_max_abs_err=first,
         checkpointed_vs_plain_grad_worst_rel_err=worst,
         fused_tower_refused=refused, bottleneck_launches=launches,
         tolerance="first forward 1e-6 abs (A = 0); tower gradients 1e-4 "
                   "of each tensor's max; float32, TF32 off, batch 4")
    return launches


# The sweeps phase: the global sweep's reference sizes — batch 5, depths
# 1-3 — over 300 pairs, whose 240-pair train split is the one
# srsem/train/diffcache.py:24 sizes its cache for (~6 MB a pair); 4 of
# the reference's 30 epochs (epochs/s from the cache does not depend on
# the count).
N_SWEEP_PAIRS = 300
SWEEP_EPOCHS = 4
# The sweeps path, counted in every timed run: eight global runs (the
# shared-tower epoch, three diff-cache and three stat-cache runs, the
# closed form), each one tower pass a 5-pair batch of the 300 pairs; two
# train-clu CLI runs (--cached-diffs, --thresholds; one epoch), each one
# pass a batch of 80 over the pairs CSV's train and validation splits.
# By images a pass; check_kernels times the train path's passes so many
# times for it.
SWEEP_GLOBAL_RUNS = 8
CLU_CLI_PASSES = (-(-(N_CLU_ROWS - round(N_CLU_ROWS * 0.2)) // CLU_TRAIN_BATCH)
                  + -(-round(N_CLU_ROWS * 0.2) // CLU_TRAIN_BATCH))
SWEEP_PASSES = {2 * TRAIN_BATCH: SWEEP_GLOBAL_RUNS * N_SWEEP_PAIRS // TRAIN_BATCH,
                2 * CLU_TRAIN_BATCH: 2 * CLU_CLI_PASSES}


def sweep_batches(np, n: int, seed: int) -> list:
    """``n`` distinct user-study pairs made in bulk, as the loader yields
    them at 224 px (CLIP-normalized float32, batches of 5, all rows
    valid): SR = the GT blended with a permuted copy at strength alpha,
    labelled alpha (write_study's signal)."""
    from srsem_torch.ops.image import CLIP_MEAN, CLIP_STD

    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.float32)
    alpha = rng.uniform(0.05, 0.95, n).astype(np.float32)
    perm = np.stack([rng.permutation(g.reshape(-1, 3)).reshape(g.shape)
                     for g in gt])
    sr = (1 - alpha[:, None, None, None]) * gt + alpha[:, None, None, None] * perm
    norm = lambda x: ((np.floor(x) / 255.0 - np.float32(CLIP_MEAN))  # noqa: E731
                      / np.float32(CLIP_STD)).astype(np.float32)
    a, b = norm(sr), norm(gt)
    ones = np.ones((TRAIN_BATCH,), np.float32)
    return [(((a[i:i + TRAIN_BATCH], b[i:i + TRAIN_BATCH]),
              alpha[i:i + TRAIN_BATCH]), ones)
            for i in range(0, n, TRAIN_BATCH)]


def run_sweeps(torch, np, card: str) -> dict:
    """Phase 11 (sweeps): the frozen-tower amortizations at full width.
    The global depth grid at batch 5 over 240 train and 60 validation
    pairs (made in bulk, ``sweep_batches``): the shared tower (one
    epoch), the diff cache and the stat cache (4 epochs each; build time
    and bytes, epochs/s from the cache), the closed form (the solve's
    ms); ``train-clu --cached-diffs`` and ``--thresholds none 0.4 0.9``
    at batch 80 through the CLI.  The sweeps path is those runs: the
    launch counts are set to 0 just before each and read just after, and
    must be one tower pass a batch (``SWEEP_PASSES``).  Card checks: one
    cached step's loss and head gradients equal one uncached step's, and
    one stat-cache step's equal one diff-cache step's; the closed form's
    train MSE is at most the Adam heads'.  Returns the sweeps path's
    launches."""
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        TrainConfig,
    )
    from srsem_torch.models.global_models import (
        conv_head_from_stats,
        squared_diffs,
    )
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.train import diffcache, multisweep, statcache
    from srsem_torch.train.loop import batch_to_device
    from srsem_torch.train.steps import masked_mse
    from srsem_torch.utils.convert import conv_head_from_params

    dev = torch.device(TRAIN_DEVICE)
    tower = clip_tower(torch, np)
    lap = Laps()
    launches = dict.fromkeys(BOTTLENECK, 0)

    def counted(call, passes: int):
        """``call()``, its launches added to the path's; they must be
        ``passes`` tower passes."""
        zero_launches(fb)
        out = call()
        got = read_launches(torch, fb)
        want = {k: passes * v for k, v in PASS_CALLS.items()}
        if got != want:
            raise AssertionError(f"sweeps path launched {got}, want {want} "
                                 f"({passes} tower passes)")
        for k, v in got.items():
            launches[k] += v
        return out

    bb = BackboneConfig(kind="resnet50_clip", image_size=IMAGE)
    cfg = GlobalModelConfig(backbone=bb, head="stages_cnn", depth=3)
    points = multisweep.depth_grid()
    kind = "resnet50_clip"
    union = sorted({n for p in points for n in p.tap_names(kind)})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_study(np, tmp)
        torch.save(tower, tmp / "tower.pt")
        t0 = time.perf_counter()
        batches = sweep_batches(np, N_SWEEP_PAIRS, 5)
        made_s = time.perf_counter() - t0
        n_train = N_SWEEP_PAIRS * 4 // 5
        train = batches[:n_train // TRAIN_BATCH]
        val = batches[n_train // TRAIN_BATCH:]

        # One cached step == one uncached step; one stat-cache step == one
        # diff-cache step (depth 3, the same init): the loss and the head's
        # gradients.
        tower_fn = multisweep.sweep_tower(cfg, tower, None, dev)
        head0 = multisweep.point_heads(points[2:], kind,
                                       torch.Generator().manual_seed(0))[0]
        names = points[2].tap_names(kind)
        one = diffcache.build_diff_cache(tower_fn, union, train[:1], dev)
        stats = statcache.build_stat_cache(tower_fn, names, train[:1], dev)
        a, b, y, mask = batch_to_device(train[0], dev)
        taps_a, taps_b = multisweep.pair_taps(tower_fn, a, b, names)
        inputs = {
            "uncached": lambda h: h(squared_diffs(taps_a, taps_b, names)),
            "cached": lambda h: h([one.diffs[n][0] for n in names]),
            "stats": lambda h: conv_head_from_stats(
                h, [stats.stats[n][0] for n in names])}
        stepped = {}
        for key, fwd in inputs.items():
            head = copy.deepcopy(head0).to(dev)
            loss = masked_mse(fwd(head), y, mask)
            loss.backward()
            stepped[key] = (float(loss.detach()), torch.cat([
                p.grad.reshape(-1) for p in head.parameters()]))
        step_errs = {
            key: {"loss_rel": abs(stepped[key][0] - stepped[ref][0])
                  / abs(stepped[ref][0]),
                  "grad_max_rel": float((stepped[key][1] - stepped[ref][1])
                                        .abs().max()
                                        / stepped[ref][1].abs().max())}
            for key, ref in (("cached", "uncached"), ("stats", "cached"))}
        if (step_errs["cached"]["loss_rel"] > 1e-6
                or step_errs["cached"]["grad_max_rel"] > 1e-6
                or step_errs["stats"]["loss_rel"] > 1e-5
                or step_errs["stats"]["grad_max_rel"] > 1e-5):
            raise AssertionError(f"cached steps: {step_errs}")
        del one, stats, taps_a, taps_b, stepped, tower_fn
        torch.cuda.empty_cache()
        lap("one_step_checks")

        # The four global paths over the whole split.
        def run(fn, epochs, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = counted(lambda: fn(points, cfg, TrainConfig(epochs=epochs),
                                     train, val, backbone_params=tower,
                                     device=dev, **kw),
                          len(train) + len(val))
            return out, time.perf_counter() - t, (
                torch.cuda.max_memory_allocated() - base)

        lines = {}
        shared, sec, _ = run(multisweep.train_global_sweep_shared_tower, 1)
        lines["shared_tower"] = {
            "epochs": 1, "seconds": sec,
            "train_pairs_per_s_all_points": n_train / sec,
            "results": [{k: r[k] for k in ("name", "train_loss", "val_srcc",
                                            "val_mse")} for r in shared]}
        tap_shapes = {n: (IMAGE >> (2 + i), IMAGE >> (2 + i), c)
                      for i, (n, c) in enumerate(zip(union, (256, 512, 1024,
                                                             2048)))}
        adam_train_mse = {}
        for key, fn in (("cached_diffs",
                         diffcache.train_global_sweep_cached_diffs),
                        ("cached_stats",
                         statcache.train_global_sweep_cached_stats)):
            run(fn, 0)  # warm: the first call's one-time costs
            _, built, _ = run(fn, 0)
            out, sec, peak = run(fn, SWEEP_EPOCHS)
            lines[key] = {
                "epochs": SWEEP_EPOCHS,
                "build_and_validation_seconds": built,
                "seconds": sec,
                # The epochs alone: the total less a warm run of none.
                "epochs_per_s_from_cache": SWEEP_EPOCHS / (sec - built),
                "peak_memory_over_resident_bytes": peak,
                "results": [{k: r[k] for k in ("name", "train_loss",
                                                "val_srcc", "val_mse")}
                            for r in out]}
            if key == "cached_diffs":
                lines[key]["cache_bytes_train_and_val"] = (
                    diffcache.estimate_cache_bytes(
                        tap_shapes, n_train + len(val) * TRAIN_BATCH,
                        torch.float32))
            else:
                heads = out
        # The Adam heads' train MSE (through the ReLU, on the stat cache)
        # against the closed form's.
        gen = torch.Generator().manual_seed(0)
        stat_tower = multisweep.sweep_tower(cfg, tower, gen, dev)
        train_stats = statcache.build_stat_cache(stat_tower, union, train,
                                                 dev)
        keep = train_stats.mask > 0
        for p, r in zip(points, heads):
            head = conv_head_from_params(r["head_params"]).to(dev)
            with torch.no_grad():
                pred = conv_head_from_stats(head, [
                    train_stats.stats[n] for n in p.tap_names(kind)])
            adam_train_mse[p.name] = float(
                ((pred - train_stats.y)[keep] ** 2).mean())
        solve_ms = {}
        for p in points:
            statcache.fit_conv_head_closed_form(train_stats,
                                                p.tap_names(kind))
            torch.cuda.synchronize()
            t = time.perf_counter()
            statcache.fit_conv_head_closed_form(train_stats,
                                                p.tap_names(kind))
            torch.cuda.synchronize()
            solve_ms[p.name] = (time.perf_counter() - t) * 1e3
        closed, sec, _ = run(statcache.solve_global_sweep_closed_form, 0)
        lines["closed_form"] = {
            "seconds": sec, "solve_ms": solve_ms,
            "stat_cache_bytes_train_and_val": 4 * 3840 * (
                n_train + len(val) * TRAIN_BATCH),
            "results": [{k: r[k] for k in ("name", "train_loss", "val_srcc",
                                            "val_mse")} for r in closed]}
        worse = {r["name"]: (r["train_loss"], adam_train_mse[r["name"]])
                 for r in closed
                 if r["train_loss"] > adam_train_mse[r["name"]]}
        if worse:
            raise AssertionError(f"closed-form train MSE above Adam's: "
                                 f"{worse}")
        for key, line in lines.items():
            emit("sweeps", step=key, batch=TRAIN_BATCH, card=card,
                 train_pairs=n_train, val_pairs=N_SWEEP_PAIRS - n_train,
                 **line)
        del train_stats, stat_tower
        torch.cuda.empty_cache()
        lap("global_sweeps")

        # train-clu's fast paths at batch 80 (the CLI, host decode
        # included).
        common = [str(tmp / "pairs.csv"), "--backbone-checkpoint",
                  str(tmp / "tower.pt")]
        cli = {}
        for key, extra in (("cached_diffs", ["--cached-diffs", "--train-set",
                                             "epochs=1"]),
                           ("thresholds", ["--thresholds", "none", "0.4",
                                           "0.9", "--train-set",
                                           "epochs=1"])):
            t = time.perf_counter()
            out = counted(lambda: cli_json([
                "train-clu", *common, *extra, "--checkpoint-dir",
                str(tmp / f"ck_{key}")]), CLU_CLI_PASSES)
            cli[key] = {"seconds": time.perf_counter() - t, "result": out}
        rows = cli["thresholds"]["result"]
        if ([r["name"] for r in rows] != ["threshold-None", "threshold-0.4",
                                          "threshold-0.9"]
                or not all(np.isfinite(r["val_mse"]) for r in rows)
                or not np.isfinite(cli["cached_diffs"]["result"]["train_loss"])
                or not all((tmp / "ck_thresholds" / r["name"]).is_dir()
                           for r in rows)):
            raise AssertionError(f"train-clu fast paths: {cli}")
        emit("sweeps", step="train_clu_cli", batch=CLU_TRAIN_BATCH, card=card,
             pairs=N_CLU_ROWS, **cli)
        lap("train_clu_cli")
    emit("sweeps", step="checks", card=card, launches=launches,
         seconds=lap.seconds,
         cached_vs_uncached_and_stats_vs_diffs_one_step=step_errs,
         closed_form_vs_adam_train_mse={
             r["name"]: {"closed_form": r["train_loss"],
                         "adam": adam_train_mse[r["name"]]} for r in closed},
         seconds_to_make_the_300_pairs=made_s,
         tolerance="cached vs uncached 1e-6, stats vs diffs 1e-5 (loss "
                   "relative; head gradients relative to their max)")
    return launches


def vit_model(torch, np, cfg, seed: int = 0):
    """Full-width ViT GlobalPairScorer with seeded weights (the Flax-like
    init: LeCun-normal kernels, normal(0, 0.02) tokens) and a live head:
    nonnegative weights, biases +1."""
    from srsem_torch.models.global_models import make_global_model

    model = make_global_model(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in dict.fromkeys(model.aggregator.linears()):
            layer.weight.abs_()
            layer.bias.add_(1.0)
    return model


# The profile's groups: the aten operations whose kernels each holds.
VIT_GEMMS = ("aten::addmm", "aten::mm", "aten::cudnn_convolution",
             "aten::convolution", "aten::_convolution")
VIT_ATTENTION = ("aten::bmm", "aten::_softmax", "aten::softmax")


def profile_vit(torch, fn, reps: int = 3) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: the device's busy
    share of the host wall time (the union of the device events) and
    device ms a call by group: the GEMMs (the Linears and the patch conv),
    attention (its batched matrix products and softmax), copies and casts
    (``aten::copy_``: the host-to-device copy and the dtype casts), other
    elementwise operations, and the head kernel (no aten operation: it is
    launched through ctypes, so its time comes from its own events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, head_us = [], 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if "fused_head" in e.name:
                head_us += e.time_range.end - e.time_range.start
    if not spans:
        return {"busy_share": None, "note": "the profiler saw no device "
                "events: device time not measured"}
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy, last = busy + end - start, end
        elif end > last:
            busy, last = busy + end - last, end
    groups = {"GEMMs": 0.0, "attention": 0.0, "copies and casts": 0.0,
              "other elementwise": 0.0, "head kernel": head_us / reps / 1e3}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or not e.key.startswith("aten::"):
            continue
        g = ("GEMMs" if e.key in VIT_GEMMS else
             "attention" if e.key in VIT_ATTENTION else
             "copies and casts" if e.key == "aten::copy_" else
             "other elementwise")
        groups[g] += us / reps / 1e3
    return {"batches": reps, "wall_ms_per_batch": wall_us / reps / 1e3,
            "device_busy_ms_per_batch": busy / reps / 1e3,
            "busy_share": busy / wall_us, "idle_share": 1 - busy / wall_us,
            "device_ms_per_batch_by_group": groups}


def run_vit(torch, np, card: str):
    """Phase 12 (vit): stages_vit on the full-width CLIP ViT-B/16 (224 px,
    bf16 tower, float32 taps), seeded weights: the tower written as a timm
    state dict, converted by ``convert --kind clip_vit`` and read back by
    ``score --backbone-checkpoint`` (subprocesses); score_paths with the
    launch counts reset just before and read just after (one head launch
    a batch, no bottleneck launch); float32 kernel path against the plain
    module; score_arrays pairs/s at batch 64 and a profile; the grouped
    scorer at G = 16, K = 4 (pairs/s, float32 against pairwise) and
    ``score-groups --set head=wperlay_vit --set depth=11``; one frozen and
    one enc_ft train step at batch 5; the plain attention against
    ``F.scaled_dot_product_attention`` (a yardstick the port never
    calls).  Returns {kernel: launches in the score_paths run}."""
    import dataclasses
    import shutil

    import torch.nn.functional as F

    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.eval.grouped import GroupedPairScorer
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_head as fh
    from srsem_torch.train.loop import batch_to_device, build_training
    from srsem_torch.train.partition import trainable_predicate

    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="vit_clip", image_size=224, compute_dtype="bfloat16"),
        head="stages_vit", depth=3)
    cfg32 = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, compute_dtype="float32"))
    model = vit_model(torch, np, cfg)
    scorer = PairScorer(cfg, model, batch_size=BATCH)
    if scorer.fused_tower or len(model.tap_names) != 4:
        raise AssertionError(f"vit scorer: fused tower {scorer.fused_tower},"
                             f" taps {model.tap_names}")
    zero_launches(fb)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The tower as a timm-layout state dict, through convert, read back
        # by the score CLI; the converted file holds the same bits.
        sd = {k: v.detach().cpu() for k, v in model.backbone.state_dict().items()}
        sd["head.weight"] = torch.zeros(512, 768)  # timm's, dropped
        torch.save(sd, tmp / "vit.pt")
        proc = subprocess.run(
            [sys.executable, "-m", "srsem_torch", "convert", str(tmp / "vit.pt"),
             "--kind", "clip_vit", "--out", str(tmp / "vit.msgpack")],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"convert exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        from srsem_torch.backbones.vit import ClipViT
        from srsem_torch.cli.main import _load_backbone

        back = ClipViT(dtype=torch.bfloat16)
        _load_backbone(back, "vit_clip", tmp / "vit.msgpack")
        for k, v in back.state_dict().items():
            if not torch.equal(v, sd[k]):
                raise AssertionError(f"converted tower differs at {k}")
        emit("vit", step="convert", result=json.loads(
            proc.stdout.strip().splitlines()[-1]))

        pairs = write_pairs(np, tmp, 8)
        fh.fused_global_score.launches = 0
        zero_launches(fb)
        t0 = time.perf_counter()
        scores = scorer.score_paths(pairs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fused_stage_score": fh.fused_global_score.launches}
        bottleneck = read_launches(torch, fb)
        batches = -(-len(pairs) // BATCH)
        nan = np.isnan(scores)
        if not (nan[-1] and not nan[:-1].any() and (scores[:-1] > 0).all()):
            raise AssertionError(f"vit score_paths: want NaN on exactly the "
                                 f"corrupt last row, got {scores.tolist()}")
        if launches["fused_stage_score"] != batches or any(bottleneck.values()):
            raise AssertionError(f"vit path launched {launches} and "
                                 f"{bottleneck} in {batches} batches")
        emit("vit", step="score_paths", pairs=len(pairs), seconds=seconds,
             scores=[float(x) for x in scores], launches=launches,
             bottleneck_launches=bottleneck, batches=batches)

        # float32 kernel path (module tower, head kernel) vs the module.
        decode = scorer.preprocess.decode_uint8
        a = np.stack([decode(p[0]) for p in pairs[:-1]])
        b = np.stack([decode(p[1]) for p in pairs[:-1]])
        model32 = vit_model(torch, np, cfg32)
        got = PairScorer(cfg32, model32, batch_size=BATCH).score_arrays(a, b)
        pre = scorer.preprocess
        with torch.inference_mode():
            want = model32.cuda()(pre.device_normalize(torch.tensor(a).cuda()),
                                  pre.device_normalize(torch.tensor(b).cuda()))
        rel = float(((got - want).abs() / want.abs()).max())
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"vit f32 kernel path vs module: max rel "
                                 f"err {rel} beyond 1e-3")
        emit("vit", step="f32_kernel_path_vs_plain_module", max_rel_err=rel,
             tolerance="rtol=atol=1e-3", scores=got.tolist())

        # Throughput of score_arrays at batch 64, bf16, and a profile.
        rng = np.random.default_rng(2)
        a64 = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        b64 = np.clip(a64.astype(int) + rng.integers(-20, 21, a64.shape), 0,
                      255).astype(np.uint8)
        for _ in range(2):
            scorer.score_arrays(a64, b64)
        torch.cuda.synchronize()
        reps = 5
        fh.fused_global_score.launches = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = scorer.score_arrays(a64, b64)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        if not torch.isfinite(out).all() or \
                fh.fused_global_score.launches != reps:
            raise AssertionError("vit score_arrays at batch 64: not finite, "
                                 "or not one head launch a batch")
        emit("vit", step="score_arrays_throughput", batch=BATCH,
             dtype="bfloat16", image=224, ms_per_batch=dt * 1e3,
             pairs_per_s=BATCH / dt, head_launches_per_batch=1, card=card)
        emit("vit", step="profile", card=card, **profile_vit(
            torch, lambda: scorer.score_arrays(a64, b64)))

        # The grouped scorer: one head launch a batch, 80 tower images for
        # 64 pairs; float32 grouped against pairwise.
        gt = a64[:GROUP_G]
        sr = np.clip(gt[:, None].astype(int) + rng.integers(
            -20, 21, (GROUP_G, GROUP_K, 224, 224, 3)), 0, 255).astype(np.uint8)
        grouped = GroupedPairScorer(cfg, model, k=GROUP_K, batch_size=GROUP_G,
                                    pairs=scorer)
        for _ in range(2):
            grouped.score_arrays(gt, sr)
        torch.cuda.synchronize()
        fh.fused_grouped_score.launches = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            gout = grouped.score_arrays(gt, sr)
        torch.cuda.synchronize()
        gdt = (time.perf_counter() - t0) / reps
        if fh.fused_grouped_score.launches != reps or \
                not torch.isfinite(gout).all():
            raise AssertionError("vit grouped: not one head launch a batch, "
                                 "or not finite")
        got = GroupedPairScorer(cfg32, model32, k=GROUP_K,
                                batch_size=GROUP_G).score_arrays(gt, sr)
        want = PairScorer(cfg32, model32, batch_size=GROUP_G * GROUP_K
                          ).score_arrays(np.repeat(gt, GROUP_K, axis=0),
                                         sr.reshape(-1, 224, 224, 3))
        err = float((got.reshape(-1) - want).abs().max())
        if not torch.allclose(got.reshape(-1), want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"vit f32 grouped vs pairwise: max |err| "
                                 f"{err} beyond rtol=atol=1e-4")
        emit("vit", step="grouped", g=GROUP_G, k=GROUP_K, dtype="bfloat16",
             ms_per_batch=gdt * 1e3, pairs_per_s=GROUP_G * GROUP_K / gdt,
             head_launches_per_batch=1, f32_vs_pairwise_max_abs_err=err,
             tolerance="rtol=atol=1e-4", card=card)
        del model32

        # score-groups with wperlay_vit at depth 11 (12 taps, one launch),
        # K = 2 SR folders, one corrupt SR file.
        root = tmp / "groups"
        dirs = [root / n for n in ("gt", "esrgan", "swinir")]
        for d in dirs:
            d.mkdir(parents=True)
        for i, (pa, pb) in enumerate(pairs[:3]):
            shutil.copy(pa, dirs[0] / f"im{i}.png")
            shutil.copy(pb, dirs[1] / f"im{i}.jpg")
            shutil.copy(pb, dirs[2] / f"im{i}.jpg")
        shutil.copy(pairs[-1][1], dirs[2] / "im1.jpg")
        for cmd, extra, key, want_nan in (
                ("score-groups", [*map(str, dirs), "--set", "head=wperlay_vit",
                                  "--set", "depth=11"], "nan_groups", 1),
                ("score", [str(tmp / "pairs.csv"), "--set", "head=stages_vit"],
                 "nan", 1)):
            if cmd == "score":
                (tmp / "pairs.csv").write_text(
                    "img_a_pth,img_b_pth\n"
                    + "".join(f"{x},{y}\n" for x, y in pairs))
            proc = subprocess.run(
                [sys.executable, "-m", "srsem_torch", cmd, *extra,
                 "--backbone", "vit_clip", "--backbone-checkpoint",
                 str(tmp / "vit.msgpack"), "--batch-size", "8", "--out",
                 str(tmp / f"{cmd}.csv")],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"{cmd} exit {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            result = json.loads(proc.stdout.strip().splitlines()[-1])
            if result[key] != want_nan:
                raise AssertionError(f"{cmd} result {result}")
            emit("vit", step=f"cli_{cmd}", result=result)

    # One frozen and one enc_ft train step at batch 5 (the tower as the
    # module: under no_grad, or trained under autograd).
    dev = torch.device("cuda")
    batch = host_batch(np, TRAIN_BATCH, False, 11)
    for enc_ft in (False, True):
        tcfg = dataclasses.replace(cfg, enc_ft=enc_ft)
        tmodel = vit_model(torch, np, tcfg, seed=3)
        steps = build_training(tmodel, False, trainable_predicate(
            enc_ft=enc_ft), 1e-4, dev)[0]
        step = lambda: steps.train_step(*batch_to_device(batch, dev))  # noqa: E731
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(step()) for _ in range(3)]
        torch.cuda.synchronize()
        sdt = (time.perf_counter() - t0) / 3
        if not all(np.isfinite(losses)) or any(read_launches(torch, fb).values()):
            raise AssertionError(f"vit train step: losses {losses}, "
                                 "or a bottleneck launch")
        emit("vit", step="train_step", enc_ft=enc_ft, batch=TRAIN_BATCH,
             ms_per_step=sdt * 1e3, pairs_per_s=TRAIN_BATCH / sdt,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             losses=losses, card=card)
        del tmodel, steps

    # Yardstick: the port's plain attention against one fused PyTorch call
    # on the same q, k, v (bf16, a batch's 128 images, 12 heads).
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2 * BATCH, 12, VIT_TOKENS[0], 64, device=dev,
                           generator=g, dtype=torch.bfloat16)
               for _ in range(3))

    def plain_attention():
        s = (q @ k.transpose(-1, -2)) / 8.0
        return torch.softmax(s.float(), dim=-1).to(q.dtype) @ v

    err = float((plain_attention().float() - F.scaled_dot_product_attention(
        q, k, v).float()).abs().max())
    flops = 4 * q.shape[0] * 12 * VIT_TOKENS[0] ** 2 * 64
    bms, by = bound(4 * q.numel() * 2, flops, BF16_TC_FLOPS)
    emit("vit", step="attention_yardstick", shape=list(q.shape),
         plain_ms=cuda_ms(torch, plain_attention, 10),
         sdpa_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
             q, k, v), 10), bound_ms=bms, bound_by=by, max_abs_diff=err,
         layers_per_pass=12, card=card)
    return launches


# The iqa path: folder-metrics over IQA_PAIRS pairs at batch IQA_BATCH;
# the text path: N_CAPTIONS captions (each in one of N_CAPTIONS / 2
# pairs), then C2I_IMAGES images (one corrupt) at batch C2I_BATCH.
IQA_PAIRS, IQA_BATCH = 64, 32
RATE_WINDOW_S = 5.0  # the least window a steady-state rate is timed over
N_CAPTIONS, C2I_IMAGES, C2I_BATCH = 2048, 128, 64
_WORK: dict = {}


def work_dir() -> Path:
    """A temporary directory the nr_train, iqa and text phases share (the
    iqa phase scores with the nr_train phase's checkpoint), removed when
    the process exits."""
    if not _WORK:
        _WORK["dir"] = tempfile.TemporaryDirectory()
    return Path(_WORK["dir"].name)


def smooth_images(np, n: int, size: int, seed: int):
    """``n`` smooth uint8 images (bicubic upsampling of 8x8 noise)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [np.asarray(Image.fromarray(
        rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).resize(
        (size, size), Image.BICUBIC)) for _ in range(n)]


def run_nr_train(torch, np, card: str):
    """Phase 13 (nr_train): ``train-nr-iqa`` at its defaults (224 px,
    batch 8, lr 1e-3, float32 tower) for one epoch over NR_IMAGES images:
    three train steps and one validation batch, one tower pass each, with
    the launch counts reset just before and read just after (the
    nr_train path).  Its checkpoint (the head, the tower seed, the port's
    tower marker) serves the iqa phase.  ms a train step: the difference
    of a four-epoch and a one-epoch ``train_nr_iqa`` over nine steps
    (degrade, normalize, tower, head, Adam; the host's batch copy).  Card
    check: the float32 GAP features and scores through the kernel tower
    against the module tower (TF32 off, 1e-3 of the largest).  Returns
    the path's launches."""
    from PIL import Image

    from srsem_torch.backbones.resnet import IMAGENET_STAGE_TAPS
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.train.checkpoint import restore_checkpoint
    from srsem_torch.train.nr_iqa import (
        load_nr_iqa_head,
        normalize_imagenet,
        train_nr_iqa,
    )

    dev = torch.device(TRAIN_DEVICE)
    folder = work_dir() / "nr_images"
    folder.mkdir()
    for i, img in enumerate(smooth_images(np, NR_IMAGES, 256, 21)):
        Image.fromarray(img).save(folder / f"{i:04d}.png")
    ck = work_dir() / "nr_ckpt"
    zero_launches(fb)
    t0 = time.perf_counter()
    out = cli_json(["train-nr-iqa", str(folder), "--checkpoint-dir", str(ck),
                    "--epochs", "1"])
    launches = read_launches(torch, fb)
    seconds = time.perf_counter() - t0
    raw = restore_checkpoint(str(ck))
    want = {k: NR_PASSES * v for k, v in PASS_CALLS.items()}
    if (launches != want or out["steps"] != NR_PASSES - 1
            or not np.isfinite([out["final_loss"], out["val_mse"]]).all()
            or raw.get("tower_init") != "torch"):
        raise AssertionError(f"train-nr-iqa: {out}, launched {launches} "
                             f"(want {want}), checkpoint keys {sorted(raw)}")
    emit("nr_train", step="train_nr_iqa_cli", batch=NR_BATCH,
         images=NR_IMAGES, result=out, seconds=seconds, launches=launches,
         checkpoint_keys=sorted(raw), card=card)
    _WORK["nr_ckpt"] = ck

    imgs = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (IMAGE, IMAGE), Image.BICUBIC), np.float32) / 255.0
        for p in sorted(folder.iterdir())])
    took = {}
    for epochs in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_nr_iqa(imgs, epochs=epochs, batch_size=NR_BATCH,
                           device=dev)
        torch.cuda.synchronize()
        took[epochs] = time.perf_counter() - t0
    steps = 3 * (NR_PASSES - 1)
    ms = (took[4] - took[1]) / steps * 1e3
    if not np.isfinite(res.losses + [res.val_mse]).all():
        raise AssertionError(f"train_nr_iqa losses {res.losses}")
    emit("nr_train", step="throughput", batch=NR_BATCH, ms_per_train_step=ms,
         images_per_s=NR_BATCH / ms * 1e3, seconds=took,
         losses=res.losses, val_mse=res.val_mse, card=card)

    model = load_nr_iqa_head(str(ck), torch.float32).to(dev).eval()
    x = normalize_imagenet(torch.from_numpy(imgs[:NR_BATCH]).to(dev))
    with torch.no_grad():
        got = model.features(x)
        _, taps = model.backbone(x)
        plain = torch.cat([taps[n].float().mean(dim=(1, 2))
                           for n in IMAGENET_STAGE_TAPS], dim=-1)
        errs = {"features": float((got - plain).abs().max()),
                "scores": float((model.head(got) - model.head(plain))
                                .abs().max())}
        scale = {"features": float(plain.abs().max()),
                 "scores": float(model.head(plain).abs().max())}
    if any(errs[k] > 1e-3 * max(scale[k], 1.0) for k in errs):
        raise AssertionError(f"f32 NR-IQA kernel tower vs module: {errs} "
                             f"(scale {scale})")
    emit("nr_train", step="f32_kernel_vs_module_tower", max_abs_err=errs,
         scale=scale, tolerance="1e-3 of max(largest value, 1)")
    return launches


def iqa_folders(np, root: Path, n: int, seed: int):
    """GT (JPEG, 256x240) and SR (PNG: the GT with noise) folders of ``n``
    pairs; returns (gt_dir, sr_dir)."""
    from PIL import Image

    gt, sr = root / "gt", root / "sr"
    gt.mkdir(parents=True)
    sr.mkdir()
    rng = np.random.default_rng(seed)
    for i, img in enumerate(smooth_images(np, n, 256, seed)):
        img = img[:, :240]
        noisy = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
        Image.fromarray(img).save(gt / f"{i:04d}.jpg", quality=90)
        Image.fromarray(noisy.astype(np.uint8)).save(sr / f"{i:04d}.png")
    return gt, sr


def steady_rate(torch, fn, items: int):
    """Items a second of ``fn`` (one call handles ``items``) in the steady
    state, its set-up and first call outside the window: one warm call,
    then calls until RATE_WINDOW_S seconds have passed.  Returns (rate,
    calls, seconds)."""
    fn()
    torch.cuda.synchronize()
    calls, t0 = 0, time.perf_counter()
    while True:
        fn()
        calls += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if seconds >= RATE_WINDOW_S:
            return items * calls / seconds, calls, seconds


def run_iqa(torch, np, card: str):
    """Phase 14 (iqa): ``folder-metrics`` over IQA_PAIRS pairs (resized to
    224) at batch 32 with LPIPS alex (seeded) and the NR-IQA head of the
    nr_train phase's checkpoint (bf16 tower, two passes of 32 eval
    images), then ``run_folder_sweep`` with ``make_pyramid_lpips()`` (two
    2N = 64 tower passes); the launch counts reset just before the first
    and read just after the second (the iqa path).  Those runs' seconds
    include the CLI's set-up; the pairs/s are the steady state's
    (``steady_rate``) of an ``ImageQualityMetrics`` built once (its
    set-up timed apart) over the same pairs, with each metric.  Card
    checks: every row finite, SSIM in (-1, 1]; on four pairs the float32
    columns on the card (TF32 off) against the CPU's plain path (1e-3 +
    1e-3·|x|), the NR head in float32, and the pyramid distance on a
    float32 copy of its tower (1e-3·|x| + 1e-9: the distances are about
    1e-4); a corrupt SR file a NaN row (an uncounted run).  Returns the
    path's launches."""
    from PIL import Image

    from srsem_torch.backbones.resnet import ImageNetResNet50
    from srsem_torch.eval.folder_metrics import (
        CSV_COLUMNS,
        METRIC_COLUMNS,
        ImageQualityMetrics,
        make_pyramid_lpips,
        read_metrics_csv,
        run_folder_sweep,
    )
    from srsem_torch.eval.nr_iqa import NrIqaScorer
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.train.nr_iqa import load_nr_iqa_head

    dev = torch.device(TRAIN_DEVICE)
    ck = str(_WORK["nr_ckpt"])
    gt, sr = iqa_folders(np, work_dir() / "iqa", IQA_PAIRS, 22)
    t0 = time.perf_counter()
    pyramid = make_pyramid_lpips(device=dev)
    setup = {"pyramid": time.perf_counter() - t0}
    zero_launches(fb)
    t0 = time.perf_counter()
    out = cli_json(["folder-metrics", str(gt), str(sr), "--batch-size",
                    str(IQA_BATCH), "--koniqpp-checkpoint", ck])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    t0 = time.perf_counter()
    swept = run_folder_sweep(str(gt), [str(sr)], ImageQualityMetrics(
        batch_size=IQA_BATCH, lpips_fn=pyramid, device=dev),
        csv_name="metrics_pyramid.csv")
    torch.cuda.synchronize()
    t_pyr = time.perf_counter() - t0
    launches = read_launches(torch, fb)
    rows = read_metrics_csv(str(sr / "metrics.csv"))
    prow = swept[str(sr)]
    bad = [r["image_name"] for r in rows
           if not all(np.isfinite(r[c]) for c in METRIC_COLUMNS)]
    bad += [r["image_name"] for r in prow
            if not all(np.isfinite(r[c]) for c in ("SSIM", "PSNR", "LPIPS"))]
    if (out != {str(sr): IQA_PAIRS} or len(prow) != IQA_PAIRS or bad
            or not all(-1 < r["SSIM"] <= 1 for r in rows)
            or list(rows[0]) != list(CSV_COLUMNS)):
        raise AssertionError(f"folder-metrics: {out}, non-finite rows {bad}")

    gps = [r["gt_path"] for r in rows]
    sps = [r["eval_path"] for r in rows]
    t0 = time.perf_counter()
    calc = ImageQualityMetrics(batch_size=IQA_BATCH, koniqpp=NrIqaScorer(
        load_nr_iqa_head(ck), device=dev), device=dev)
    setup["alex_and_nr"] = time.perf_counter() - t0
    rate, calls, secs = steady_rate(torch, lambda: calc.batch(gps, sps),
                                    IQA_PAIRS)
    calc = ImageQualityMetrics(batch_size=IQA_BATCH, lpips_fn=pyramid,
                               device=dev)
    prate, pcalls, psecs = steady_rate(torch, lambda: calc.batch(gps, sps),
                                       IQA_PAIRS)
    emit("iqa", step="folder_metrics", pairs=IQA_PAIRS, batch=IQA_BATCH,
         cli_seconds_with_setup=t_cli, pyramid_sweep_seconds=t_pyr,
         setup_seconds=setup, pairs_per_s=rate, pairs_timed=IQA_PAIRS * calls,
         seconds_timed=secs, pyramid_pairs_per_s=prate,
         pyramid_pairs_timed=IQA_PAIRS * pcalls, pyramid_seconds_timed=psecs,
         launches=launches, means={c: float(np.mean([r[c] for r in rows]))
                                   for c in METRIC_COLUMNS},
         pyramid_lpips_mean=float(np.mean([r["LPIPS"] for r in prow])),
         card=card)

    # Four pairs in float32: the card against the CPU's plain path.
    gps, sps = gps[:4], sps[:4]
    got = [ImageQualityMetrics(batch_size=4, koniqpp=NrIqaScorer(
        load_nr_iqa_head(ck, torch.float32), device=where),
        device=where).batch(gps, sps) for where in (TRAIN_DEVICE, "cpu")]
    worst = 0.0
    for a, b in zip(*got):
        for c in METRIC_COLUMNS:
            err = abs(a[c] - b[c])
            worst = max(worst, err)
            if not err <= 1e-3 + 1e-3 * abs(b[c]):
                raise AssertionError(f"iqa f32 card vs CPU {c}: {a[c]} vs "
                                     f"{b[c]}")
    tower32 = ImageNetResNet50(torch.float32)
    tower32.load_state_dict(pyramid.model.state_dict())
    pair = [torch.from_numpy(np.stack([np.asarray(Image.open(p).convert(
        "RGB").resize((IMAGE, IMAGE), Image.BICUBIC), np.float32) / 255.0
        for p in paths])) for paths in (gps, sps)]
    on_card, ref = (make_pyramid_lpips(copy.deepcopy(tower32),
                                       device=where)(*pair).cpu().numpy()
                    for where in (TRAIN_DEVICE, "cpu"))
    pyr_err = float(np.abs(on_card - ref).max())
    if not (np.abs(on_card - ref) <= 1e-3 * np.abs(ref) + 1e-9).all():
        raise AssertionError(f"pyramid f32 card vs CPU: {on_card} vs {ref}")
    # A corrupt SR file: its row NaN, the only one.
    (sr / "0001.png").write_bytes(b"not a png")
    nan_rows = [i for i, r in enumerate(ImageQualityMetrics(
        batch_size=4, device=dev).batch(gps, sps))
        if all(np.isnan(v) for v in r.values())]
    if nan_rows != [1]:
        raise AssertionError(f"corrupt SR: NaN rows {nan_rows}, want [1]")
    emit("iqa", step="f32_card_vs_cpu", pairs=4, max_abs_err=worst,
         tolerance="1e-3 + 1e-3*|x|", pyramid=ref.tolist(),
         pyramid_max_abs_err=pyr_err, pyramid_tolerance="1e-3*|x| + 1e-9",
         corrupt_row_nan=True)
    return launches


class ClipTextEmbedder:
    """The dual encoder's text tower behind the embedder interface."""

    def __init__(self, dual):
        self.dual, self.device = dual, dual.device

    def encode(self, texts):
        return self.dual.encode_text(list(texts)).float().cpu().numpy()


def write_vocab(np, root: Path, words: list) -> Path:
    """A BERT-layout vocab.txt of 30,522 entries: [PAD], unused slots, the
    specials at 100-103, ``words``, then filler pieces."""
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    vocab += [f"##p{i}" for i in range(30522 - len(vocab))]
    path = root / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    return path


def run_text(torch, np, card: str):
    """Phase 15 (text): ``score_caption_pairs`` over N_CAPTIONS captions
    (N_CAPTIONS / 2 pairs, each caption in one) through a seeded
    full-width MiniLMEmbedder (6 layers, 384; batch 256, 128 tokens) with
    the port's WordPieceTokenizer on a vocab.txt written here;
    ``embed_image_folder`` over C2I_IMAGES images (one corrupt: its row
    NaN) at batch 64 through ClipDualEncoder's seeded CLIP ResNet-50 (224,
    bf16; two tower passes of 64); ``score_c2i`` with the dual encoder's
    seeded full-width CLIP text tower (12 layers, 512) on a
    ClipBpeTokenizer over a merges file written here.  The launch counts
    are reset just before the caption pairs and read just after the C2I
    scores (the text path).  captions/s and images/s are the steady
    state's (``steady_rate``) over the same captions and folder, the
    models' set-up timed apart.  Card checks: the
    cosines finite in [-1, 1]; 16 captions' MiniLM embeddings and 4
    images' float32 C2I embeddings against the CPU's (1e-3 of the
    largest).  Returns the path's launches."""
    from PIL import Image

    from srsem_torch.backbones.resnet import make_backbone, reset_tower
    from srsem_torch.config import BackboneConfig
    from srsem_torch.data.preprocess import Preprocess
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.pseudo.clip_text import ClipDualEncoder
    from srsem_torch.pseudo.scoring import (
        embed_image_folder,
        score_c2i,
        score_caption_pairs,
    )
    from srsem_torch.pseudo.text_embed import MiniLMEmbedder, MiniLMEncoder
    from srsem_torch.pseudo.tokenizer import (
        ClipBpeTokenizer,
        WordPieceTokenizer,
    )

    dev = torch.device(TRAIN_DEVICE)
    root = work_dir() / "text"
    root.mkdir()
    rng = np.random.default_rng(23)
    syll = ["ka", "lo", "mi", "ne", "su", "ra", "to", "vi", "be", "do"]
    words = sorted({"".join(rng.choice(syll, rng.integers(1, 4)))
                    for _ in range(3000)})
    tok = WordPieceTokenizer(str(write_vocab(np, root, words)))
    captions = {f"c{i}": " ".join(rng.choice(words + ["zzq", "photo,"],
                                              rng.integers(8, 40)))
                for i in range(N_CAPTIONS)}
    keys = list(captions)
    pairs = list(zip(keys[0::2], keys[1::2]))
    t0 = time.perf_counter()
    minilm = MiniLMEncoder().reset_parameters(torch.Generator().manual_seed(8))
    embedder = MiniLMEmbedder(minilm, tok, device=dev)
    setup = {"minilm": time.perf_counter() - t0}

    folder = root / "images"
    folder.mkdir()
    for i, img in enumerate(smooth_images(np, C2I_IMAGES - 1, 256, 24)):
        Image.fromarray(img).save(folder / f"{i:04d}.jpg", quality=90)
    (folder / "9999.png").write_bytes(b"not a png")
    merges = root / "merges.txt"
    merges.write_text("#version: toy\n" + "\n".join(
        f"{a} {b}" for a, b in (("k", "a"), ("l", "o"), ("m", "i"),
                                ("ka", "lo</w>"), ("n", "e</w>"))) + "\n")
    t0 = time.perf_counter()
    tower = make_backbone(BackboneConfig(kind="resnet50_clip",
                                         image_size=IMAGE))
    reset_tower(tower, torch.Generator().manual_seed(9))
    randomize_bn(torch, np, tower, np.random.default_rng(9))
    dual = ClipDualEncoder(tower, tokenizer=ClipBpeTokenizer(str(merges)),
                           device=dev)
    dual.init_text(torch.Generator().manual_seed(10))
    setup["clip_dual"] = time.perf_counter() - t0
    pre = Preprocess.for_backbone("resnet50_clip", IMAGE)
    c2i_caps = {f"{i:04d}": captions[keys[i]] for i in range(C2I_IMAGES)}

    zero_launches(fb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cos = score_caption_pairs(captions, pairs, embedder)
    t_c2c = time.perf_counter() - t0
    t0 = time.perf_counter()
    embs = embed_image_folder(dual, str(folder), pre, batch_size=C2I_BATCH)
    torch.cuda.synchronize()
    t_img = time.perf_counter() - t0
    c2i = score_c2i(c2i_caps, embs, ClipTextEmbedder(dual))
    launches = read_launches(torch, fb)
    want = {k: 2 * v for k, v in PASS_CALLS.items()}
    c2i_vals = np.array([c2i[k] for k in c2i if k != "9999"])
    if (launches != want or cos.shape != (len(pairs),)
            or not (np.isfinite(cos).all() and np.abs(cos).max() <= 1 + 1e-5)
            or len(embs) != C2I_IMAGES or not np.isnan(embs["9999"]).all()
            or not np.isfinite(c2i_vals).all()
            or np.abs(c2i_vals).max() > 1 + 1e-5):
        raise AssertionError(f"text path: launched {launches} (want {want}), "
                             f"c2c {cos[:4]}, c2i {c2i_vals[:4]}")
    rate, calls, secs = steady_rate(
        torch, lambda: score_caption_pairs(captions, pairs, embedder),
        N_CAPTIONS)
    irate, icalls, isecs = steady_rate(
        torch, lambda: embed_image_folder(dual, str(folder), pre,
                                          batch_size=C2I_BATCH), C2I_IMAGES)
    emit("text", step="c2c_and_c2i", captions=N_CAPTIONS, pairs=len(pairs),
         setup_seconds=setup, first_c2c_seconds=t_c2c,
         first_c2i_seconds=t_img, captions_per_s=rate,
         captions_timed=N_CAPTIONS * calls, c2c_seconds_timed=secs,
         c2i_images=C2I_IMAGES, images_per_s=irate,
         images_timed=C2I_IMAGES * icalls, c2i_seconds_timed=isecs,
         launches=launches,
         c2c_mean=float(cos.mean()), c2i_mean=float(c2i_vals.mean()),
         card=card)

    # The CPU's plain path on a few inputs: MiniLM in float32, and the
    # C2I tower in float32 (TF32 off on the card).
    texts = [captions[k] for k in keys[:16]]
    cpu = MiniLMEmbedder(copy.deepcopy(minilm), tok, batch_size=16,
                         device="cpu").encode(texts)
    card_emb = MiniLMEmbedder(minilm, tok, batch_size=16,
                              device=dev).encode(texts)
    errs = {"minilm": float(np.abs(card_emb - cpu).max())}
    tower32 = make_backbone(BackboneConfig(kind="resnet50_clip",
                                           image_size=IMAGE,
                                           compute_dtype="float32"))
    tower32.load_state_dict(tower.state_dict())
    small = root / "small"
    small.mkdir()
    for i in range(4):
        (small / f"{i:04d}.jpg").write_bytes(
            (folder / f"{i:04d}.jpg").read_bytes())
    on_card, ref = (np.stack(list(embed_image_folder(
        ClipDualEncoder(copy.deepcopy(tower32), device=where), str(small),
        pre, batch_size=4).values())) for where in (TRAIN_DEVICE, "cpu"))
    errs["c2i"] = float(np.abs(on_card - ref).max())
    scale = {"minilm": 1.0, "c2i": float(np.abs(ref).max())}
    if any(errs[k] > 1e-3 * scale[k] for k in errs):
        raise AssertionError(f"text card vs CPU: {errs} (scale {scale})")
    emit("text", step="f32_card_vs_cpu", max_abs_err=errs, scale=scale,
         tolerance="1e-3 of the largest value")
    return launches


# Stack frame bytes of each head-kernel instance (dtype 0 f32, 1 bf16,
# 2 f16; KT SR images an item) at four stages (ptxas -v, H100 build of
# csrc/fused_head.cu before the limit went to 12).  Twelve stage
# descriptors in the __grid_constant__ parameters must not add to them,
# nor the fixed-channel step: each (dtype, KT) has an instance a step
# (HEAD_STEPS elements, a template parameter), held to the same frame.
HEAD_STACK_FRAMES = {(0, 1): 8, (0, 2): 0, (0, 4): 16, (0, 8): 8,
                     (1, 1): 0, (1, 2): 0, (1, 4): 16, (1, 8): 8,
                     (2, 1): 0, (2, 2): 0, (2, 4): 16, (2, 8): 8}
HEAD_STEPS = (2048, 1536)


def check_head_build(log: str) -> list:
    """Each fused_head_kernel instance's registers, stack frame and spills
    from nvcc's ``-Xptxas -v`` log; fails if a stack frame grew, or if the
    pairwise bf16 instance (1, 1) spills."""
    import re

    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"fused_head_kernelILi(\d)ELi(\d)ELi(\d+)E", line)
        if m and "entry function" in line:
            current = {"dtype": int(m.group(1)), "kt": int(m.group(2)),
                       "step": int(m.group(3))}
            out.append(current)
        elif current is not None and "bytes stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            current.update(stack=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
    if len(out) != len(HEAD_STACK_FRAMES) * len(HEAD_STEPS) or \
            {i["step"] for i in out} != set(HEAD_STEPS):
        raise AssertionError(f"head kernel instances in the ptxas log: {out}")
    for inst in out:
        key = (inst["dtype"], inst["kt"])
        if inst.get("stack", 1 << 30) > HEAD_STACK_FRAMES[key]:
            raise AssertionError(f"head instance {key} stack frame grew: "
                                 f"{inst}")
        if key == (1, 1) and (inst["spill_stores"] or inst["spill_loads"]):
            raise AssertionError(f"pairwise bf16 head instance spills: {inst}")
    return out


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
                                if any(k in ln for k in (
                                    "entry function", "registers", "spill"))]}
                  for n, b in built.items()},
         head_instances=(check_head_build(built["fused_head"].log)
                         if built["fused_head"].log else
                         "built before this run: no ptxas log"))

    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    summary = check_kernels(torch)
    seconds["kernels"] = time.perf_counter() - t0
    # Each path's launch counts, each from its own reset-then-run.
    runs = {}
    for path, fn in (("global", run_slice), ("clu", run_clu_slice),
                     ("wperlay", run_heads), ("serve", run_serve),
                     ("dual", run_dual), ("train", run_train),
                     ("finetune", run_finetune), ("sweeps", run_sweeps),
                     ("vit", run_vit), ("nr_train", run_nr_train),
                     ("iqa", run_iqa), ("text", run_text)):
        t0 = time.perf_counter()
        runs[path] = fn(torch, np, card)
        seconds[path] = time.perf_counter() - t0
    emit("timing", seconds=seconds)
    # The wperlay path's towers run the global path's bottleneck shapes
    # (the CLIP tower's stride-1 blocks are the ImageNet ones, batch 64).
    # The sweeps path's passes run the train path's tower shapes, timed
    # for it in check_kernels; the finetune path trains the tower as the
    # module and runs no kernel (its run checks that).
    for name in BOTTLENECK:
        summary[(name, "wperlay")] = summary[(name, "global")]
    del runs["finetune"]
    for path, launches in runs.items():
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            return fail(f"{path} path launched no {missing}")
        # The kernels line sums the times over one scored batch's launches
        # at each path's shapes; the run is one batch, so its counts must
        # be those launches.
        timed = {k: summary[(k, path)]["launches"] for k in launches}
        if timed != launches:
            return fail(f"{path} path launched {launches}, the times cover "
                        f"{timed}")

    meta = {
        "fused_stage_score": ("cuda", "srsem_torch/csrc/fused_head.cu",
                              "srsem/ops/fused_head.py:89"),
        "fused_bottleneck": ("cuda", "srsem_torch/csrc/fused_bottleneck.cu",
                             "srsem/ops/fused_bottleneck.py:123"),
        "fused_bottleneck_tiled": ("cuda",
                                   "srsem_torch/csrc/fused_bottleneck.cu",
                                   "srsem/ops/fused_bottleneck.py:276"),
        "fused_decoder_level": ("cuda", "srsem_torch/csrc/fused_decoder.cu",
                                "srsem/ops/fused_decoder.py:305"),
        "fused_decoder_level_tiled": ("cuda",
                                      "srsem_torch/csrc/fused_decoder.cu",
                                      "srsem/ops/fused_decoder.py:243"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        parts = {path: s for (k, path), s in summary.items() if k == name}
        total = lambda key: sum(s[key] for s in parts.values())  # noqa: E731
        by = {}
        for s in parts.values():
            for b, ms in s["by"].items():
                by[b] = by.get(b, 0.0) + ms
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(runs[p][name] for p in parts),
            "max_abs_err": max(s["max_abs_err"] for s in parts.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": max(by, key=by.get),
            "library_ms": total("library_ms"),
            "paths": {p: {"launches": runs[p][name],
                          **{k: s[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")}}
                      for p, s in parts.items()}})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
