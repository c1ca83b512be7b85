"""The port's kernels against their plain PyTorch versions on a CUDA card:
the head (csrc/fused_head.cu; conv and ViT token taps), the bottleneck and
the decoder level; a ViT PairScorer against its module; the
scoring service and the dual scorer on the card against the scorers they
share kernels with.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it runs where JAX is not installed, with the repo's
conftest (which pins JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

float32 comparisons run with TF32 off.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from compare_f32_conv import f64_bottleneck, f64_decoder
from srsem_torch.ops import fused_bottleneck as tfb
from srsem_torch.ops import fused_decoder as tfd
from srsem_torch.ops import fused_head as tfh
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture


REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(rng, c, wd, device):
    mk = lambda *s: torch.tensor(  # noqa: E731
        (rng.normal(size=s) / np.sqrt(s[0] if len(s) < 4 else 9 * s[2]))
        .astype(np.float32), device=device)
    return mk(c, wd), mk(wd) * 0.1, mk(3, 3, wd, wd), mk(wd) * 0.1, \
        mk(wd, c), mk(c) * 0.1


def _head_close(got, want):
    """The head's tolerance: 1e-5 + 1e-5 * max|want| (float32 sums of up
    to 10^6 terms in another order)."""
    tol = 1e-5 + 1e-5 * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 8, 8, 32), (2, 56, 56, 256),
                                   (5, 7, 7, 2048), (2, 9, 11, 40)])
def test_stage_score_kernel_matches_plain(cuda_device, dtype, shape):
    """csrc/fused_head.cu in its per-stage mode == plain version
    (multi-chunk, ragged chunks and C = 40 on the general path included),
    with b by value and as a tensor on the card; one launch a call, and two
    launches give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fa = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    fb = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(shape[-1], device=cuda_device, generator=g)
    before = tfh.fused_stage_score.launches
    got = tfh.fused_stage_score(fa, fb, w, 0.5)
    torch.cuda.synchronize()
    assert tfh.fused_stage_score.launches == before + 1
    want = tfh.plain_stage_sums(fa, fb, w) / (shape[1] * shape[2]) + 0.5
    _head_close(got, want)
    again = tfh.fused_stage_score(fa, fb, w, torch.tensor(0.5, device=cuda_device))
    assert torch.equal(got, again)


_HEAD_SHAPES = [(56, 56, 256), (9, 11, 40), (7, 7, 2048), (8, 8, 32)]


def _head(channels, device, seed=0):
    """A ConvHeadAggregator with nonnegative weights and biases +0.25, so
    the ReLU passes every score."""
    from srsem_torch.models.global_models import ConvHeadAggregator

    head = ConvHeadAggregator(channels)
    head.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in head.w_layers:
            layer.weight.abs_()
            layer.bias.fill_(0.25)
    return head.to(device)


def _check_head_kernel(stages, k, packed):
    """One launch of fused_global_score (K = 1) or fused_grouped_score ==
    the plain version; a second launch gives the same bits."""
    names = [f"s{j}" for j in range(len(stages))]
    taps_g = {n: gt for n, (gt, _) in zip(names, stages)}
    taps_s = {n: sr for n, (_, sr) in zip(names, stages)}
    wrapper = tfh.fused_global_score if k == 1 else tfh.fused_grouped_score
    before = wrapper.launches
    got = wrapper(taps_g, taps_s, packed, names)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = tfh.plain_grouped_score(taps_g, taps_s, packed, names)
    assert got.shape == ((want.shape[0],) if k == 1 else want.shape)
    assert bool((want > 0).all())
    _head_close(got.reshape(want.shape), want)
    assert torch.equal(wrapper(taps_g, taps_s, packed, names), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_head_kernel_matches_plain(cuda_device, dtype, k, s):
    """The whole head in one launch: S stages (the main path's 56x56x256
    and 7x7x2048, C = 40 on the general path, a one-chunk 8x8x32), K SR
    images a GT image (K = 8: the instance streaming the most)."""
    g = torch.Generator(device=cuda_device).manual_seed(s * 10 + k)
    shapes = _HEAD_SHAPES[:s]
    stages = [(torch.randn((2, *sh), device=cuda_device, generator=g)
               .abs().to(dtype),
               torch.randn((2 * k, *sh), device=cuda_device, generator=g)
               .abs().to(dtype)) for sh in shapes]
    packed = tfh.pack_head(_head([sh[-1] for sh in shapes], cuda_device))
    _check_head_kernel(stages, k, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernel_unaligned_slice(cuda_device, dtype):
    """Taps that are slices of a larger tensor, one element past a 16-byte
    boundary: the general path (the plan says so), K = 1 and 4."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    shapes = [(28, 28, 512), (7, 7, 2048)]

    def sliced(n, sh):
        flat = torch.randn(n * int(np.prod(sh)) + 1, device=cuda_device,
                           generator=g).abs().to(dtype)
        return flat[1:].view(n, *sh)

    packed = tfh.pack_head(_head([sh[-1] for sh in shapes], cuda_device))
    for k in (1, 4):
        stages = [(sliced(2, sh), sliced(2 * k, sh)) for sh in shapes]
        assert not any(tfh.kernel_plan(stages, sms=132).vec)
        _check_head_kernel(stages, k, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
def test_head_kernel_twelve_stages_matches_plain(cuda_device, dtype, k):
    """wperlay_cnn's 12 taps in one launch, pairwise (K = 1) and grouped
    (K = 4): three each of 56x56x256, 28x28x512, 14x14x1024 and 7x7x2048
    at batch 2."""
    g = torch.Generator(device=cuda_device).manual_seed(12 + k)
    shapes = [s for s in ((56, 56, 256), (28, 28, 512), (14, 14, 1024),
                          (7, 7, 2048)) for _ in range(3)]
    stages = [(torch.randn((2, *sh), device=cuda_device, generator=g)
               .abs().to(dtype),
               torch.randn((2 * k, *sh), device=cuda_device, generator=g)
               .abs().to(dtype)) for sh in shapes]
    packed = tfh.pack_head(_head([sh[-1] for sh in shapes], cuda_device))
    _check_head_kernel(stages, k, packed)


def _token_head(width, n_layers, shared, device):
    """A TokenHeadAggregator with nonnegative weights and biases +0.25."""
    from srsem_torch.models.global_models import TokenHeadAggregator

    head = TokenHeadAggregator(width, n_layers, shared=shared)
    head.reset_parameters(torch.Generator().manual_seed(n_layers))
    with torch.no_grad():
        for layer in head.linears():
            layer.weight.abs_()
            layer.bias.fill_(0.25)
    return head.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True], ids=["per_layer", "shared"])
@pytest.mark.parametrize("n_stages", [4, 12])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_token_head_kernel_matches_plain(cuda_device, dtype, shared,
                                         n_stages, k):
    """The ViT token head in one launch: (N, 197, 768) token taps (the
    1536-element fixed-channel path, which the plan takes), stages_vit's 4
    and wperlay_vit's 12, per-layer or one shared head (single_lin_vit,
    packed once a stage), pairwise, K = 4 and K = 8, at batch 2."""
    g = torch.Generator(device=cuda_device).manual_seed(n_stages + k)
    stages = [(torch.randn((2, 197, 768), device=cuda_device, generator=g)
               .abs().to(dtype),
               torch.randn((2 * k, 197, 768), device=cuda_device, generator=g)
               .abs().to(dtype)) for _ in range(n_stages)]
    plan = tfh.kernel_plan(stages, sms=132)
    assert all(plan.vec) and set(plan.step) == {1536}
    packed = tfh.pack_head(_token_head(768, n_stages, shared, cuda_device))
    assert packed.channels == (768,) * n_stages
    blocks = packed.w.reshape(n_stages, 768)
    assert torch.equal(blocks[0], blocks[-1]) == shared
    _check_head_kernel(stages, k, packed)


@pytest.mark.cuda
def test_vit_pair_scorer_kernel_path_matches_module(cuda_device):
    """PairScorer on the full-width ViT-B/16 (224 px, float32, seeded
    weights, stages_vit): the tower as the module, the head through the
    kernel, one head launch a batch, against the module's own forward
    (1e-4: the head's float32 sums in another order)."""
    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.models.global_models import make_global_model

    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="vit_clip", image_size=224, compute_dtype="float32"),
        head="stages_vit", depth=3)
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
    scorer = PairScorer(cfg, model, batch_size=4)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    b = np.clip(a + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    before = tfh.fused_global_score.launches
    got = scorer.score_arrays(a, b)
    torch.cuda.synchronize()
    assert tfh.fused_global_score.launches == before + 1
    pre = scorer.preprocess
    with torch.inference_mode():
        want = model(pre.device_normalize(torch.tensor(a, device=cuda_device)),
                     pre.device_normalize(torch.tensor(b, device=cuda_device)))
    assert bool((want > 1.0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_head_kernel_rejects_cuda_inputs(cuda_device):
    """Bad inputs raise before a launch; 13 stages exceed the kernel."""
    packed = tfh.pack_head(_head([8], cuda_device))
    gt = torch.zeros(2, 4, 4, 8, device=cuda_device)
    for sr in (torch.zeros(3, 4, 4, 8, device=cuda_device),
               torch.zeros(2, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16),
               torch.zeros(2, 8, 4, 4, device=cuda_device).permute(0, 2, 3, 1)):
        with pytest.raises((ValueError, TypeError)):
            tfh.fused_global_score({"s": gt}, {"s": sr}, packed, ["s"])
    names = [f"s{j}" for j in range(13)]
    taps = {n: gt for n in names}
    with pytest.raises(ValueError, match="at most 12"):
        tfh.fused_global_score(taps, taps, _head([8] * 13, cuda_device), names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wd,row_tile", [
    ((2, 16, 16, 64), 16, None), ((2, 16, 16, 64), 16, 5),
    ((2, 56, 56, 256), 64, 8), ((2, 14, 14, 1024), 256, None),
    ((2, 7, 7, 2048), 512, None), ((1, 13, 9, 256), 64, 4),
    ((3, 10, 11, 128), 64, None), ((1, 13, 9, 96), 24, 4),
    ((1, 5, 6, 36), 12, None),
    ((3, 7, 7, 2048), 512, None),   # 7x7: 147 flat rows, odd patch count
    ((1, 7, 7, 1024), 256, 3),      # 7x7, one image: one patch, one tile
    ((5, 13, 11, 512), 128, None),  # ragged H and W, ragged flat tile
    ((64, 7, 7, 512), 128, None)])  # 7x7 at batch 64, narrow
def test_bottleneck_kernel_matches_plain(cuda_device, dtype, shape, wd,
                                         row_tile):
    """CUDA kernel == plain version.  f32: FP order only (1e-4); bf16: a
    few bf16 ulps where the f32 sums round h1/h2/y apart (2e-2).  bf16 with
    C and wd multiples of 64 takes the tensor cores (flat tiles for the 1x1
    convs, patches for the 3x3), float32 with multiples of 32 too (by
    3xTF32); other widths the FMA path.  The packed weights give the same
    answer as the JAX-layout ones."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=shape).astype(np.float32),
                     device=cuda_device).to(dtype)
    ws = _weights(rng, shape[-1], wd, cuda_device)
    wrapper = tfb.fused_bottleneck_tiled if row_tile else tfb.fused_bottleneck
    kwargs = {"row_tile": row_tile} if row_tile else {}
    before = wrapper.launches
    got = wrapper(x, *ws, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = tfb.plain_bottleneck(x, ws, row_tile)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    packed = wrapper(x, tfb.pack_weights(ws, dtype), **kwargs)
    torch.testing.assert_close(packed, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_bottleneck_rejects_noncontiguous_cuda_input(cuda_device):
    rng = np.random.default_rng(9)
    x = torch.zeros(1, 32, 4, 4, device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fused_bottleneck(x, *_weights(rng, 32, 8, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 32])
def test_bottleneck_plan_at_main_path_shapes(cuda_device, n):
    """The library's plan at the four stages' shapes (224 px) on 132 SMs:
    three launches; the 1x1 convs over flat 64-row tiles, paired into
    blocks, so their rows computed over useful are 1.0 up to the last
    pair's ragged rows; conv2 over patches of at most 64 pixels.  A conv
    that the widest N tile would leave below one wave (the decoder's rule)
    takes a narrower tile.  float32 runs on the tensor cores by 3xTF32,
    with N tiles of 32, 64 or 128."""
    for s, hw in enumerate((56, 28, 14, 7)):
        c, wd = 256 * 2 ** s, 64 * 2 ** s
        x = torch.zeros(n, hw, hw, c, dtype=torch.bfloat16,
                        device=cuda_device)
        plan = tfb.kernel_plan(x, wd, sms=132)
        assert plan.launches == 3
        assert plan.tilings[0] == plan.tilings[2] == "flat"
        bh, bw = map(int, plan.tilings[1].split("x"))
        assert bh * bw <= 64 and bh <= hw and bw <= hw
        m = n * hw * hw
        pairs = [-(-m // 128), -(-n * -(-hw // bh) * -(-hw // bw) // 2),
                 -(-m // 128)]
        for i, cout in enumerate((wd, wd, c)):
            nt, blocks = plan.nts[i], plan.blocks[i]
            assert nt in (64, 128, 256) and cout % nt == 0
            assert blocks == pairs[i] * cout // nt, (s, i, plan)
            widest = 256 if cout % 256 == 0 else 128 if cout % 128 == 0 else 64
            if pairs[i] * cout // widest < 132:
                assert nt < widest, (s, i, plan)
        for i in (0, 2):
            assert plan.rows_ratio[i] == pytest.approx(pairs[i] * 128 / m)
            assert plan.rows_ratio[i] < 1.07
        assert plan.rows_ratio[1] >= 1
        f32 = tfb.kernel_plan(x.float(), wd, sms=132)
        assert f32.launches == 3 and f32.route == "wgmma_tf32x3"
        assert plan.route == "wgmma_bf16"
        for i, cout in enumerate((wd, wd, c)):
            assert f32.nts[i] in (32, 64, 128) and cout % f32.nts[i] == 0


def _decoder_args(rng, n, h, w, cd, cu, cm, co, fk, device):
    mk = lambda s, fan: torch.tensor(  # noqa: E731
        (rng.normal(size=s) / np.sqrt(fan)).astype(np.float32), device=device)
    d = torch.tensor(rng.uniform(0, 1, (n, h, w, cd)).astype(np.float32),
                     device=device)
    u = (torch.tensor(rng.uniform(0, 1, (n, h, w, cu)).astype(np.float32),
                      device=device) if cu else None)
    w1d = mk((3, 3, cd, cm), 9 * (cd + cu))
    w1u = mk((3, 3, cu, cm), 9 * (cd + cu)) if cu else None
    w2 = mk((3, 3, cm, co) if fk == 3 else (cm, co), (9 if fk == 3 else 1) * cm)
    return d, u, w1d, w1u, mk((cm,), 10), w2, mk((co,), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cd,cu,cm,co,fk,row_tile", [
    (2, 28, 28, 512, 1024, 512, 512, 3, None),   # level 2, whole image
    (2, 56, 56, 256, 512, 256, 256, 3, 7),       # level 1, tiled
    (2, 112, 112, 64, 256, 64, 1, 1, 7),         # level 0, 1x1 head, tiled
    (2, 56, 56, 257, 512, 256, 256, 3, 7),       # v2: odd skip channels
    (2, 7, 7, 2048, 0, 2048, 2048, 3, None),     # level 4: u=None
    (2, 13, 11, 24, 16, 16, 8, 3, 5),            # FMA widths, ragged tile
    (1, 10, 9, 65, 64, 64, 64, 3, 4),            # ragged, padded skip
    (2, 9, 12, 64, 128, 64, 1, 1, None),         # 1x1 head, whole image
    (1, 6, 5, 8, 0, 8, 8, 3, 4),                 # u=None, tiled, ragged
    (1, 28, 28, 512, 1024, 512, 512, 3, None),   # level 2, batch 1
    (1, 56, 56, 256, 512, 256, 256, 3, 7),       # level 1, batch 1
    (1, 7, 7, 2048, 0, 2048, 2048, 3, 3),        # level 4: one patch
    (4, 14, 14, 1024, 2048, 1024, 1024, 3, None),  # level 3: flat tiles
    (16, 7, 7, 2048, 0, 2048, 2048, 3, None),    # level 4: flat, u=None
    (3, 5, 7, 64, 64, 64, 64, 3, 4)])            # flat across images, ragged
def test_decoder_kernel_matches_plain(cuda_device, dtype, n, h, w, cd, cu,
                                      cm, co, fk, row_tile):
    """CUDA kernel == plain version.  f32: FP order only (1e-4); bf16: a
    few bf16 ulps where the f32 sums round h1/y apart (2e-2).  bf16 with
    every width a multiple of 64 (after padding the skip diff) takes the
    tensor cores (wgmma), float32 with multiples of 32 too (3xTF32; Cd =
    257 and 65 padded to 288 and 96); other widths the FMA path.  An odd
    count of patches leaves a block's second warpgroup without one.  Flat
    M tiles (TMA im2col boxes) cross rows and images and end ragged."""
    rng = np.random.default_rng(10)
    d, u, w1d, w1u, b1, w2, b2 = _decoder_args(rng, n, h, w, cd, cu, cm, co,
                                               fk, cuda_device)
    d = d.to(dtype)
    u = None if u is None else u.to(dtype)
    wrapper = (tfd.fused_decoder_level_tiled if row_tile
               else tfd.fused_decoder_level)
    kwargs = {"row_tile": row_tile} if row_tile else {}
    before = wrapper.launches
    got = wrapper(d, u, w1d, w1u, b1, w2, b2, final_kernel=fk, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == (n, h, w, co) and got.dtype == dtype
    want = tfd.plain_decoder_level(d, u, w1d, w1u, b1, w2, b2, fk, row_tile)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decoder_tiles_fit_at_main_path_shapes(cuda_device):
    """The library's plan at every level at batch 32 and 224 px, in both
    dtypes: output patches of at most 64 pixels inside the image, two
    launches (one for the tensor cores' fused 1x1 head), and on the tensor
    cores at most 7% of the rows computed and not stored: 8x8 patches at
    56 and 112 px, flat tiles at 28, 14 and 7 px (1.00 / 1.00 / 1.06x the
    rows; patches there would take 1.14 / 1.31 / 1.31x).  bf16 takes the
    bf16 wgmma route, float32 the 3xTF32 one (v2's Cd = 257 padded to 320
    and 288).  A level as wide as Cm = 16384 runs."""
    rows = {28: 1.0, 56: 1.0, 112: 1.0, 14: 1.0, 7: 1664 / 1568}
    for h, cd, cu, cm, co, fk in [
            (28, 512, 1024, 512, 512, 3), (56, 256, 512, 256, 256, 3),
            (112, 64, 256, 64, 1, 1), (14, 1024, 2048, 1024, 1024, 3),
            (7, 2048, 0, 2048, 2048, 3), (56, 257, 512, 256, 256, 3)]:
        for dtype in (torch.float32, torch.bfloat16):
            d = torch.zeros(32, h, h, cd, dtype=dtype, device=cuda_device)
            u = (torch.zeros(32, h, h, cu, dtype=dtype, device=cuda_device)
                 if cu else None)
            w1d = torch.zeros(3, 3, cd, cm, device=cuda_device)
            w1u = torch.zeros(3, 3, cu, cm, device=cuda_device) if cu else None
            w2 = torch.zeros(*((3, 3) if fk == 3 else ()), cm, co,
                             device=cuda_device)
            args = tfd.kernel_args(
                d, u, w1d, w1u, torch.zeros(cm, device=cuda_device), w2,
                torch.zeros(co, device=cuda_device), fk)
            plan = tfd.kernel_plan(args, fk)
            assert 1 <= plan.bh <= h and 1 <= plan.bw <= h
            assert plan.bh * plan.bw <= 64 and plan.rows_ratio >= 1
            assert plan.route == ("wgmma_bf16" if dtype == torch.bfloat16
                                  else "wgmma_tf32x3"), (h, cd, plan)
            assert plan.launches == (1 if fk == 1 else 2)
            assert plan.rows_ratio == pytest.approx(rows[h]), (h, plan)
            assert plan.tilings == (("flat",) * 2 if h in (28, 14, 7)
                                    else ("8x8",) * plan.launches), plan
    rng = np.random.default_rng(11)
    d, _, w1d, _, b1, w2, b2 = _decoder_args(rng, 1, 8, 8, 64, 0, 16384, 64,
                                             3, cuda_device)
    got = tfd.fused_decoder_level(d.bfloat16(), None, w1d, None, b1, w2, b2)
    want = tfd.plain_decoder_level(d.bfloat16(), None, w1d, None, b1, w2, b2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_decoder_pads_odd_skip_for_tensor_cores(cuda_device):
    """Cd = 257 is padded for the tensor cores: to 320 in bf16, to 288 in
    float32."""
    mk = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        *s, dtype=dt, device=cuda_device)
    for dtype, want in ((torch.bfloat16, 320), (torch.float32, 288)):
        args = tfd.kernel_args(mk(1, 8, 8, 257, dt=dtype),
                               mk(1, 8, 8, 512, dt=dtype),
                               mk(3, 3, 257, 256), mk(3, 3, 512, 256),
                               mk(256), mk(3, 3, 256, 256), mk(256), 3)
        assert args[0].shape[-1] == want and args[2].shape[1] == want


@pytest.mark.cuda
def test_skip_width_rule_matches_the_library(cuda_device):
    """``tensor_core_widths``, the rule the wrapper pads by without the
    library, is fused_decoder.cu's ``route()``: the two agree at every
    width tried, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for cd in (1, 8, 24, 32, 64, 65, 96, 128, 257, 288, 320, 513):
            for cu in (0, 16, 32, 64, 256):
                for cm, co, fk in ((8, 8, 3), (32, 32, 3), (64, 64, 3),
                                   (256, 512, 3), (32, 1, 1), (64, 1, 1),
                                   (128, 1, 1), (256, 1, 1), (512, 1, 1)):
                    want = tfd._route(dtype, (cd, cu, cm, co), fk) != "fma"
                    assert tfd.tensor_core_widths(
                        dtype, cd, cu, cm, co, fk) == want, (
                            dtype, cd, cu, cm, co, fk)


def _tf32x3_close(got, want, ref, again):
    """The 3xTF32 route's gates: within 1e-4 of the plain float32 version,
    at most 4x its error against the float64 reference, and the same bits
    from a second launch."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = float((got.double() - ref).abs().max())
    plain = float((want.double() - ref).abs().max())
    assert err <= 4 * plain, (err, plain)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wd", [
    ((8, 28, 28, 512), 128), ((8, 14, 14, 1024), 256),
    ((8, 7, 7, 2048), 512), ((8, 56, 56, 256), 64)])
def test_float32_bottleneck_takes_tf32x3(cuda_device, shape, wd):
    """``train-nr-iqa``'s float32 tower shapes (batch 8; the last one the
    tiled wrapper's) run on the 3xTF32 route and meet its gates."""
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=shape).astype(np.float32),
                     device=cuda_device)
    ws = _weights(rng, shape[-1], wd, cuda_device)
    assert tfb.kernel_plan(x, wd).route == "wgmma_tf32x3"
    packed = tfb.pack_weights(ws, torch.float32)
    got = tfb.fused_bottleneck(x, packed)
    again = tfb.fused_bottleneck(x, packed)
    _tf32x3_close(got, tfb.plain_bottleneck(x, ws), f64_bottleneck(x, ws),
                  again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,cd,cu,cm,co,fk", [
    (28, 512, 1024, 512, 512, 3), (56, 256, 512, 256, 256, 3),
    (112, 64, 256, 64, 1, 1),
    (28, 513, 1024, 512, 512, 3), (56, 257, 512, 256, 256, 3),   # v2
    (112, 65, 256, 64, 1, 1)])
def test_float32_decoder_takes_tf32x3(cuda_device, h, cd, cu, cm, co, fk):
    """The CLU models' default float32 decoder, levels 2, 1, 0 at batch 4
    of the 224 px shapes, v1 and v2 (whose skip diffs are padded to a
    multiple of 32), runs on the 3xTF32 route (level 0 one launch, its
    head in conv1's epilogue) and meets its gates; so does float32 Cd =
    257 at another size."""
    rng = np.random.default_rng(13)
    args = _decoder_args(rng, 4, h, h, cd, cu, cm, co, fk, cuda_device)
    plan = tfd.kernel_plan(tfd.kernel_args(*args, fk), fk)
    assert plan.route == "wgmma_tf32x3"
    assert plan.launches == (1 if fk == 1 else 2)
    got = tfd.fused_decoder_level(*args, final_kernel=fk)
    again = tfd.fused_decoder_level(*args, final_kernel=fk)
    _tf32x3_close(got, tfd.plain_decoder_level(*args, fk),
                  f64_decoder(*args, fk), again)
    odd = _decoder_args(rng, 1, 8, 8, 257, 512, 256, 256, 3, cuda_device)
    assert tfd.kernel_plan(tfd.kernel_args(*odd, 3),
                           3).route == "wgmma_tf32x3"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cd,cu", [(14, 1024, 2048), (7, 2048, 0),
                                     (14, 1025, 2048), (7, 2049, 0)],
                         ids=["level3", "level4", "v2_level3", "v2_level4"])
def test_deep_levels_at_batch_32(cuda_device, dtype, h, cd, cu):
    """Levels 3 and 4 of the CLU decoder at batch 32 and 224 px, v1 and v2
    widths (v2's skip padded to 1056 / 2080 in float32, 1088 / 2112 in
    bf16), with weights packed once as ``fold_decoder`` packs them: the
    plan (flat tiles, two launches; float32 N tiles of 128, bf16 of 256;
    rows 1.00 / 1.06x the pixels), and the kernel against the plain
    version at the tolerances of the levels above them: float32 the
    3xTF32 gates, against the float64 reference too; bf16 2e-2."""
    rng = np.random.default_rng(14)
    cm = 1024 if h == 14 else 2048
    d, u, *ws = _decoder_args(rng, 32, h, h, cd, cu, cm, cm, 3, cuda_device)
    d = d.to(dtype)
    u = None if u is None else u.to(dtype)
    packed = tfd.pack_level(*ws, 3, dtype)
    assert packed.split == (dtype == torch.float32)
    wide = tfd.skip_width(dtype, cd, cu, cm, cm, 3)
    assert packed.cd == wide == cd + -cd % (32 if dtype == torch.float32
                                            else 64)
    dp = torch.nn.functional.pad(d, (0, wide - cd))
    plan = tfd.kernel_plan(tfd.kernel_args(d, u, *ws, 3), 3)
    assert plan.tilings == ("flat", "flat") and plan.launches == 2
    assert plan.nts == ((128, 128) if dtype == torch.float32 else (256, 256))
    assert plan.rows_ratio == pytest.approx(1.0 if h == 14 else 1664 / 1568)
    before = tfd.fused_decoder_level.launches
    got = tfd.fused_decoder_level(dp, u, packed)
    assert tfd.fused_decoder_level.launches == before + 1
    want = tfd.plain_decoder_level(d, u, *ws, 3)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        return
    again = tfd.fused_decoder_level(dp, u, packed)
    _tf32x3_close(got, want, f64_decoder(d, u, *ws, 3), again)
    # The JAX-layout call, packing on the call, gives the same bits.
    assert torch.equal(tfd.fused_decoder_level(d, u, *ws), got)


def _serving_models(size):
    """A global model (resnet50_clip, stages_cnn, depth 3, live head) and
    a CluUnet on the same tower, seeded, float32, at ``size`` px."""
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import make_local_model

    bb = BackboneConfig(kind="resnet50_clip", image_size=size,
                        compute_dtype="float32")
    gcfg = GlobalModelConfig(backbone=bb, head="stages_cnn", depth=3)
    lcfg = LocalModelConfig(backbone=bb)
    gm = make_global_model(gcfg, torch.Generator().manual_seed(3))
    lm = make_local_model(lcfg, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for layer in gm.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
        lm.decoder[0][3].weight.mul_(0.1)
        lm.decoder[0][3].bias.add_(0.5)
    lm.backbone.load_state_dict(gm.backbone.state_dict())
    return gcfg, gm, lcfg, lm


def _images(tmp_path, n, size, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (size + 8, size + 16, 3), dtype=np.uint8)
        p = tmp_path / f"im{seed}_{i}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


def _close(got, want):
    """1e-5 + 1e-5 * max|want|: the head's tolerance (the same kernels on
    the same taps, float32 sums in another order)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 + 1e-5 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_score_service_matches_grouped_scorers(cuda_device, tmp_path):
    """ScoreService on the card (float32, TF32 off) against the grouped
    scorers on the same decoded images: scores and map means; one grouped
    head launch a score batch, five decoder calls a maps batch (levels 2-4
    through the whole-image wrapper, 0-1 through the tiled one)."""
    from srsem_torch.cli.serve import ScoreService
    from srsem_torch.eval.grouped import GroupedMapScorer, GroupedPairScorer

    gcfg, gm, lcfg, lm = _serving_models(64)
    svc = ScoreService(gcfg, gm, group_batch=4, map_cfg=lcfg, map_model=lm)
    svc.warmup([2])
    files = _images(tmp_path, 9, 64, 0)
    reqs = [{"id": i, "gt": files[3 * i], "sr": files[3 * i + 1: 3 * i + 3]}
            for i in range(3)]
    head0 = tfh.fused_grouped_score.launches
    dec0 = (tfd.fused_decoder_level.launches,
            tfd.fused_decoder_level_tiled.launches)
    scores = svc.score_requests(reqs)
    maps = svc.map_requests([dict(r, maps=True) for r in reqs])
    assert tfh.fused_grouped_score.launches == head0 + 1
    assert (tfd.fused_decoder_level.launches - dec0[0],
            tfd.fused_decoder_level_tiled.launches - dec0[1]) == (3, 2)
    svc.close()
    pre = svc._core.preprocess
    gt = np.stack([pre.decode_uint8(r["gt"]) for r in reqs])
    sr = np.stack([np.stack([pre.decode_uint8(p) for p in r["sr"]])
                   for r in reqs])
    want = GroupedPairScorer(gcfg, gm, k=2).score_arrays(gt, sr).cpu()
    assert bool((want > 1).all())
    _close([r["scores"] for r in scores], want.numpy())
    want_m = GroupedMapScorer(lcfg, lm, k=2).score_arrays(gt, sr).cpu()
    np.testing.assert_allclose([r["map_means"] for r in maps],
                               want_m.mean(dim=(2, 3)).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_dual_scorer_matches_pair_scorers(cuda_device):
    """DualScorer on the card (float32, TF32 off): one tower pass an image
    feeding both heads == the global and the local PairScorer (the same
    kernels on the same taps); 24 bottleneck calls a batch, not 48."""
    from srsem_torch.eval.dataset_sweep import DualScorer
    from srsem_torch.eval.scorer import PairScorer

    gcfg, gm, lcfg, lm = _serving_models(64)
    dual = DualScorer(gcfg, lcfg, gm, lm, batch_size=4)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-30, 31, a.shape), 0,
                255).astype(np.uint8)
    calls = tfb.fused_bottleneck.launches + tfb.fused_bottleneck_tiled.launches
    scores, maps = dual.score_both(a, b)
    torch.cuda.synchronize()
    assert (tfb.fused_bottleneck.launches + tfb.fused_bottleneck_tiled.launches
            - calls) == 24
    want_s = PairScorer(gcfg, gm, batch_size=4).score_arrays(a, b)
    want_m = PairScorer(lcfg, lm, batch_size=4,
                        model_kind="local").score_arrays(a, b)
    _close(scores.cpu().numpy(), want_s.cpu().numpy())
    _close(maps.cpu().numpy(), want_m.cpu().numpy())
    gs, gmaps = dual.score_group_arrays(a[:2], b.reshape(2, 2, 64, 64, 3))
    ps, pm = dual.score_both(np.repeat(a[:2], 2, axis=0), b)
    _close(gs.reshape(-1).cpu().numpy(), ps.cpu().numpy())
    _close(gmaps.reshape(4, 64, 64).cpu().numpy(), pm.cpu().numpy())


def _train_pair(model, is_map, fused):
    """The training loop's step functions over ``model`` on the card (Adam
    over everything outside the tower), through the fused or the module
    tower."""
    from srsem_torch.train.loop import build_training
    from srsem_torch.train.partition import trainable_predicate

    return build_training(model, is_map, trainable_predicate(), 1e-4,
                          torch.device("cuda"), fused)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("is_map", [False, True], ids=["global", "clu"])
def test_train_step_fused_tower_matches_module_tower(cuda_device, is_map):
    """One float32 train step (TF32 off) through the folded kernel tower
    against the module tower, from the same weights on the same batch:
    losses within rtol 1e-5; the stepped head within 1e-6 (each element
    moved by lr from the same signs), the decoder within 2·lr (a decoder
    gradient's sign can flip with the towers' rounding) and its BatchNorm
    running statistics within rtol 1e-4 (atol 1e-5 of each leaf's
    largest value: float32 rounding of means up to ~70); 12 bottleneck
    calls (one tower pass over the 2N images)."""
    import copy

    from srsem_torch.train.partition import flatten_dict
    from srsem_torch.utils.convert import jax_trainable_params

    _, gm, _, lm = _serving_models(64)
    model = lm if is_map else gm
    twin = copy.deepcopy(model)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    a = torch.randn(3, 64, 64, 3, device=cuda_device, generator=g)
    b = a + torch.randn(a.shape, device=cuda_device, generator=g)
    y = torch.rand((3, 64, 64) if is_map else (3,), device=cuda_device,
                   generator=g)
    mask = torch.ones(3, device=cuda_device)
    calls = tfb.fused_bottleneck.launches + tfb.fused_bottleneck_tiled.launches
    loss_f = float(_train_pair(model, is_map, True).train_step(a, b, y, mask))
    assert (tfb.fused_bottleneck.launches + tfb.fused_bottleneck_tiled.launches
            - calls) == 12
    loss_m = float(_train_pair(twin, is_map, False).train_step(a, b, y, mask))
    assert abs(loss_f - loss_m) <= 1e-5 * abs(loss_m)
    (pf, sf), (pm, sm) = jax_trainable_params(model), jax_trainable_params(twin)
    pf, pm = flatten_dict(pf), flatten_dict(pm)
    for key in pm:
        np.testing.assert_allclose(pf[key], pm[key], rtol=0,
                                   atol=2e-4 if is_map else 1e-6,
                                   err_msg=str(key))
    sf, sm = flatten_dict(sf), flatten_dict(sm)
    for key in sm:
        np.testing.assert_allclose(
            sf[key], sm[key], rtol=1e-4,
            atol=1e-5 * float(np.abs(sm[key]).max()), err_msg=str(key))


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [8, "full"], ids=["lora", "full"])
def test_tower_training_step_on_card_matches_cpu(cuda_device, rank):
    """One float32 CLU train step (TF32 off) that trains the tower — LoRA
    factors on every conv, or the whole tower under activation
    checkpointing — on the card against the same step on the CPU, from
    the same weights on the same batch: the loss within rtol 1e-4 (cuDNN's
    and the CPU's float32 convolutions sum in other orders), every trained
    leaf, the tower's included, within 2·lr, and Adam's moments leaf by
    leaf (a first step moves a leaf by at most lr whatever its gradient:
    ``mu`` = 0.1·g and ``nu`` = 0.001·g² hold the gradient), within 1e-3
    relative plus 1e-2 of the leaf's scale, floored at 1e-4 of the tree's
    (the CPU's oneDNN convolutions off, as in the CPU parity tests); the
    tower runs as the module, so no bottleneck kernel launches."""
    import copy

    from srsem_torch.config import BackboneConfig, LocalModelConfig
    from srsem_torch.models.local_models import make_local_model
    from srsem_torch.train.loop import build_training
    from srsem_torch.train.partition import flatten_dict, trainable_predicate
    from srsem_torch.utils.convert import jax_adam_state, jax_trainable_params

    lr = 1e-4
    model = make_local_model(
        LocalModelConfig(backbone=BackboneConfig(
            kind="resnet50_clip", image_size=64, compute_dtype="float32"),
            lora_rank=rank),
        width_mult=0.125, generator=torch.Generator().manual_seed(9))
    if rank != "full":
        with torch.no_grad():  # live factors: a zero init hides the delta
            for name, p in model.named_parameters():
                if name.endswith("lora_a"):
                    p.normal_(0.0, 0.05, generator=torch.Generator()
                              .manual_seed(len(name)))
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(9)
    batch = [torch.tensor(v) for v in (
        rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
        rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
        rng.uniform(0, 1, (2, 64, 64)).astype(np.float32),
        np.ones(2, np.float32))]
    pred = trainable_predicate(lora=rank != "full",
                               full_finetune=rank == "full")
    out = {}
    for name, m, dev in (("card", model, cuda_device),
                         ("cpu", twin, torch.device("cpu"))):
        calls = (tfb.fused_bottleneck.launches
                 + tfb.fused_bottleneck_tiled.launches)
        steps, opt = build_training(m, True, pred, lr, dev)
        with torch.backends.mkldnn.flags(enabled=False):
            loss = float(steps.train_step(*(t.to(dev) for t in batch)))
        assert (tfb.fused_bottleneck.launches
                + tfb.fused_bottleneck_tiled.launches) == calls
        state = jax_adam_state(m, opt)["0"]
        out[name] = (loss, flatten_dict(jax_trainable_params(m)[0]),
                     {k: flatten_dict(state[k]) for k in ("mu", "nu")})
    (lc, pc, mc), (lh, ph, mh) = out["card"], out["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    assert any(k[0] == "backbone" for k in ph)
    for key in ph:
        np.testing.assert_allclose(pc[key], ph[key], rtol=0, atol=2 * lr,
                                   err_msg=str(key))
    for moment, want in mh.items():
        tree_scale = max(float(np.abs(w).max()) for w in want.values())
        assert set(mc[moment]) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(
                mc[moment][key], w, rtol=1e-3,
                atol=max(1e-2 * float(np.abs(w).max()), 1e-4 * tree_scale),
                err_msg=f"{moment} {key}")


# The explain path embeds one image a call: the bottleneck at batch 1.
_BATCH1 = [((1, 56, 56, 256), 64, 8), ((1, 28, 28, 512), 128, None),
           ((1, 14, 14, 1024), 256, None), ((1, 7, 7, 2048), 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wd,row_tile", _BATCH1)
def test_bottleneck_at_batch_one(cuda_device, dtype, shape, wd, row_tile):
    """The four stages' shapes at batch 1 (a tower pass of the explain
    path; stage 3's 49 pixels are one 64-row tile): the plan's three
    launches, its blocks and rows computed over useful, and the kernel
    against the plain version (f32 1e-4, bf16 2e-2)."""
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(size=shape).astype(np.float32),
                     device=cuda_device).to(dtype)
    plan = tfb.kernel_plan(x, wd, sms=132)
    m = shape[1] * shape[2]
    assert plan.launches == 3
    if dtype == torch.bfloat16:  # tensor cores: flat 1x1 convs, paired
        assert plan.tilings[0] == plan.tilings[2] == "flat"
        pairs = -(-m // 128)
        for i, cout in ((0, wd), (2, shape[-1])):
            assert cout % plan.nts[i] == 0
            assert plan.blocks[i] == pairs * cout // plan.nts[i]
            assert plan.rows_ratio[i] == pytest.approx(pairs * 128 / m)
    assert plan.rows_ratio[1] >= 1
    ws = _weights(rng, shape[-1], wd, cuda_device)
    wrapper = tfb.fused_bottleneck_tiled if row_tile else tfb.fused_bottleneck
    kwargs = {"row_tile": row_tile} if row_tile else {}
    before = wrapper.launches
    got = wrapper(x, tfb.pack_weights(ws, dtype), **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               tfb.plain_bottleneck(x, ws, row_tile).float(),
                               rtol=tol, atol=tol)


def _clip_cam_tower(size):
    """A CLIP ResNet-50 with identity BN and small gammas closing each
    residual branch (its embedding moves with the image), float32."""
    from srsem_torch.backbones.resnet import ClipResNet50, reset_tower

    tower = ClipResNet50(torch.float32, size)
    reset_tower(tower, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, m in tower.named_modules():
            if name.startswith("layer") and name.endswith(("bn3",
                                                           "downsample.1")):
                m.weight.fill_(0.2)
    return tower.requires_grad_(False).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("tap", ["stages.3.2.act", "stem.conv3"])
def test_grad_cam_on_card_matches_cpu(cuda_device, tap):
    """Grad-CAM through the module tower at 224 px in float32 (TF32 off)
    on the card against the CPU on the same weights, within 1e-3 of the
    map; the card run's map comes from tensors that stayed on the card."""
    import copy

    from srsem_torch.explain.gradcam import grad_cam, grad_cam_matrix
    from srsem_torch.explain.targets import cosine_similarity_target

    tower = _clip_cam_tower(224)
    rng = np.random.default_rng(11)
    x = rng.random((1, 224, 224, 3)).astype(np.float32)
    target = rng.standard_normal((1, 1024)).astype(np.float32)
    cams = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        t = copy.deepcopy(tower).to(dev)
        seen = []

        def embed(img, offsets, t=t, seen=seen):
            seen.append(img.device.type)
            return t(img, tap_offsets=offsets)

        cams[name] = grad_cam(embed, torch.from_numpy(x).to(dev), tap,
                              cosine_similarity_target(target), (224, 224))
        assert set(seen) == {dev.type}
    assert cams["cpu"].max() > 0.5
    np.testing.assert_allclose(cams["card"], cams["cpu"], atol=1e-3)
    t = tower.to(cuda_device)
    imgs = [torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(rng.random((1, 224, 224, 3)).astype(np.float32))
            .to(cuda_device)]
    embs = torch.cat([t(im)[0] for im in imgs])
    grid = grad_cam_matrix(lambda img, o: t(img, tap_offsets=o), imgs, embs,
                           tap, cosine_similarity_target, (56, 56))
    assert grid.shape == (2, 2, 56, 56) and np.isfinite(grid).all()


@pytest.mark.cuda
def test_admm_and_greedy_on_card_match_cpu(cuda_device):
    """ADMM on the card (cuSOLVER's Cholesky, cuBLAS's triangular solves)
    against the CPU at a 2,000-concept dictionary of width 1024, within
    1e-4; the greedy span's indices equal."""
    from srsem_torch.decompose.admm import admm_lasso, precompute_factors
    from srsem_torch.decompose.greedy import GreedyDecomposer

    rng = np.random.default_rng(12)
    concepts = rng.standard_normal((2000, 1024)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    v = rng.standard_normal((2, 1024)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        factors = precompute_factors(concepts, device=dev)
        w = admm_lasso(None, v, 0.2, factors=factors)
        assert w.device.type == dev.type
        out[dev.type] = w.cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4)
    assert 0 < np.count_nonzero(out["cpu"]) < concepts.shape[0]
    idx = {dev: [int(i) for i in GreedyDecomposer(
        concepts, rank=8, device=dev)(v[0])[2]] for dev in ("cuda", "cpu")}
    assert idx["cuda"] == idx["cpu"]


def _random_bn(model, seed):
    """Random BN affine parameters and running statistics in ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(torch.rand(c, generator=g) - 0.5)
                m.running_mean.copy_(torch.rand(c, generator=g) - 0.5)
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return model


@pytest.mark.cuda
def test_transalnet_on_card_matches_cpu(cuda_device):
    """TranSalNet-Dense at 288x384 in float32 (TF32 off), seeded weights
    and random BN statistics: the eval map on the card against the CPU
    within 1e-3 of its largest value, and one train-mode forward's
    running statistics within 1e-4 of their largest."""
    import copy

    from srsem_torch.explain.saliency import TranSalNetDense

    model = _random_bn(TranSalNetDense().reset_parameters(
        torch.Generator().manual_seed(21)), 21).requires_grad_(False)
    x = torch.rand(2, 288, 384, 3, generator=torch.Generator().manual_seed(22))
    out, stats = {}, {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        m = copy.deepcopy(model).to(dev)
        out[name] = m(x.to(dev)).cpu()
        m(x.to(dev), train=True)
        stats[name] = {k: v.cpu() for k, v in m.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
    assert out["cpu"].shape == (2, 288, 384)
    tol = 1e-3 * float(out["cpu"].abs().max())
    assert float((out["card"] - out["cpu"]).abs().max()) <= tol
    for k, ref in stats["cpu"].items():
        err = float((stats["card"][k] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (k, err)


@pytest.mark.cuda
def test_dual_encoders_and_itm_on_card_match_cpu(cuda_device):
    """Full-width SLIP (a float32 ViT-B/16 at 224 and the CLIP text
    tower), ALBEF (its float32 DeiT tower at 384 and BERT-base) and the
    fusion encoder's ITM (one image's 577 tokens against four captions) on
    the card against the CPU in float32 (TF32 off), within 1e-3 of each
    output's largest value."""
    import copy

    from srsem_torch.backbones.vit import ClipViT
    from srsem_torch.explain.dual_encoders import (AlbefDualEncoder,
                                                   SlipDualEncoder,
                                                   albef_bert, albef_vit)
    from srsem_torch.explain.fusion import AlbefFusionEncoder, AlbefItmScorer
    from srsem_torch.pseudo.clip_text import ClipTextEncoder

    g = torch.Generator().manual_seed(23)
    slip_vit = ClipViT(dtype=torch.float32)
    slip_vit.reset_parameters(g)
    text = ClipTextEncoder(embed_dim=512).reset_parameters(g)
    a_vit = albef_vit()
    a_vit.reset_parameters(g)
    bert = albef_bert().reset_parameters(g)
    fusion = AlbefFusionEncoder().reset_parameters(g)
    proj = torch.randn(768, 256, generator=g) / 28.0
    slip_proj = torch.randn(768, 512, generator=g) / 28.0
    rng = np.random.default_rng(24)
    clip_ids = rng.integers(1, 49000, (2, 77))
    clip_ids[:, 20] = 49407
    tokens = {"input_ids": rng.integers(1000, 30000, (4, 30)),
              "attention_mask": np.ones((4, 30), np.int64)}
    tokens["attention_mask"][1, 12:] = 0
    xs = torch.randn(2, 224, 224, 3, generator=g)
    xa = torch.randn(1, 384, 384, 3, generator=g)
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        slip = SlipDualEncoder(copy.deepcopy(slip_vit), slip_proj,
                               text_encoder=copy.deepcopy(text),
                               tokenizer=lambda t: clip_ids[:len(t)],
                               device=dev)
        albef = AlbefDualEncoder(copy.deepcopy(a_vit), (proj, proj[0]),
                                 bert=copy.deepcopy(bert), text_proj=proj,
                                 tokenizer=lambda t: tokens, device=dev)

        def vit_tokens(px, v=albef.vit):
            # The tower's final LayerNorm over every token.
            taps = {}
            hook = v.blocks[-1].register_forward_hook(
                lambda mod, inp, o: taps.update(t=o[0] + o[1]))
            v(px)
            hook.remove()
            return torch.nn.functional.layer_norm(
                taps["t"], (768,), v.norm.weight, v.norm.bias, v.norm.eps)

        itm = AlbefItmScorer(copy.deepcopy(fusion), vit_tokens,
                             lambda t: tokens, device=dev)
        with torch.no_grad():
            out[name] = {"slip_image": slip.encode_image(xs).cpu(),
                         "slip_text": slip.encode_text(["a", "b"]).cpu(),
                         "albef_image": albef.encode_image(xa).cpu(),
                         "albef_text": albef.encode_text(["a"] * 4).cpu(),
                         "itm": torch.from_numpy(itm(xa.to(dev),
                                                     ["a"] * 4))}
    assert out["cpu"]["itm"].shape == (4,)
    for k, ref in out["cpu"].items():
        err = float((out["card"][k] - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()), (k, err)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_matches_no_mesh(cuda_device):
    """A one-rank NCCL process group's mesh on the card (float32, TF32
    off): a scored batch of the global and of the CLU scorer, and one CLU
    train step, run every collective of the mesh path over one rank and
    equal the no-mesh path (scores, maps and the loss rtol 1e-6; the
    gradients the step applied within 1e-5 of the largest, as a bias
    feeding a train-mode BatchNorm has a zero gradient of float32 noise;
    the trained decoder within 2·lr: a decoder gradient's rounding can
    flip a near-zero sign)."""
    import copy
    import socket

    import torch.distributed as dist

    from srsem_torch.core.meshes import create_mesh
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.train.partition import flatten_dict, trainable_predicate
    from srsem_torch.train.loop import build_training
    from srsem_torch.utils.convert import jax_trainable_params

    gcfg, gm, lcfg, lm = _serving_models(64)
    twin = copy.deepcopy(lm)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    batch = (torch.randn(4, 64, 64, 3, device=cuda_device, generator=g),
             torch.randn(4, 64, 64, 3, device=cuda_device, generator=g),
             torch.rand(4, 64, 64, device=cuda_device, generator=g),
             torch.tensor([1.0, 1.0, 1.0, 0.0], device=cuda_device))

    def run(model, mesh):
        kw = {"mesh": mesh} if mesh is not None else {}
        scores = PairScorer(gcfg, gm, batch_size=3, **kw).score_arrays(a, b)
        maps = PairScorer(lcfg, model, batch_size=3, model_kind="local",
                          **kw).score_arrays(a, b)
        steps = build_training(model, True, trainable_predicate(), 1e-4,
                               cuda_device, mesh=mesh)[0]
        loss = float(steps.train_step(*batch))
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        return scores.cpu(), maps.cpu(), loss, flatten_dict(
            jax_trainable_params(model)[0]), grads

    want = run(twin, None)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh(device="cuda")
        assert mesh.distributed and mesh.shape == {"data": 1, "model": 1}
        got = run(lm, mesh)
    finally:
        dist.destroy_process_group()
    for g_, w_ in zip(got[:2], want[:2]):
        torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6)
    assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])
    assert got[4].keys() == want[4].keys() and want[4]
    scale = max(float(w.abs().max()) for w in want[4].values())
    for key, w in want[4].items():
        assert float((got[4][key] - w).abs().max()) <= 1e-5 * scale, key
    for key in want[3]:
        np.testing.assert_allclose(got[3][key], want[3][key], rtol=0,
                                   atol=2e-4, err_msg=str(key))


@pytest.mark.cuda
def test_cli_runs_float32_without_tf32(cuda_device, tmp_path):
    """``python -m srsem_torch folder-metrics`` in a process of its own
    (LPIPS alex on cuDNN in float32, SSIM, PSNR) gives the scores of the
    same call made here with TF32 off, within the port's score tolerance
    of 1e-3, and LPIPS no farther from them than the call at PyTorch's
    default (cuDNN in TF32) is: the CLI turns TF32 off before it builds a
    model."""
    from PIL import Image

    from srsem_torch.eval.folder_metrics import (
        ImageQualityMetrics,
        read_metrics_csv,
    )

    rng = np.random.default_rng(14)
    gt_dir, sr_dir = tmp_path / "gt", tmp_path / "sr"
    gt_dir.mkdir()
    sr_dir.mkdir()
    for i in range(4):
        a = np.asarray(Image.fromarray(rng.integers(
            0, 256, (8, 8, 3), dtype=np.uint8)).resize((256, 256),
                                                       Image.BICUBIC))
        b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
        Image.fromarray(a).save(gt_dir / f"{i}.png")
        Image.fromarray(b).save(sr_dir / f"{i}.png")
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "folder-metrics", str(gt_dir),
         str(sr_dir), "--batch-size", "4"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cli = read_metrics_csv(str(sr_dir / "metrics.csv"))
    names = [r["image_name"] for r in cli]
    calc = ImageQualityMetrics(batch_size=4, device=cuda_device)
    run = lambda: calc.batch([str(gt_dir / f"{n}.png") for n in names],  # noqa: E731
                             [str(sr_dir / f"{n}.png") for n in names])
    here = run()
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = run()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for got, want in zip(cli, here):
        for c in ("LPIPS", "SSIM", "PSNR"):
            assert abs(got[c] - want[c]) <= 1e-3 * max(1.0, abs(want[c])), (
                c, got[c], want[c])
    far = lambda rows: max(abs(r["LPIPS"] - w["LPIPS"])  # noqa: E731
                           for r, w in zip(rows, here))
    assert far(cli) <= far(tf32), (far(cli), far(tf32))
