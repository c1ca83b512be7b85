"""The port's kernels against their plain PyTorch versions on a CUDA card:
the head (csrc/fused_head.cu), the bottleneck and the decoder level; the
scoring service and the dual scorer on the card against the scorers they
share kernels with.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it runs where JAX is not installed, with the repo's
conftest (which pins JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

float32 comparisons run with TF32 off.
"""

import numpy as np
import pytest
import torch

from srsem_torch.ops import fused_bottleneck as tfb
from srsem_torch.ops import fused_decoder as tfd
from srsem_torch.ops import fused_head as tfh


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
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_head_kernel_matches_plain(cuda_device, dtype, k, s):
    """The whole head in one launch: S stages (the main path's 56x56x256
    and 7x7x2048, C = 40 on the general path, a one-chunk 8x8x32), K SR
    images a GT image."""
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
    convs, patches for the 3x3); other widths (and float32) the FMA path.
    The packed weights give the same answer as the JAX-layout ones."""
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
    takes a narrower tile.  float32 runs on FMAs."""
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
        assert f32.launches == 3 and f32.nts == (64, 64, 64)


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
    (1, 7, 7, 2048, 0, 2048, 2048, 3, 3)])       # level 4: one patch
def test_decoder_kernel_matches_plain(cuda_device, dtype, n, h, w, cd, cu,
                                      cm, co, fk, row_tile):
    """CUDA kernel == plain version.  f32: FP order only (1e-4); bf16: a
    few bf16 ulps where the f32 sums round h1/y apart (2e-2).  bf16 with
    every width a multiple of 64 (after padding the skip diff) takes the
    tensor cores (wgmma); float32 and other widths the FMA path.  An odd
    count of patches leaves a block's second warpgroup without one."""
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
    cores at most 15% of the rows computed and not stored at the main-path
    shapes (28, 56 and 112 px).  A level as wide as Cm = 16384 runs."""
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
            tc = dtype == torch.bfloat16
            assert plan.launches == (1 if tc and fk == 1 else 2)
            if tc and h in (28, 56, 112):
                assert plan.rows_ratio <= 1.15, (h, plan)
    rng = np.random.default_rng(11)
    d, _, w1d, _, b1, w2, b2 = _decoder_args(rng, 1, 8, 8, 64, 0, 16384, 64,
                                             3, cuda_device)
    got = tfd.fused_decoder_level(d.bfloat16(), None, w1d, None, b1, w2, b2)
    want = tfd.plain_decoder_level(d.bfloat16(), None, w1d, None, b1, w2, b2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_decoder_pads_odd_skip_for_tensor_cores(cuda_device):
    """bf16 with Cd = 257 is padded to 320 for the tensor cores; float32
    (FMA path) is left as it is."""
    mk = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        *s, dtype=dt, device=cuda_device)
    for dtype, want in ((torch.bfloat16, 320), (torch.float32, 257)):
        args = tfd.kernel_args(mk(1, 8, 8, 257, dt=dtype),
                               mk(1, 8, 8, 512, dt=dtype),
                               mk(3, 3, 257, 256), mk(3, 3, 512, 256),
                               mk(256), mk(3, 3, 256, 256), mk(256), 3)
        assert args[0].shape[-1] == want and args[2].shape[1] == want


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
    head launch a score batch, three decoder calls a maps batch."""
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
            tfd.fused_decoder_level_tiled.launches - dec0[1]) == (1, 2)
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
