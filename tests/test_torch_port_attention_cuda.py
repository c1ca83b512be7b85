"""The ViT attention kernel (csrc/fused_attention.cu) on a CUDA card: against
its plain PyTorch version element by element, inside a ViT-B/16-width tower
(its route, its launches, its taps), and out of the way of Grad-CAM.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_attention_cuda.py -q
"""

import numpy as np
import pytest
import torch

from srsem_torch.backbones import vit as vit_mod
from srsem_torch.ops import fused_attention as tfa
from srsem_torch.utils import profiling
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

HEADS = 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at max(|got|, |want|)
    (2^(e - 8) for a magnitude in [2^(e - 1), 2^e); 0 where both are 0)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs())
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), (e - 8).to(torch.int32))
    diff = (got - want).abs()
    return torch.where(diff == 0, torch.zeros_like(diff), diff / ulp)


def qkv_input(n, t, seed, spread=1.0, device="cuda"):
    """A (n, t, 3 * 768) bf16 qkv output: normal q, k, v; ``spread`` scales
    q and k (the scores by its square)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, t, 3, HEADS * 64, device=device, generator=g)
    x[:, :, :2] *= spread
    return x.reshape(n, t, -1).to(torch.bfloat16)


def exact_attention(qkv, heads=HEADS, scale=8.0):
    """The attention of qkv's bf16 values in float64, no rounding between."""
    n, t, c3 = qkv.shape
    x = qkv.reshape(n, t, 3, heads, c3 // (3 * heads)).double()
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    p = torch.softmax((q @ k.transpose(-1, -2)) / scale, dim=-1)
    return (p @ v).transpose(1, 2).reshape(n, t, c3 // 3)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("n", [1, 3, 64])
@pytest.mark.parametrize("t", [1, 8, 63, 64, 65, 128, 197, 256])
def test_attention_kernel_matches_plain(cuda_device, t, n, spread):
    """One launch against plain_attention at 12 heads of 64 (ragged tiles
    and key boxes, one token, a full 256), with ``peaked`` scores too (q
    and k scaled by 3: scores up to about 300, rows nearly one-hot).

    The two keep the same rounding points, and their float32 sums run in
    another order: where a score's sum falls on the other side of a bf16
    rounding boundary (about 1 in 10^4 outputs on the card, as often as
    the plain path itself parts from the same path with exact float64
    score sums), the softmax moves the outputs of that row by more than
    an ulp.  So: at least 99.9% of the elements equal the plain result
    bit for bit, every other one is within one bf16 ulp of it or the
    kernel is no farther from the float64 attention of the same bf16 q,
    k, v than the plain path is (its largest distance over the call, plus
    a quarter of a bf16 ulp at 1 for the output's own rounding).  Two
    launches give the same bits."""
    qkv = qkv_input(n, t, seed=t * 101 + n, spread=spread)
    before = tfa.fused_attention.launches
    with torch.inference_mode():
        got = tfa.fused_attention(qkv, HEADS, 8.0)
        want = tfa.plain_attention(qkv, HEADS, 8.0)
    torch.cuda.synchronize()
    assert tfa.fused_attention.launches == before + 1
    assert got.shape == want.shape == (n, t, HEADS * 64)
    assert got.dtype == torch.bfloat16
    equal = float((got == want).float().mean())
    assert equal >= 0.999, equal
    exact = exact_attention(qkv)
    far = (got.double() - exact).abs()
    limit = float((want.double() - exact).abs().max()) + 2.0 ** -9
    off = (bf16_ulps(got, want) > 1.0) & (far > limit)
    assert not bool(off.any()), (float(far.max()), limit)
    assert torch.equal(tfa.fused_attention(qkv, HEADS, 8.0), got)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv = qkv_input(2, 8, seed=0)
    for bad, heads in ((qkv.float(), HEADS), (qkv, 24),
                       (qkv_input(2, 257, seed=0), HEADS),
                       (qkv[:, ::2], HEADS)):
        with pytest.raises(ValueError):
            tfa.fused_attention(bad, heads, 8.0)
    with pytest.raises(ValueError):
        tfa.fused_attention(qkv.detach().requires_grad_(True), HEADS, 8.0)
    with pytest.raises(ValueError):  # 1 / 9.8125 is no bf16 value
        tfa.fused_attention(qkv, HEADS, 9.8125)


def vitb16(seed=0):
    """A ViT-B/16-width ClipViT in bf16 with seeded weights on the card."""
    tower = vit_mod.ClipViT(dtype=torch.bfloat16)
    tower.reset_parameters(torch.Generator().manual_seed(seed))
    return tower.cuda().eval()


def images(n, seed, size=224):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, size, size, 3))
                            .astype(np.float32)).cuda()


def plain_everywhere(monkeypatch):
    monkeypatch.setattr(vit_mod, "attention_route",
                        lambda qkv, heads: "plain")


def rel_gap(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
def test_vit_tower_kernel_route_matches_plain_route(cuda_device, monkeypatch):
    """Two passes of a seeded ViT-B/16-width tower (224 px, bf16) under
    inference_mode: 24 attention spans, every one ``route="kernel"``, and
    12 launches a pass.  Its taps and embedding part from those of the
    same tower with every block on the plain route by less than the bf16
    tower parts from its float32 copy (each one's largest gap over its
    largest magnitude): the kernel's few flipped roundings a block, which
    12 blocks carry on, stay inside the tower's own bf16 error."""
    tower = vitb16()
    x = images(2, seed=1)
    profiling.reset()
    profiling.enable()
    before = tfa.fused_attention.launches
    try:
        with torch.inference_mode():
            emb, taps = tower(x)
            tower(x)
        torch.cuda.synchronize()
    finally:
        profiling.disable()
    spans = [s for s in profiling.snapshot()["spans"]
             if s["name"] == "srsem.vit.attention"]
    assert [s["attrs"] for s in spans] == [{"route": "kernel"}] * 24
    assert tfa.fused_attention.launches == before + 24
    assert profiling.snapshot()["counters"]["launches.fused_attention"] \
        == tfa.fused_attention.launches
    tower32 = vit_mod.ClipViT(dtype=torch.float32).cuda().eval()
    tower32.load_state_dict(tower.state_dict())
    plain_everywhere(monkeypatch)
    with torch.inference_mode():
        want_emb, want_taps = tower(x)
        emb32, taps32 = tower32(x)
    torch.cuda.synchronize()
    assert tfa.fused_attention.launches == before + 24
    gaps = {"emb": (rel_gap(emb, want_emb), rel_gap(want_emb, emb32))}
    for name, tap in taps.items():
        assert tap.dtype == torch.float32
        gaps[name] = (rel_gap(tap, want_taps[name]),
                      rel_gap(want_taps[name], taps32[name]))
    assert all(kernel < bf16 for kernel, bf16 in gaps.values()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True])
def test_grad_cam_through_the_vit_takes_the_plain_route(cuda_device, frozen):
    """Grad-CAM at block 5 of a bf16 ViT-B/16-width tower on the card: every
    block the gradient passes through (all twelve while the parameters take
    gradients, blocks 6-11 of a frozen tower) records ``route="plain"``,
    and the CAM is then the plain route's to the bit.  A frozen tower's
    blocks 0-5 need no gradient and take the kernel: its CAM parts from
    the all-plain one by less than the bf16 tower's CAM parts from its
    float32 copy's."""
    from srsem_torch.explain.gradcam import grad_cam
    from srsem_torch.explain.targets import cosine_similarity_target

    tower = vitb16(seed=2)
    if frozen:
        tower.requires_grad_(False)
    x = images(1, seed=3)
    target = np.random.default_rng(4).standard_normal((1, 768)).astype(
        np.float32)

    def cam(t):
        profiling.reset()
        profiling.enable()
        try:
            out = grad_cam(lambda img, o: t(img, tap_offsets=o), x,
                           "blocks.5.ls2", cosine_similarity_target(target),
                           (224, 224), (14, 14))
        finally:
            profiling.disable()
        routes = [s["attrs"]["route"] for s in profiling.snapshot()["spans"]
                  if s["name"] == "srsem.vit.attention"]
        return out, routes

    got, routes = cam(tower)
    assert routes == (["kernel"] * 6 + ["plain"] * 6 if frozen
                      else ["plain"] * 12)
    with pytest.MonkeyPatch.context() as mp:
        plain_everywhere(mp)
        want, _ = cam(tower)
    assert got.shape == (1, 224, 224) and np.isfinite(got).all()
    assert want.max() > 0.5
    assert all(p.grad is None for p in tower.parameters())
    if not frozen:
        np.testing.assert_array_equal(got, want)
        return
    tower32 = vit_mod.ClipViT(dtype=torch.float32).cuda().eval()
    tower32.load_state_dict(tower.state_dict())
    cam32, _ = cam(tower32.requires_grad_(False))
    gap, bf16_gap = np.abs(got - want).max(), np.abs(want - cam32).max()
    assert 0 < bf16_gap and gap < bf16_gap, (gap, bf16_gap)


@pytest.mark.cuda
def test_float32_and_long_towers_stay_plain(cuda_device):
    """ALBEF's float32 towers and rows of more than 256 tokens take the
    plain route on the card, and launch nothing."""
    before = tfa.fused_attention.launches
    for dtype, size in ((torch.float32, 224), (torch.bfloat16, 272)):
        tower = vit_mod.ClipViT(dtype=dtype, depth=2)
        tower.reset_parameters(torch.Generator().manual_seed(0))
        tower = tower.cuda().eval()
        profiling.reset()
        profiling.enable()
        try:
            with torch.inference_mode():
                tower(images(1, seed=5, size=size))
        finally:
            profiling.disable()
        routes = {s["attrs"]["route"] for s in profiling.snapshot()["spans"]
                  if s["name"] == "srsem.vit.attention"}
        assert routes == {"plain"}
    assert tfa.fused_attention.launches == before
