"""Port fused bottleneck (srsem_torch/ops/fused_bottleneck.py) vs the JAX
Pallas kernels (srsem/ops/fused_bottleneck.py, interpret mode).

On the CPU the wrappers run the plain version, the TPU kernels' tile loop
(halo, h1 masking, ragged edges) in torch ops.  Tolerances are the JAX
package's own (tests/test_fused_bottleneck.py): 1e-4 whole-image, 1e-5
tiled.  The card tests are in tests/test_torch_port_cuda.py.

The card's kernel (csrc/fused_bottleneck.cu: three launches of the conv in
csrc/conv_wgmma.cuh) cannot run here, so its indexing is emulated in
torch: ``_flat_tile`` is the 64-row box a TMA load brings in for a 1x1
conv's flat M tile, ``_a_tile`` the box of a (patch, tap, chunk) k-step of
the 3x3 conv, ``_flat_gemm`` and ``_implicit_gemm`` sum those boxes
against the K-major weights as the kernel's k-loop does, and
``_three_pass`` is the three launches (h1 and h2 rounded to x's dtype).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import srsem.ops.fused_bottleneck as jfb
from srsem_torch.backbones.resnet import FrozenBatchNorm, ImageNetBottleneck
from srsem_torch.ops import fused_bottleneck as tfb


def _weights(rng, c, wd, scale=0.1):
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return mk(c, wd), mk(wd), mk(3, 3, wd, wd), mk(wd), mk(wd, c), mk(c)


def _random_bn(rng, bn: FrozenBatchNorm):
    c = bn.weight.shape[0]
    bn.weight.copy_(torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32))
    bn.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c), dtype=torch.float32))
    bn.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c),
                                       dtype=torch.float32))
    bn.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c),
                                      dtype=torch.float32))


def _jax_bn(bn: FrozenBatchNorm):
    return {"scale": jnp.asarray(bn.weight.numpy()),
            "bias": jnp.asarray(bn.bias.numpy()),
            "mean": jnp.asarray(bn.running_mean.numpy()),
            "var": jnp.asarray(bn.running_var.numpy())}


def test_fold_bn_into_conv_exact():
    """conv → BN == folded conv (with a conv bias), and == JAX's fold."""
    rng = np.random.default_rng(0)
    bn = FrozenBatchNorm(16)
    _random_bn(rng, bn)
    weight = torch.tensor(rng.normal(size=(16, 8, 3, 3)).astype(np.float32) * 0.2)
    bias = torch.tensor(rng.normal(size=16).astype(np.float32))
    x = torch.tensor(rng.normal(size=(2, 8, 6, 6)).astype(np.float32))

    want = bn(F.conv2d(x, weight, bias, padding=1))
    wf, bf = tfb.fold_bn_into_conv(weight, bn, bias=bias)
    got = F.conv2d(x, wf, bf, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    jw, jb = jfb.fold_bn_into_conv(jnp.asarray(weight.numpy().transpose(2, 3, 1, 0)),
                                   _jax_bn(bn), bias=jnp.asarray(bias.numpy()))
    np.testing.assert_allclose(wf.numpy().transpose(2, 3, 1, 0), np.asarray(jw),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_bottleneck_weights_match_jax_layout():
    """bottleneck_weights == JAX bottleneck_weights on the same block."""
    rng = np.random.default_rng(2)
    block = ImageNetBottleneck(32, 8)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.normal_(generator=torch.Generator().manual_seed(1))
        for bn in (block.bn1, block.bn2, block.bn3):
            _random_bn(rng, bn)
    params = {f"conv{i}": {"kernel": jnp.asarray(
        getattr(block, f"conv{i}").weight.detach().numpy().transpose(2, 3, 1, 0))}
        for i in (1, 2, 3)}
    params.update({f"bn{i}": _jax_bn(getattr(block, f"bn{i}")) for i in (1, 2, 3)})
    got = tfb.bottleneck_weights(block)
    want = jfb.bottleneck_weights(params)
    assert [tuple(t.shape) for t in got] == [(32, 8), (8,), (3, 3, 8, 8), (8,),
                                             (8, 32), (32,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_fused_bottleneck_matches_jax():
    """Whole-image wrapper (plain version on CPU) == JAX kernel, f32."""
    rng = np.random.default_rng(1)
    n, h, w, c, wd = 2, 8, 8, 32, 8
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd)
    want = jfb.fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ws),
                                compute_dtype=jnp.float32, interpret=True)
    got = tfb.fused_bottleneck(torch.tensor(x), *map(torch.tensor, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("row_tile", [2, 4, 8])
def test_fused_bottleneck_tiled_matches_jax(row_tile):
    """Tiled wrapper (plain tile loop on CPU) == JAX tiled kernel, edge
    tiles (zero halo, masked h1) included."""
    rng = np.random.default_rng(3)
    n, h, w, c, wd = 2, 16, 16, 64, 16
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd)
    want = jfb.fused_bottleneck_tiled(jnp.asarray(x), *map(jnp.asarray, ws),
                                      row_tile=row_tile,
                                      compute_dtype=jnp.float32,
                                      interpret=True)
    got = tfb.fused_bottleneck_tiled(torch.tensor(x), *map(torch.tensor, ws),
                                     row_tile=row_tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("th,tw", [(5, 16), (3, 7), (16, 5), (1, 1)])
def test_ragged_and_column_tiles_match_jax(th, tw):
    """Tiles that do not divide H or W (the kernel's ragged edges) and
    split columns == the JAX whole-image kernel."""
    rng = np.random.default_rng(4)
    n, h, w, c, wd = 2, 16, 16, 64, 16
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd)
    want = jfb.fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ws),
                                compute_dtype=jnp.float32, interpret=True)
    got = tfb.bottleneck_tiles_plain(torch.tensor(x),
                                     tuple(map(torch.tensor, ws)), th, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_bf16_rounding_points_match_jax():
    """bf16 compute: h1/h2 rounded to bf16 between the convs, as in JAX."""
    rng = np.random.default_rng(5)
    n, h, w, c, wd = 1, 8, 8, 32, 8
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd, scale=0.2)
    want = jfb.fused_bottleneck_tiled(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, ws), row_tile=4,
        compute_dtype=jnp.bfloat16, interpret=True)
    got = tfb.fused_bottleneck_tiled(torch.tensor(x).to(torch.bfloat16),
                                     *map(torch.tensor, ws), row_tile=4)
    assert got.dtype == torch.bfloat16
    # One bf16 ulp (2^-8 relative) where the f32 sums round differently.
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("case", ["rank", "dtype", "contiguous", "w2", "b3",
                                  "row_tile", "packed_dtype", "packed_width",
                                  "five_weights"])
def test_wrapper_rejects_bad_inputs(case):
    rng = np.random.default_rng(6)
    x = torch.zeros(1, 4, 4, 32)
    ws = list(map(torch.tensor, _weights(rng, 32, 8)))
    kwargs = {}
    if case == "rank":
        x = torch.zeros(4, 4, 32)
    elif case == "dtype":
        x = x.double()
    elif case == "contiguous":
        x = torch.zeros(1, 32, 4, 4).permute(0, 2, 3, 1)
    elif case == "w2":
        ws[2] = torch.zeros(9, 8, 8)
    elif case == "b3":
        ws[5] = torch.zeros(8)
    elif case == "packed_dtype":
        ws = [tfb.pack_weights(ws, torch.bfloat16)]
    elif case == "packed_width":
        ws = [tfb.pack_weights(list(map(torch.tensor, _weights(rng, 64, 8))),
                               torch.float32)]
    elif case == "five_weights":
        ws = ws[:5]
    else:
        kwargs["row_tile"] = 0
    with pytest.raises((ValueError, TypeError)):
        if case == "row_tile":
            tfb.fused_bottleneck_tiled(x, *ws, **kwargs)
        else:
            tfb.fused_bottleneck(x, *ws)


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(7)
    ws = list(map(torch.tensor, _weights(rng, 32, 8)))
    before = (tfb.fused_bottleneck.launches, tfb.fused_bottleneck_tiled.launches)
    tfb.fused_bottleneck(torch.zeros(1, 4, 4, 32), *ws)
    tfb.fused_bottleneck_tiled(torch.zeros(1, 4, 4, 32), *ws, row_tile=2)
    assert (tfb.fused_bottleneck.launches,
            tfb.fused_bottleneck_tiled.launches) == before


def test_wrappers_take_packed_weights():
    """A ``Packed`` (made once, as fold_tower does) gives the JAX-layout
    call's answer in both wrappers, and packs back to the JAX layout."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(2, 6, 5, 32)).astype(np.float32))
    ws = list(map(torch.tensor, _weights(rng, 32, 8)))
    packed = tfb.pack_weights(ws, torch.float32)
    torch.testing.assert_close(tfb.fused_bottleneck(x, packed),
                               tfb.fused_bottleneck(x, *ws), rtol=0, atol=0)
    torch.testing.assert_close(
        tfb.fused_bottleneck_tiled(x, packed, row_tile=4),
        tfb.fused_bottleneck_tiled(x, *ws, row_tile=4), rtol=0, atol=0)


def test_fold_tower_holds_packed_weights():
    """fold_tower packs each fused block once, K-major in the tower dtype,
    and the packing is the block's JAX-layout weights."""
    from srsem_torch.backbones.fused_resnet import fold_tower
    from srsem_torch.backbones.resnet import ImageNetResNet50

    model = ImageNetResNet50(torch.float32)
    folded = fold_tower(model, torch.bfloat16)
    fused = [(s, b, w) for s, blocks in enumerate(folded)
             for b, (kind, w) in enumerate(blocks) if kind == "fused"]
    assert len(fused) == 12  # blocks 1.. of each stage (3 + 4 + 6 + 3 - 4)
    for s, b, p in fused:
        c, wd = 256 * 2 ** s, 64 * 2 ** s
        assert isinstance(p, tfb.Packed)
        assert [tuple(t.shape) for t in vars(p).values()] == [
            (wd, c), (wd,), (wd, 9 * wd), (wd,), (c, wd), (c,)]
        assert p.w1t.dtype == torch.bfloat16 and p.b1.dtype == torch.float32
        want = tfb.bottleneck_weights(model.stages()[s][b])
        for g, w_ in zip(tfb.unpack_weights(p), want):
            torch.testing.assert_close(g.float(), w_.to(g.dtype).float(),
                                       rtol=0, atol=0)


# -- the kernel's indexing, emulated ---------------------------------------

def _flat_tile(x2, q, chunk):
    """The (64, 64) A box the kernel's 2-D TMA load brings in for flat M
    tile q of the (pixels, C) matrix ``x2`` and channels 64 chunk ..
    64 chunk + 63: rows 64 q .., zero past the last pixel and past C."""
    xp = F.pad(x2, (0, 64 * (chunk + 1), 0, 64 * (q + 1)))
    return xp[64 * q:64 * q + 64, 64 * chunk:64 * chunk + 64]


def _flat_gemm(x2, wt, mm=torch.matmul):
    """A 1x1 conv's products over flat tiles in float32: per 64-row tile,
    the sum over 64-channel chunks of the A box times the K-major weights
    ``wt`` (Cout, C), each product by ``mm``; the last tile's rows past the
    pixels are dropped."""
    m, c = x2.shape
    tiles = -(-m // 64)
    out = torch.zeros(tiles * 64, wt.shape[0])
    for q in range(tiles):
        for chunk in range(-(-c // 64)):
            width = min(64, c - 64 * chunk)
            a = _flat_tile(x2, q, chunk)[:, :width].float()
            out[64 * q:64 * q + 64] += mm(
                a, wt[:, 64 * chunk:64 * chunk + width].float().t())
    return out[:m]


def _a_tile(x, img, r0, c0, bh, bw, tap, chunk, ks=3):
    """The (bh * bw, 64) A tile the kernel's TMA box brings in for the
    patch at (img, r0, c0), tap ``tap`` of a ks x ks conv and channels
    64 chunk .. 64 chunk + 63: row i * bw + j is input pixel
    (r0 + i + dy - ks // 2, c0 + j + dx - ks // 2), zero outside the
    tensor (negative coordinates, the ragged edge, channels past C)."""
    pad = ks // 2
    dy, dx = divmod(tap, ks)
    xp = F.pad(x[img], (0, 64 * (chunk + 1), pad, bw + pad, pad, bh + pad))
    tile = xp[r0 + dy:r0 + dy + bh, c0 + dx:c0 + dx + bw,
              64 * chunk:64 * chunk + 64]
    return tile.reshape(bh * bw, 64)


def _implicit_gemm(x, wt, bh, bw, ks=3, mm=torch.matmul):
    """A conv's products over bh x bw patches in float32: per patch, the
    sum over k-steps (tap, 64-channel chunk) of the A tile times the rows
    of the K-major weights ``wt`` (Cout, ks*ks*C), k = tap * C + c, each
    product by ``mm``."""
    n, h, w, c = x.shape
    cout = wt.shape[0]
    out = torch.zeros(n, -(-h // bh) * bh, -(-w // bw) * bw, cout)
    for img in range(n):
        for r0 in range(0, h, bh):
            for c0 in range(0, w, bw):
                acc = torch.zeros(bh * bw, cout)
                for tap in range(ks * ks):
                    for chunk in range(-(-c // 64)):
                        lo = tap * c + 64 * chunk
                        width = min(64, c - 64 * chunk)
                        a = _a_tile(x, img, r0, c0, bh, bw, tap, chunk,
                                    ks)[:, :width].float()
                        acc += mm(a, wt[:, lo:lo + width].float().t())
                out[img, r0:r0 + bh, c0:c0 + bw] = acc.reshape(bh, bw, cout)
    return out[:, :h, :w]


def _three_pass(x, p, patch, flat, mm=torch.matmul):
    """The kernel's three launches in torch: conv1 -> h1 rounded to x's
    dtype -> conv2 over zero-filled patches -> h2 rounded -> conv3 + b3 +
    x, ReLU, rounded; float32 sums, each k-step's product by ``mm``.  The
    1x1 convs run over flat tiles (tensor cores) or over patches
    (``flat=False``: the FMA route)."""
    n, h, w, c = x.shape
    dt = x.dtype

    def conv1x1(v, wt):
        if flat:
            return _flat_gemm(v.reshape(-1, v.shape[-1]), wt, mm).reshape(
                n, h, w, -1)
        return _implicit_gemm(v, wt, *patch, ks=1, mm=mm)

    h1 = F.relu(conv1x1(x, p.w1t) + p.b1).to(dt)
    h2 = F.relu(_implicit_gemm(h1, p.w2t, *patch, mm=mm) + p.b2).to(dt)
    return F.relu(conv1x1(h2, p.w3t) + p.b3 + x.float()).to(dt)


@pytest.mark.parametrize("m,c,cout", [(128, 64, 8),   # whole tiles
                                      (100, 80, 16),  # ragged; two chunks
                                      (49, 32, 4)])   # one 7x7 image
def test_flat_tiles_sum_to_matmul(m, c, cout):
    """Summed over K, the flat A boxes give the (pixels, C) matmul: the
    TMA zero fill past the last pixel and past C costs nothing."""
    rng = np.random.default_rng(9)
    x2 = torch.tensor(rng.normal(size=(m, c)).astype(np.float32))
    wt = torch.tensor(rng.normal(size=(cout, c)).astype(np.float32))
    torch.testing.assert_close(_flat_gemm(x2, wt), x2 @ wt.t(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_round_trips_to_jax_layout(dtype):
    """K-major packing: w2t[o, (dy*3 + dx)*wd + c] == w2[dy, dx, c, o], and
    unpacking gives the JAX layout back in the compute dtype."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    ws = list(map(torch.tensor, _weights(rng, 24, 8)))
    p = tfb.pack_weights(ws, dt)
    assert p.w2t.is_contiguous() and p.w2t.dtype == dt
    assert p.b2.dtype == torch.float32
    dy, dx, ci, o = 2, 1, 5, 3
    assert p.w2t[o, (dy * 3 + dx) * 8 + ci] == ws[2][dy, dx, ci, o].to(dt)
    assert p.w1t[o, 17] == ws[0][17, o].to(dt)
    assert p.w3t[17, o] == ws[4][o, 17].to(dt)
    for got, want in zip(tfb.unpack_weights(p), ws):
        torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,h,w,c,wd,patch,flat,row_tile", [
    (2, 7, 7, 64, 16, (7, 7), True, None),  # 7x7: 98 flat rows, ragged
    (2, 9, 6, 32, 8, (4, 6), True, 3),      # ragged H: a 1-row last patch
    (1, 6, 5, 40, 12, (3, 5), False, 2),    # wd 12: the FMA route
])
def test_three_pass_matches_plain_and_jax(n, h, w, c, wd, patch, flat,
                                          row_tile, dtype, tol):
    """The kernel's structure (h1 and h2 through memory, no halo; flat
    tiles for the 1x1 convs) equals the TPU kernels' tile loop
    (``bottleneck_tiles_plain``, whole image and row tiles) and the
    interpret-mode Pallas kernels: float32 at 1e-4, bf16 at 1e-2 (one ulp
    where the f32 sums round h1, h2 or y apart)."""
    rng = np.random.default_rng(11)
    xn = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd, scale=0.2)
    x = torch.tensor(xn).to(dtype)
    p = tfb.pack_weights(list(map(torch.tensor, ws)), dtype)
    got = _three_pass(x, p, patch, flat).float()
    jw = tfb.unpack_weights(p)
    cdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = (jnp.asarray(xn, cdt), *map(jnp.asarray, ws))
    wants = {
        "whole": tfb.bottleneck_tiles_plain(x, jw, h, w),
        "rows": tfb.bottleneck_tiles_plain(x, jw, row_tile or 3, w),
        "jax": jfb.fused_bottleneck(*jargs, compute_dtype=cdt,
                                    interpret=True),
    }
    if row_tile:
        wants["jax_tiled"] = jfb.fused_bottleneck_tiled(
            *jargs, row_tile=row_tile, compute_dtype=cdt, interpret=True)
    for name, want in wants.items():
        want = (want.float() if isinstance(want, torch.Tensor)
                else torch.tensor(np.asarray(want, dtype=np.float32)))
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
