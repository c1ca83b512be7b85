"""Port decoder-level wrappers (srsem_torch/ops/fused_decoder.py, plain
path on the CPU) vs the JAX Pallas kernels (srsem/ops/fused_decoder.py,
interpret mode), same inputs made with numpy.

Tiny shapes (N = 2, 8-16 px, 8-24 channels) cover the pair form and
``u=None``, ``final_kernel`` 1 and 3, row tiles with halos of 1 and 2 and
the v2 odd skip width.  f32; tolerance 2e-4, the JAX package's own for the
fused decoder (tests/test_fused_decoder.py:83-85).

The card's kernel (csrc/fused_decoder.cu) cannot run here, so its indexing
is emulated in torch: ``_a_tile`` is the box of rows a TMA load brings in
for one (patch, tap, 64-channel chunk) k-step, zero outside the tensor, and
``_implicit_gemm`` sums those tiles against the K-major weights as the
kernel's k-loop does; ``_im2col_tile`` is the im2col box of a flat M tile
(64 pixels in order across rows and images, each read at its tap);
``_two_pass`` is the kernel's two-launch structure (conv1 -> h1 rounded to
the dtype -> conv2 over zero-padded h1).  ``PackedLevel``s (the weights in
the kernel's layout, packed once) run the same plain version here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srsem.ops.fused_decoder import fused_decoder_level as jax_level
from srsem.ops.fused_decoder import fused_decoder_level_tiled as jax_tiled
from srsem_torch.ops import fused_decoder as tfd


def _inputs(seed, n, h, w, cd, cu, cm, co, fk):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    d = rng.uniform(0, 1, (n, h, w, cd)).astype(np.float32)
    u = rng.uniform(0, 1, (n, h, w, cu)).astype(np.float32) if cu else None
    fan = 9 * (cd + cu)
    w1d = f(3, 3, cd, cm) / np.sqrt(fan)
    w1u = f(3, 3, cu, cm) / np.sqrt(fan) if cu else None
    w2 = (f(3, 3, cm, co) / np.sqrt(9 * cm) if fk == 3
          else f(cm, co) / np.sqrt(cm))
    return d, u, w1d, w1u, f(cm) * 0.1, w2, f(co) * 0.1


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [  # n, h, w, cd, cu, cm, co, final_kernel
    (2, 8, 8, 16, 24, 16, 16, 3),
    (2, 16, 12, 8, 16, 8, 1, 1),
    (2, 9, 10, 17, 16, 16, 8, 3),   # v2: odd skip width
    (2, 8, 8, 24, 0, 16, 16, 3),    # u=None (deepest level)
]


@pytest.mark.parametrize("case", CASES)
def test_level_matches_jax(case):
    args = _inputs(0, *case)
    fk = case[-1]
    want = np.asarray(jax_level(*map(_j, args), final_kernel=fk,
                                compute_dtype=jnp.float32, interpret=True))
    before = tfd.fused_decoder_level.launches
    got = tfd.fused_decoder_level(*map(_t, args), final_kernel=fk)
    assert tfd.fused_decoder_level.launches == before  # CPU: plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case,row_tile", [
    ((2, 16, 12, 8, 16, 8, 1, 1), 4),    # halo 1 (1x1 head)
    ((2, 16, 8, 16, 24, 16, 16, 3), 4),  # halo 2
    ((2, 12, 10, 17, 16, 16, 8, 3), 3),  # halo 2, v2 skip width
])
def test_tiled_matches_jax(case, row_tile):
    args = _inputs(1, *case)
    fk = case[-1]
    want = np.asarray(jax_tiled(*map(_j, args), row_tile=row_tile,
                                final_kernel=fk, compute_dtype=jnp.float32,
                                interpret=True))
    got = tfd.fused_decoder_level_tiled(*map(_t, args), row_tile=row_tile,
                                        final_kernel=fk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("th,tw", [(3, 5), (16, 12), (1, 1), (5, 12)])
def test_plain_tile_loop_is_tile_independent(th, tw):
    """The plain version's tile loop (ragged edges, h1 halo masking) gives
    the whole-image answer for any tile."""
    args = tfd._prepare(*map(_t, _inputs(2, 2, 16, 12, 16, 24, 16, 8, 3)),
                        final_kernel=3)
    whole = tfd.decoder_tiles_plain(*args, 3, 16, 12)
    got = tfd.decoder_tiles_plain(*args, 3, th, tw)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,cd,wide", [(torch.bfloat16, 65, 128),
                                           (torch.float32, 65, 96),
                                           (torch.float32, 257, 288)])
def test_bf16_pads_odd_skip_exactly(dtype, cd, wide):
    """A v2 skip diff (Cd = 65 or 257) is zero-padded for the tensor cores
    (to a multiple of 64 in bf16, of 32 in float32) by ``kernel_args``,
    here as on the card, with zero rows in w1d; the padded level gives the
    unpadded level's answer (bf16: its plain version; float32: JAX's
    level in interpret mode at 2e-4)."""
    raw = _inputs(3, 1, 6, 6, cd, 64, 64, 64, 3)
    d, u, w1d, w1u, b1, w2, b2 = map(_t, raw)
    d, u = d.to(dtype), u.to(dtype)
    assert tfd.skip_width(dtype, cd, 64, 64, 64, 3) == wide
    args = tfd.kernel_args(d, u, w1d, w1u, b1, w2, b2, 3)
    assert args[0].shape[-1] == wide and args[2].shape == (9, wide, 64)
    assert not args[0][..., cd:].any() and not args[2][:, cd:].any()
    got = tfd.decoder_tiles_plain(*args, 3, 6, 6)
    if dtype == torch.float32:
        want = np.asarray(jax_level(*map(_j, raw), final_kernel=3,
                                    compute_dtype=jnp.float32,
                                    interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        want = tfd.decoder_tiles_plain(
            *tfd._prepare(d, u, w1d, w1u, b1, w2, b2, 3), 3, 6, 6)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("case,row_tile", [
    ((2, 9, 8, 24, 0, 16, 16, 3), 4),   # halo 2, ragged last tile
    ((2, 7, 6, 16, 0, 8, 1, 1), 2),     # halo 1 (1x1 head), ragged
])
def test_tiled_without_u_matches_jax_level(case, row_tile):
    """The tiled wrapper takes u=None, which the JAX tiled kernel (pair
    form only) does not: it matches JAX's whole-image level, whose numerics
    the tiled kernel shares."""
    args = _inputs(5, *case)
    fk = case[-1]
    want = np.asarray(jax_level(*map(_j, args), final_kernel=fk,
                                compute_dtype=jnp.float32, interpret=True))
    got = tfd.fused_decoder_level_tiled(*map(_t, args), row_tile=row_tile,
                                        final_kernel=fk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_wrappers_reject_bad_inputs():
    d, u, w1d, w1u, b1, w2, b2 = map(_t, _inputs(4, 1, 4, 4, 8, 8, 8, 8, 3))
    with pytest.raises(ValueError, match="row_tile"):
        tfd.fused_decoder_level_tiled(d, u, w1d, w1u, b1, w2, b2, row_tile=0)
    with pytest.raises(ValueError, match="w1u"):
        tfd.fused_decoder_level(d, u, w1d, None, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 shape"):
        tfd.fused_decoder_level(d, u, w1d, w1u, b1, w2[0, 0], b2)
    with pytest.raises(TypeError, match="dtype"):
        tfd.fused_decoder_level(d.double(), u, w1d, w1u, b1, w2, b2)


# -- the kernel's indexing, emulated ---------------------------------------

def _a_tile(x, img, r0, c0, bh, bw, tap, chunk, ks=3):
    """The (bh * bw, 64) A tile the kernel's TMA box brings in for the
    patch at (img, r0, c0), tap ``tap`` of a ks x ks conv and channels
    64 chunk .. 64 chunk + 63: row i * bw + j is input pixel
    (r0 + i + dy - ks // 2, c0 + j + dx - ks // 2), zero outside the
    tensor (negative coordinates, the ragged edge, channels past C)."""
    _, h, w, c = x.shape
    pad = ks // 2
    dy, dx = divmod(tap, ks)
    xp = F.pad(x[img], (0, 64 * (chunk + 1), pad, bw + pad, pad, bh + pad))
    tile = xp[r0 + dy:r0 + dy + bh, c0 + dx:c0 + dx + bw,
              64 * chunk:64 * chunk + 64]
    return tile.reshape(bh * bw, 64)


def _implicit_gemm(inputs, wt, bh, bw, ks=3, mm=torch.matmul):
    """The kernel's products in float32: for each output patch of bh x bw,
    the sum over k-steps (input, tap, 64-channel chunk) of A tile times
    the matching rows of the K-major weights ``wt`` (Cout, ks*ks*sum C),
    k = tap * C + c over the first input, then the second; each product by
    ``mm``."""
    n, h, w, _ = inputs[0].shape
    cout = wt.shape[0]
    th, tw = -(-h // bh), -(-w // bw)
    out = torch.zeros(n, th * bh, tw * bw, cout)
    for img in range(n):
        for r0 in range(0, h, bh):
            for c0 in range(0, w, bw):
                acc = torch.zeros(bh * bw, cout)
                k0 = 0
                for x in inputs:
                    c = x.shape[-1]
                    for tap in range(ks * ks):
                        for chunk in range(-(-c // 64)):
                            lo = k0 + tap * c + 64 * chunk
                            width = min(64, c - 64 * chunk)
                            a = _a_tile(x, img, r0, c0, bh, bw, tap, chunk,
                                        ks)[:, :width].float()
                            acc += mm(a, wt[:, lo:lo + width].float().t())
                    k0 += ks * ks * c
                out[img, r0:r0 + bh, c0:c0 + bw] = acc.reshape(bh, bw, cout)
    return out[:, :h, :w]


def _im2col_tile(x, q, tap, chunk, ks=3):
    """The (64, 64) A tile of flat M tile ``q`` that the kernel's TMA
    im2col box brings in for tap ``tap`` and channels 64 chunk .. 64 chunk
    + 63: row i is output pixel 64 q + i of the (N*H*W) pixel order (its
    image, row and column), read at (row + dy - ks // 2, column + dx - ks //
    2) of its own image; zero outside the image, past the last image, and
    for channels past C."""
    n, h, w, c = x.shape
    pad = ks // 2
    dy, dx = divmod(tap, ks)
    xp = F.pad(x, (0, 64 * (chunk + 1), pad, pad, pad, pad))
    r = torch.arange(64 * q, 64 * q + 64)
    img, rest = r // (h * w), r % (h * w)
    inside = img < n
    img = img.clamp(max=n - 1)
    rows = xp[img, rest // w + dy, rest % w + dx, 64 * chunk:64 * chunk + 64]
    return torch.where(inside[:, None], rows, 0.0)


def _flat_gemm(inputs, wt, ks=3):
    """``_implicit_gemm`` over flat M tiles: each 64-pixel tile of the
    (N*H*W) order summed over k-steps of ``_im2col_tile``s."""
    n, h, w, _ = inputs[0].shape
    cout = wt.shape[0]
    tiles = -(-n * h * w // 64)
    out = torch.zeros(tiles * 64, cout)
    for q in range(tiles):
        k0 = 0
        for x in inputs:
            c = x.shape[-1]
            for tap in range(ks * ks):
                for chunk in range(-(-c // 64)):
                    lo = k0 + tap * c + 64 * chunk
                    width = min(64, c - 64 * chunk)
                    a = _im2col_tile(x, q, tap, chunk, ks)[:, :width]
                    out[64 * q:64 * q + 64] += (
                        a.float() @ wt[:, lo:lo + width].float().t())
            k0 += ks * ks * c
    return out[:n * h * w].reshape(n, h, w, cout)


def _nchw(t):
    return t.permute(0, 3, 1, 2).float()


def test_a_tile_zero_fills_outside_the_image():
    x = torch.arange(1, 1 + 1 * 5 * 6 * 8, dtype=torch.float32).reshape(
        1, 5, 6, 8)
    corner = _a_tile(x, 0, 0, 0, 2, 3, tap=0, chunk=0)  # (dy, dx) = (-1, -1)
    assert not corner[0].any() and not corner[:, 8:].any()
    torch.testing.assert_close(corner[4, :8], x[0, 0, 0])  # row 1, col 1
    edge = _a_tile(x, 0, 3, 4, 2, 3, tap=8, chunk=0)  # (+1, +1) past the edge
    torch.testing.assert_close(edge[0, :8], x[0, 4, 5])
    assert not edge[1:].any()


@pytest.mark.parametrize("n,h,w,cd,cu,cout,bh,bw,ks", [
    (2, 10, 9, 24, 80, 16, 3, 4, 3),  # ragged patches; u in two chunks
    (1, 7, 11, 72, 0, 8, 4, 4, 3),    # u=None, ragged
    (2, 6, 5, 16, 8, 4, 8, 8, 3),     # one patch larger than the image
    (1, 5, 6, 40, 0, 3, 2, 5, 1),     # 1x1: the head's conv as a GEMM
])
def test_implicit_gemm_tiles_sum_to_conv(n, h, w, cd, cu, cout, bh, bw, ks):
    """Summed over K, the A tiles the kernel loads give F.conv2d of the
    (d, u) pair with SAME padding: the split-concat identity, the TMA zero
    fill as padding, and ragged patches."""
    rng = np.random.default_rng(6)
    t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    inputs = [t(n, h, w, cd)] + ([t(n, h, w, cu)] if cu else [])
    hwio = [t(ks, ks, x.shape[-1], cout) for x in inputs]
    wt = tfd._k_major([k.reshape(-1, cout) for k in hwio], torch.float32)
    want = sum(F.conv2d(_nchw(x), k.permute(3, 2, 0, 1), padding=ks // 2)
               for x, k in zip(inputs, hwio)).permute(0, 2, 3, 1)
    got = _implicit_gemm(inputs, wt, bh, bw, ks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_im2col_tile_steps_across_rows_and_images():
    """A flat tile's im2col rows: the traversal steps to the next row and
    the next image by itself, each pixel read at its tap and zero outside
    its own image (the padding) and past the last image."""
    x = torch.arange(1, 1 + 2 * 5 * 6 * 8, dtype=torch.float32).reshape(
        2, 5, 6, 8)
    centre = _im2col_tile(x, 0, tap=4, chunk=0)  # (dy, dx) = (0, 0)
    torch.testing.assert_close(centre[:60, :8], x.reshape(60, 8))
    assert not centre[60:].any() and not centre[:, 8:].any()
    corner = _im2col_tile(x, 0, tap=0, chunk=0)  # (-1, -1)
    assert not corner[:7].any() and not corner[30].any()  # row 0, image 1
    torch.testing.assert_close(corner[7, :8], x[0, 0, 0])
    torch.testing.assert_close(corner[37, :8], x[1, 0, 0])


@pytest.mark.parametrize("n,h,w,cd,cu,cout", [
    (2, 5, 7, 24, 80, 16),   # tiles across images, ragged last tile
    (3, 7, 7, 72, 0, 8),     # level 4's shape: u=None, 147 pixels
    (1, 14, 14, 16, 8, 4),   # level 3's shape: 196 pixels
])
def test_flat_im2col_tiles_sum_to_conv(n, h, w, cd, cu, cout):
    """Summed over K, the im2col tiles of flat M tiles give F.conv2d of
    the (d, u) pair with SAME padding, as the patch tiles do."""
    rng = np.random.default_rng(8)
    t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    inputs = [t(n, h, w, cd)] + ([t(n, h, w, cu)] if cu else [])
    hwio = [t(3, 3, x.shape[-1], cout) for x in inputs]
    wt = tfd._k_major([k.reshape(-1, cout) for k in hwio], torch.float32)
    want = sum(F.conv2d(_nchw(x), k.permute(3, 2, 0, 1), padding=1)
               for x, k in zip(inputs, hwio)).permute(0, 2, 3, 1)
    torch.testing.assert_close(_flat_gemm(inputs, wt), want, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES + [(1, 6, 6, 65, 64, 64, 64, 3)])
def test_packed_level_matches_jax_layouts(case, dtype):
    """A ``PackedLevel`` (the kernel's layout: K-major, the skip padded
    for the tensor cores, float32 split into tf32 hi over lo where the
    widths take them) runs both wrappers' plain version to the JAX-layout
    call's answer: exactly where nothing is split or padded, within the
    split's 2^-22 of each weight where it is, and within bf16 ulps where
    a padded bf16 skip sums its float32 products in another order (as
    ``test_bf16_pads_odd_skip_exactly``); ``unpack_level`` gives the
    packed weights back."""
    n, h, w, cd, cu, cm, co, fk = case
    d, u, *ws = map(_t, _inputs(9, *case))
    d = d.to(dtype)
    u = None if u is None else u.to(dtype)
    p = tfd.pack_level(*ws, fk, dtype)
    wide = tfd.skip_width(dtype, cd, cu, cm, co, fk)
    assert p.widths == (wide, cu, cm, co) and p.final_kernel == fk
    assert p.split == (dtype == torch.float32
                       and tfd.tensor_core_widths(dtype, wide, cu, cm, co, fk))
    w1d, w1u, b1, w2, b2 = tfd.unpack_level(p)
    want_w = tfd.kernel_args(d, u, *ws, fk)[2:]
    for got_t, want_t in zip((w1d, w1u, b1, w2, b2), want_w):
        assert (got_t is None) == (want_t is None)
        if got_t is not None:
            torch.testing.assert_close(got_t.float(), want_t.float(),
                                       rtol=2.0 ** -21 if p.split else 0,
                                       atol=0)
    dp = F.pad(d, (0, wide - cd))
    want = tfd.fused_decoder_level(d, u, *ws, final_kernel=fk)
    tol = 1e-5 if p.split else (1e-2 if wide != cd else 0)
    for got in (tfd.fused_decoder_level(dp, u, p, final_kernel=fk),
                tfd.fused_decoder_level_tiled(dp, u, p, row_tile=3,
                                              final_kernel=fk)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_packed_level_rejects_what_it_was_not_packed_for():
    d, u, *ws = map(_t, _inputs(4, 1, 4, 4, 8, 8, 8, 8, 3))
    p = tfd.pack_level(*ws, 3, torch.float32)
    with pytest.raises(ValueError, match="final_kernel"):
        tfd.fused_decoder_level(d, u, p, final_kernel=1)
    with pytest.raises(ValueError, match="channels"):
        tfd.fused_decoder_level(d[..., :4].contiguous(), u, p)
    with pytest.raises(ValueError, match="u shape"):
        tfd.fused_decoder_level(d, None, p)
    with pytest.raises(TypeError, match="packed"):
        tfd.fused_decoder_level(d.bfloat16(), u.bfloat16(), p)
    with pytest.raises(TypeError, match="PackedLevel"):
        tfd.fused_decoder_level(d, u, *ws[:4])


def _two_pass(d, u, w1d, w1u, b1, w2, b2, final_kernel, mm=None):
    """The kernel's two launches in torch (``_prepare``'s arguments): conv1
    over (d, u) into h1 rounded to d's dtype, then conv2 over h1 with SAME
    zero padding (or the 1x1 head), float32 sums, y in d's dtype.  With a
    product ``mm`` the 3x3 convs run as the kernel's k-steps over 8x8
    patches (``_implicit_gemm``), each k-step's product by ``mm``; the
    head stays a float32 matmul, as in the kernel's epilogue."""
    dt = d.dtype
    if mm is not None:
        cm, co = w1d.shape[-1], w2.shape[-1]
        inputs = [d.float()] + ([] if u is None else [u.float()])
        w1t = tfd._k_major([w1d.reshape(-1, cm)]
                           + ([] if u is None else [w1u.reshape(-1, cm)]),
                           torch.float32)
        acc = _implicit_gemm(inputs, w1t, 8, 8, mm=mm)
        h1 = F.relu(acc + b1).to(dt).float()
        if final_kernel == 3:
            w2t = tfd._k_major([w2.reshape(-1, co)], torch.float32)
            y = _implicit_gemm([h1], w2t, 8, 8, mm=mm)
        else:
            y = h1 @ w2.float()
        return F.relu(y + b2).to(dt)
    oihw = lambda k: k.float().reshape(3, 3, -1, k.shape[-1]).permute(3, 2, 0, 1)  # noqa: E731
    acc = F.conv2d(_nchw(d), oihw(w1d), padding=1)
    if u is not None:
        acc = acc + F.conv2d(_nchw(u), oihw(w1u), padding=1)
    h1 = F.relu(acc + b1.view(1, -1, 1, 1)).to(dt).float()
    if final_kernel == 3:
        y = F.conv2d(h1, oihw(w2), padding=1).permute(0, 2, 3, 1)
    else:
        y = h1.permute(0, 2, 3, 1) @ w2.float()
    return F.relu(y + b2).to(dt)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case,row_tile", [
    ((2, 8, 8, 16, 24, 16, 16, 3), 4),
    ((2, 16, 12, 8, 16, 8, 1, 1), 4),   # 1x1 head
    ((2, 9, 10, 17, 16, 16, 8, 3), 3),  # v2 odd skip width
])
def test_two_pass_matches_tiles_plain_and_jax(case, row_tile, dtype, tol):
    """The kernel's structure (h1 through memory, no halo) equals the TPU
    kernels' tile loop (``decoder_tiles_plain``, whole image and row
    tiles) and the interpret-mode Pallas kernels, whole-image and tiled:
    float32 at 1e-4, bf16 at 2e-2 (h1 and y round to bf16 at other sums)."""
    args = _inputs(7, *case)
    fk = case[-1]
    h, w = case[1:3]
    d, u, *ws = map(_t, args)
    prepared = tfd._prepare(d.to(dtype), u.to(dtype), *ws, fk)
    got = _two_pass(*prepared, fk).float()
    cdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wants = {
        "whole": tfd.decoder_tiles_plain(*prepared, fk, h, w),
        "rows": tfd.decoder_tiles_plain(*prepared, fk, row_tile, w),
        "jax": jax_level(*map(_j, args), final_kernel=fk, compute_dtype=cdt,
                         interpret=True),
        "jax_tiled": jax_tiled(*map(_j, args), row_tile=row_tile,
                               final_kernel=fk, compute_dtype=cdt,
                               interpret=True),
    }
    for name, want in wants.items():
        want = (want.float() if isinstance(want, torch.Tensor)
                else torch.tensor(np.asarray(want, dtype=np.float32)))
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
