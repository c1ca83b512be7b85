"""Port decoder-level wrappers (srsem_torch/ops/fused_decoder.py, plain
path on the CPU) vs the JAX Pallas kernels (srsem/ops/fused_decoder.py,
interpret mode), same inputs made with numpy.

Tiny shapes (N = 2, 8-16 px, 8-24 channels) cover the pair form and
``u=None``, ``final_kernel`` 1 and 3, row tiles with halos of 1 and 2 and
the v2 odd skip width.  f32; tolerance 2e-4, the JAX package's own for the
fused decoder (tests/test_fused_decoder.py:83-85).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_bf16_pads_odd_skip_exactly():
    """A v2 skip diff (Cd = 65) zero-padded to 128 channels for the tensor
    cores, with zero rows in w1d, gives the unpadded level's answer."""
    d, u, w1d, w1u, b1, w2, b2 = map(_t, _inputs(3, 1, 6, 6, 65, 64, 64, 64, 3))
    d, u = d.bfloat16(), u.bfloat16()
    want_args = tfd._prepare(d, u, w1d, w1u, b1, w2, b2, 3)
    args = tfd.pad_skip(want_args, 128)
    assert args[0].shape[-1] == 128 and args[2].shape == (9, 128, 64)
    assert not args[0][..., 65:].any() and not args[2][:, 65:].any()
    want = tfd.decoder_tiles_plain(*want_args, 3, 6, 6)
    got = tfd.decoder_tiles_plain(*args, 3, 6, 6)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


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
