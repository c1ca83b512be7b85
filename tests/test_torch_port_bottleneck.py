"""Port fused bottleneck (srsem_torch/ops/fused_bottleneck.py) vs the JAX
Pallas kernels (srsem/ops/fused_bottleneck.py, interpret mode).

On the CPU the wrappers run the plain version — the CUDA kernel's tile
loop (halo, h1 masking, ragged edges) in torch ops — so these tests reach
the kernel's indexing.  Tolerances are the JAX package's own
(tests/test_fused_bottleneck.py): 1e-4 whole-image, 1e-5 tiled.  The card
tests are in tests/test_torch_port_cuda.py.
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


@pytest.mark.parametrize("image", [224, 512])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_pick_tile_fits_every_stage(image, itemsize):
    """Every main-path stage gets a tile within the 227 KB of shared
    memory, in float32 and bf16, at 224 and 512 px."""
    for s, (c, wd) in enumerate([(256, 64), (512, 128), (1024, 256),
                                 (2048, 512)]):
        hw = image // (4 * 2 ** s)
        for row_tile in (None, 8):
            th, tw = tfb.pick_tile(hw, hw, wd, itemsize, row_tile)
            assert tfb.bottleneck_smem_bytes(th, tw, wd, itemsize) <= tfb.SMEM_LIMIT
            assert 1 <= th <= hw and 1 <= tw <= hw
            if row_tile:
                assert th == min(row_tile, hw)
    # Stage 0 at 224 px: bf16 keeps full rows; f32 row tile 8 splits columns.
    assert tfb.pick_tile(56, 56, 64, 2, 8) == (8, 56)
    assert tfb.pick_tile(56, 56, 64, 4, 8) == (8, 28)


@pytest.mark.parametrize("hw,c,wd,want", [(28, 512, 128, (7, 28)),
                                          (14, 1024, 256, (7, 14)),
                                          (7, 2048, 512, (4, 7))])
def test_wave_tile_main_path(hw, c, wd, want):
    """Batch 64 bf16 on 132 SMs: stage 1 takes 7-row tiles (256 blocks in
    2 waves) over the largest that fits (10 rows: 192 blocks, also 2
    waves, more work a block); stage 3 splits its 7 rows to fill a wave."""
    got = tfb.wave_tile(64, hw, hw, c, wd, 2, 132)
    assert got == want
    assert tfb.bottleneck_smem_bytes(*got, wd, 2) <= tfb.SMEM_LIMIT
    assert tfb.wave_tile(1, hw, hw, c, wd, 2, 132)[0] <= got[0]


@pytest.mark.parametrize("case", ["rank", "dtype", "contiguous", "w2", "b3",
                                  "row_tile"])
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
