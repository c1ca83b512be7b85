"""srsem_torch/explain/iqa.py against srsem/explain/iqa.py on the same
seeded numpy images: PSNR, SSIM and both maps at 1e-5, maps at even and
odd windows (the box filter's asymmetric replicate pad keeps (H, W) for
even windows; the SSIM map is the valid region)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.explain import iqa as jiqa
from srsem_torch.explain import iqa as tiqa
from test_torch_port_train import _two_threads  # noqa: F401 — fixture


def _pair(seed, shape=(2, 40, 36, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, y


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_psnr_and_ssim_match_jax(data_range):
    x, y = _pair(0)
    x, y = x * data_range, y * data_range
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(tiqa.psnr(tx, ty, data_range), jiqa.psnr(x, y, data_range))
    _close(tiqa.ssim(tx, ty, data_range), jiqa.ssim(x, y, data_range))
    # Identical images: the MSE clamps at 1e-12, SSIM is one.
    _close(tiqa.psnr(tx, tx, data_range), jiqa.psnr(x, x, data_range))
    np.testing.assert_allclose(tiqa.ssim(tx, tx, data_range).numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("window", [4, 7, 11])
def test_maps_match_jax(window):
    x, y = _pair(1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tiqa.psnr_map(tx, ty, window=window)
    assert got.shape == x.shape[:3]
    _close(got, jiqa.psnr_map(jnp.asarray(x), jnp.asarray(y), window=window))
    got = tiqa.ssim_map(tx, ty, window=window)
    assert got.shape == (2, 40 - window + 1, 36 - window + 1)
    _close(got, jiqa.ssim_map(jnp.asarray(x), jnp.asarray(y), window=window))
