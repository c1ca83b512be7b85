"""Classical image-quality metrics — the port of srsem/explain/iqa.py.

* ``psnr`` — 10·log10(data_range² / mse), the MSE clamped at 1e-12;
* ``ssim`` — Gaussian-window (11, σ=1.5) SSIM with K1=0.01, K2=0.03, per
  channel then averaged, over the VALID region (no padding);
* ``psnr_map`` / ``ssim_map`` — per-pixel maps.  ``psnr_map`` averages
  the squared error over a replicate-padded window×window neighborhood,
  padded ``(window // 2, window - 1 - window // 2)`` so that even windows
  keep (N, H, W) too; ``ssim_map`` is the valid SSIM map, (N, H-10, W-10)
  at the default window.

The separable filters are two grouped ``F.conv2d`` (H then W), as the JAX
package's two depthwise XLA convolutions.  All functions take NHWC float
tensors in [0, data_range] on any device and compute in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _separable_filter(x: Tensor, kernel_1d: Tensor) -> Tensor:
    """Valid-mode depthwise filter of NCHW ``x``: the 1-D kernel along H,
    then along W."""
    c, window = x.shape[1], kernel_1d.shape[0]
    k = kernel_1d.to(x)
    x = F.conv2d(x, k.view(1, 1, window, 1).expand(c, 1, window, 1),
                 groups=c)
    return F.conv2d(x, k.view(1, 1, 1, window).expand(c, 1, 1, window),
                    groups=c)


def _nchw(x: Tensor) -> Tensor:
    return x.float().permute(0, 3, 1, 2)


def _box_filter_mean(x: Tensor, window: int) -> Tensor:
    """Per-pixel mean over a replicate-padded window×window neighborhood of
    NCHW ``x``; the pad is (half, window-1-half) on each axis, so the
    output keeps (H, W) for even windows as well."""
    half = window // 2
    x = F.pad(x, (half, window - 1 - half, half, window - 1 - half),
              mode="replicate")
    return _separable_filter(x, torch.full((window,), 1.0 / window))


def _gaussian_kernel(window: int, sigma: float) -> np.ndarray:
    coords = np.arange(window) - (window - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: Tensor, window: int, sigma: float) -> Tensor:
    return _separable_filter(x, torch.from_numpy(_gaussian_kernel(window,
                                                                  sigma)))


def psnr(x: Tensor, y: Tensor, data_range: float = 1.0) -> Tensor:
    """Per-image PSNR over NHWC batches → (N,)."""
    mse = ((x.float() - y.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _ssim_full(x: Tensor, y: Tensor, data_range: float, window: int,
               sigma: float) -> Tensor:
    """The valid SSIM map per channel, NCHW."""
    x, y = _nchw(x), _nchw(y)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    g = lambda v: _gaussian_filter(v, window, sigma)  # noqa: E731
    mu_x, mu_y = g(x), g(y)
    sxx = g(x * x) - mu_x ** 2
    syy = g(y * y) - mu_y ** 2
    sxy = g(x * y) - mu_x * mu_y
    return ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2))


def ssim(x: Tensor, y: Tensor, data_range: float = 1.0, window: int = 11,
         sigma: float = 1.5) -> Tensor:
    """Per-image mean SSIM over NHWC batches → (N,)."""
    return _ssim_full(x, y, data_range, window, sigma).mean(dim=(1, 2, 3))


def psnr_map(x: Tensor, y: Tensor, window: int = 11,
             data_range: float = 1.0) -> Tensor:
    """Per-pixel PSNR over replicate-padded windows, NHWC → (N, H, W)."""
    err = (_nchw(x) - _nchw(y)) ** 2
    local_mse = _box_filter_mean(err, window).mean(dim=1)
    return 10.0 * torch.log10(data_range ** 2 / local_mse.clamp_min(1e-12))


def ssim_map(x: Tensor, y: Tensor, window: int = 11, sigma: float = 1.5,
             data_range: float = 1.0) -> Tensor:
    """Per-pixel SSIM map (valid region, channel-averaged) → (N, H', W')."""
    return _ssim_full(x, y, data_range, window, sigma).mean(dim=1)
