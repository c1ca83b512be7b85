"""Bilinear resize in numpy — a copy of srsem/ops/npimage.py.

Host-side pipeline stages (a dataset's ``__getitem__`` in the loader's
threads) resize on the host: a per-sample device op from every loader
thread would serialize against the train step and add a host-device round
trip an item.  The f32 gather+lerp semantics (both align_corners
conventions, the same clip/floor order) are those of the JAX package's
``srsem.ops.image.resize_bilinear``, so labels prepared here equal labels
prepared there (tests/test_torch_port_data.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _axis_weights_np(out_size: int, in_size: int, align_corners: bool):
    out_idx = np.arange(out_size, dtype=np.float32)
    if align_corners:
        if out_size == 1:
            coords = np.zeros((1,), np.float32)
        else:
            coords = out_idx * np.float32((in_size - 1) / (out_size - 1))
    else:
        coords = (out_idx + np.float32(0.5)) * np.float32(
            in_size / out_size) - np.float32(0.5)
        coords = np.clip(coords, 0.0, np.float32(in_size - 1))
    lo = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = coords - lo.astype(np.float32)
    return lo, hi, frac


def resize_bilinear_np(x: np.ndarray, out_hw: Tuple[int, int],
                       align_corners: bool = False) -> np.ndarray:
    """Rank 2 = (H, W); rank >= 3 = (..., H, W, C)."""
    x = np.asarray(x)
    if x.ndim == 2:
        return resize_bilinear_np(x[..., None], out_hw, align_corners)[..., 0]

    h_axis, w_axis = x.ndim - 3, x.ndim - 2
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    dtype = x.dtype
    xf = x.astype(np.float32)

    lo, hi, frac = _axis_weights_np(out_h, in_h, align_corners)
    top = np.take(xf, lo, axis=h_axis)
    bot = np.take(xf, hi, axis=h_axis)
    frac_h = frac.reshape((-1,) + (1,) * (x.ndim - 1 - h_axis))
    xf = top * (1.0 - frac_h) + bot * frac_h

    lo, hi, frac = _axis_weights_np(out_w, in_w, align_corners)
    left = np.take(xf, lo, axis=w_axis)
    right = np.take(xf, hi, axis=w_axis)
    frac_w = frac.reshape((-1,) + (1,) * (x.ndim - 1 - w_axis))
    xf = left * (1.0 - frac_w) + right * frac_w
    return xf.astype(dtype)
