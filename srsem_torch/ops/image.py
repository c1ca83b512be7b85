"""Image ops — the port of srsem/ops/image.py.

Two bilinear conventions stay distinct, as in the reference:

* ``upsample_x2_align_corners`` — torch ``nn.UpsamplingBilinear2d(2)``,
  align_corners=True (reference: models/local_eval_models.py:84, the UNet
  upscaler);
* ``resize_bilinear`` — ``F.interpolate(mode='bilinear',
  align_corners=False)``, half-pixel centers (the v2 pixel channel,
  reference: models/local_eval_models.py:449-456).

Both are ``F.interpolate`` without antialiasing on NHWC tensors, which
computes what srsem/ops/image.py::resize_bilinear_mxu does with its
interpolation matrices (``_resize_matrix``): the same source coordinates
and weights, in float32.  ``interpolate_pos_embed`` follows
``jax.image.resize(..., "bilinear")``, which antialiases when it
downsamples: its triangle-kernel weights are written out here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Tensor = torch.Tensor


def resize_bilinear(x: Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> Tensor:
    """Bilinear resize of NHWC ``x`` (no antialiasing), in x's dtype."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample_x2_align_corners(x: Tensor) -> Tensor:
    """The UNet's x2 upsampler (align_corners=True) on NHWC ``x``."""
    return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]),
                           align_corners=True)


def _triangle_weights(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize(..., "bilinear")`` along one
    axis: a triangle kernel at half-pixel sample points, widened by the
    downsampling factor (antialiasing), normalised per output, and zero
    for samples outside the input (jax/_src/image/scale.py)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def interpolate_pos_embed(pos: Tensor, grid_hw: Tuple[int, int]) -> Tensor:
    """Resize a [cls | H*W grid] positional table to a new patch grid:
    bilinear over the square source grid as ``jax.image.resize`` does it
    (antialiased when shrinking), cls token untouched.  Accepts (T, C) or
    (1, T, C)."""
    p = pos if pos.dim() == 3 else pos[None]
    gh, gw = grid_hw
    if p.shape[1] == gh * gw + 1:
        return pos
    c = p.shape[-1]
    side = int(round(float(p.shape[1] - 1) ** 0.5))
    grid = p[0, 1:].reshape(side, side, c).float()
    wh = torch.from_numpy(_triangle_weights(gh, side)).to(pos.device)
    ww = torch.from_numpy(_triangle_weights(gw, side)).to(pos.device)
    grid = torch.einsum("oh,hwc->owc", wh, grid)
    grid = torch.einsum("pw,owc->opc", ww, grid).reshape(1, gh * gw, c)
    out = torch.cat([p[:, :1].float(), grid], dim=1).to(pos.dtype)
    return out if pos.dim() == 3 else out[0]
