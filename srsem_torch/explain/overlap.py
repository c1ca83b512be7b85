"""CAM comparison metrics — the port of srsem/explain/overlap.py:
similarity matrices, quantile binarization, overlap percentages
(reference: additional_approaches/src/eval_utils/compute_metrics.py:7-78).

Tensors are computed on their device; arrays go to ``device`` (default the
card), as ``jnp`` arrays go to JAX's default device.  Only the returned
numbers come to the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.explain.targets import as_tensor
from srsem_torch.ops.image import resize_bilinear

Tensor = torch.Tensor


def _on_device(x, device: DeviceLike) -> Tensor:
    """A tensor as it is; an array as a float32 tensor on ``device``."""
    if isinstance(x, Tensor):
        return x
    return as_tensor(x).to(resolve_device(device))


def similarity_matrix(vectors, target_factory: Callable,
                      dim_mean: bool = False,
                      device: DeviceLike = None) -> np.ndarray:
    """n×n matrix of target_factory(v_i)(v_j) scores (reference:
    compute_metrics.py:7-22).  The target applies to each v_j on its own,
    as ``jax.vmap`` applies it: a ``reduction="mean"`` target called on
    the whole (n, d) batch would average across rows."""
    vectors = _on_device(vectors, device)
    rows = []
    for i in range(vectors.shape[0]):
        fn = target_factory(vectors[i])
        out = torch.stack([fn(v) for v in vectors])
        if dim_mean and out.dim() > 1:
            out = out.mean(dim=-1)
        rows.append(out)
    # float32: numpy holds no bfloat16.
    return torch.stack(rows).float().cpu().numpy()


def binarize_top_percent(x, top_percent: float = 0.9,
                         device: DeviceLike = None) -> Tensor:
    """1 for values ≥ the (1 - top_percent) quantile, else 0
    (reference: compute_metrics.py:32-45; linear interpolation, as
    ``jnp.quantile``)."""
    x = _on_device(x, device).float()
    threshold = torch.quantile(x.reshape(-1), 1.0 - top_percent)
    return (x >= threshold).float()


def overlap_metrics(a, b, top_percent: float = 0.9,
                    device: DeviceLike = None) -> Tuple[float, float, float]:
    """(%A-in-B, %B-in-A, %overlap-of-total) between binarized heatmaps;
    ``b`` is bilinearly resized to ``a``'s shape first, on ``a``'s device
    (reference: compute_metrics.py:47-78)."""
    a = _on_device(a, device).float()
    b = as_tensor(b).float().to(a.device)
    if b.shape != a.shape:
        b = resize_bilinear(b[None, ..., None], tuple(a.shape))[0, ..., 0]
    bin_a = binarize_top_percent(a, top_percent)
    bin_b = binarize_top_percent(b, top_percent)
    overlap, total_a, total_b = torch.stack(
        [torch.sum(bin_a * bin_b), torch.sum(bin_a), torch.sum(bin_b)]).tolist()
    total_pixels = bin_a.numel()
    pct_a_in_b = (overlap / total_a) * 100 if total_a > 0 else 0.0
    pct_b_in_a = (overlap / total_b) * 100 if total_b > 0 else 0.0
    return pct_a_in_b, pct_b_in_a, (overlap / total_pixels) * 100
