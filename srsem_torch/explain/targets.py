"""Scalar objectives differentiated to produce CAMs — the port of
srsem/explain/targets.py.

The reference's Grad-CAM target classes
(reference: additional_approaches/src/my_pytorch_grad_cam_targets.py:7-48)
as closures over a fixed embedding.  Each closure takes a tensor (or a
numpy array) and computes on its device: the fixed embedding moves to it.
Arrays that are not tensors become float32 tensors, as ``jnp.asarray``
makes float32 of them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def as_tensor(x) -> Tensor:
    """``x`` as a tensor: a tensor as it is, anything else float32."""
    if isinstance(x, Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def _reduce(values: Tensor, reduction: str) -> Tensor:
    if reduction == "mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    if reduction == "none":
        return values
    raise ValueError(f"unsupported reduction {reduction!r}")


def mse_target(target, reduction: str = "mean") -> Callable[[Tensor], Tensor]:
    """MSE against a fixed embedding (reference :7-13)."""
    target = as_tensor(target)

    def fn(model_output) -> Tensor:
        out = as_tensor(model_output)
        return _reduce((out - target.to(out.device)) ** 2, reduction)

    return fn


def unit(v: Tensor) -> Tensor:
    """``v`` scaled to unit length along its last dimension (norm floor
    1e-12)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def cosine_similarity_target(target, reduction: str = "mean"
                             ) -> Callable[[Tensor], Tensor]:
    """Cosine similarity against a fixed (pre-normalized) embedding
    (reference :15-40)."""
    t = unit(as_tensor(target))

    def fn(model_output) -> Tensor:
        out = as_tensor(model_output)
        cos = torch.sum(t.to(out.device) * unit(out), dim=-1)
        return _reduce(cos, reduction)

    return fn


def vector_sum_target(_target=None, reduction: str = "mean"
                      ) -> Callable[[Tensor], Tensor]:
    """Plain sum of the output vector (reference :42-48)."""

    def fn(model_output) -> Tensor:
        return as_tensor(model_output).sum()

    return fn
