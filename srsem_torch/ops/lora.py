"""LoRA (low-rank adaptation) for conv kernels — the port of
srsem/ops/lora.py.

Replaces the reference's ``pytora.apply_lora(self.clip, lora_r=rank)``
(reference: models/local_eval_models.py:6,23).  A conv kernel carries two
trainable factors, ``lora_a`` (kh·kw·cin, r), zero at init, and ``lora_b``
(r, cout), Kaiming-normal over fan-in r; the effective kernel is
``W + reshape(A @ B) / r``, so training starts from the frozen tower
exactly.  The factors keep the JAX package's shapes, so a checkpoint's
``lora_a`` / ``lora_b`` leaves load as they are.

The factorization treats the kernel as a ``(kh*kw*cin, cout)`` matrix in
HWIO order, the JAX package's layout; the port's convs are OIHW, so the
delta is reshaped in HWIO order and then permuted (reshaping straight to
OIHW would give a different delta of the same shape).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LORA_LEAVES = ("lora_a", "lora_b")


def lora_delta(a: torch.Tensor, b: torch.Tensor,
               kshape: Tuple[int, int, int, int]) -> torch.Tensor:
    """The OIHW kernel delta of factors ``a`` (kh·kw·cin, r) and ``b``
    (r, cout) for the HWIO kernel shape ``kshape``, in float32."""
    kh, kw, cin, cout = kshape
    scale = 1.0 / a.shape[1]
    return ((a @ b).reshape(kh, kw, cin, cout) * scale).permute(3, 2, 0, 1)


def init_lora_(a: torch.Tensor, b: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """JAX's init in place: ``a`` zero, ``b`` Kaiming-normal (flax's
    truncated normal, variance 2 / fan-in, fan-in r)."""
    with torch.no_grad():
        a.zero_()
        std = math.sqrt(2.0 / b.shape[0]) / 0.87962566103423978
        torch.nn.init.trunc_normal_(b, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)


def is_lora_path(path: Tuple[str, ...]) -> bool:
    return any(p in LORA_LEAVES for p in path)
