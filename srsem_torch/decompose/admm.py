"""ADMM solver for positive-Lasso concept decomposition — the port of
srsem/decompose/admm.py.

Minimizes ``‖Cᵀw − v‖² + λ‖w‖₁  s.t. w ≥ 0`` by scaled ADMM
(reference: additional_approaches/src/my_splice/admm.py:3-47): the
x-update solves against the cached Cholesky factor of ``2CCᵀ + ρI`` (one
c×c factor a dictionary, cuSOLVER on the card) with two triangular solves,
the z-update is a positive soft-threshold, u the scaled dual.  Float32
throughout, on the dictionary's device.

The JAX package's ``lax.while_loop`` is a Python loop here with JAX's
stopping rule exactly: iterates start at zero, at least one step runs,
the loop stops once both the primal residual ``max_n ‖x − z‖`` and the
dual ``max_n ‖ρ(z − z_prev)‖`` are below ``tol``, or after ``max_iter``
steps.  Each step reads the two residuals back to the host once; ``_solve``
returns the weights with the number of steps taken.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from srsem_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class ADMMFactors(NamedTuple):
    """Per-dictionary cached factorization."""

    concepts: Tensor  # (c, dim) float32
    chol: Tensor      # (c, c) lower Cholesky factor of 2CCᵀ + ρI
    rho: float


def precompute_factors(concepts, rho: float = 5.0,
                       device: DeviceLike = None) -> ADMMFactors:
    """The factor of ``2CCᵀ + ρI`` for ``concepts`` (c, dim), on
    ``device`` (default the card)."""
    C = torch.as_tensor(concepts, dtype=torch.float32,
                        device=resolve_device(device))
    c = C.shape[0]
    Q = 2.0 * C @ C.T + rho * torch.eye(c, dtype=C.dtype, device=C.device)
    return ADMMFactors(concepts=C, chol=torch.linalg.cholesky(Q), rho=rho)


def _solve(factors: ADMMFactors, v: Tensor, l1_penalty: float, tol: float,
           max_iter: int) -> Tuple[Tensor, int]:
    """(weights (n, c), steps taken) for embeddings ``v`` (n, dim)."""
    C, L, rho = factors.concepts, factors.chol, factors.rho
    Cb2 = 2.0 * (C @ v.T)  # (c, n)
    # l1 rounded to float32 first, then divided by rho, as in JAX.
    thresh = torch.tensor(l1_penalty, dtype=torch.float32) / rho
    shift = float(thresh)

    def chol_solve(rhs: Tensor) -> Tensor:
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)

    z = torch.zeros(C.shape[0], v.shape[0], dtype=v.dtype, device=v.device)
    x, u = z, z
    steps = 0
    while steps < max_iter:
        if steps > 0:
            res = torch.stack([
                torch.linalg.vector_norm(x - z, dim=0).max(),
                torch.linalg.vector_norm(rho * (z - z_old), dim=0).max()])
            res_prim, res_dual = res.tolist()
            if res_prim < tol and res_dual < tol:
                break
        x = chol_solve(Cb2 + rho * (z - u))
        z_old, z = z, torch.clamp_min(x + u - shift, 0.0)
        u = u + x - z
        steps += 1
    return z.T, steps  # (n, c)


def admm_lasso(concepts, v, l1_penalty: float, rho: float = 5.0,
               tol: float = 1e-6, max_iter: int = 2000,
               factors: Optional[ADMMFactors] = None,
               device: DeviceLike = None) -> Tensor:
    """Solve the positive lasso for a batch of embeddings ``v`` (n, dim)
    against dictionary ``concepts`` (c, dim) → sparse weights (n, c), a
    float32 tensor on the factors' device.

    Pass precomputed ``factors`` to amortize the Cholesky across calls
    (the rank search calls this repeatedly with varying ``l1_penalty``);
    without them they are made on ``device`` (default the card).
    """
    if factors is None:
        factors = precompute_factors(concepts, rho, device)
    v = torch.as_tensor(v, dtype=torch.float32,
                        device=factors.concepts.device)
    return _solve(factors, v, float(l1_penalty), tol, max_iter)[0]
