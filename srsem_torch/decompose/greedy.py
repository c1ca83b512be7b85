"""Greedy text-span decomposition — the port of srsem/decompose/greedy.py.

The reference's ``greedy_decomposer``
(reference: additional_approaches/src/greedy_decomposer.py:5-107): iterate
``rank`` times — pick the dictionary concept with the largest dot product
against the residual target, record it, subtract its projection from the
target AND from every remaining concept (deflation), then reconstruct in
one of five modes.

The JAX package's ``lax.scan`` is a loop of ``rank`` steps on the
dictionary's device; the argmax index stays there (``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does), so no step reads back
to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.explain.targets import unit

Tensor = torch.Tensor

MODES = ("debug", "w_filt_rec", "filt_rec", "w_rec", "rec")


def _greedy_span(concepts: Tensor, target: Tensor, rank: int
                 ) -> Tuple[Tensor, Tensor]:
    """Returns (selected_idx (rank,), filtered_components C_ (rank, d))."""
    meta_target, meta_concepts = target, concepts
    idxs, comps = [], []
    for _ in range(rank):
        j = torch.argmax(meta_concepts @ meta_target)
        concept = meta_concepts[j]
        n_concept = unit(concept)
        # Deflate target and the whole dictionary.
        meta_target = meta_target - n_concept * torch.dot(n_concept, meta_target)
        proj = meta_concepts @ n_concept
        meta_concepts = meta_concepts - proj[:, None] * n_concept[None, :]
        idxs.append(j)
        comps.append(concept)
    return torch.stack(idxs), torch.stack(comps)


def _cosine(a: Tensor, b: Tensor) -> Tensor:
    return (b @ a) / (torch.linalg.vector_norm(b, dim=-1)
                      * torch.linalg.vector_norm(a)).clamp_min(1e-12)


class GreedyDecomposer:
    """modes (reference :10-19): debug → (C_, C, texts); *_rec →
    reconstruction from filtered (C_) or original (C) concept embeddings,
    plain mean or cosine-weighted sum.  Tensors on ``device`` (default
    the card)."""

    def __init__(self, concepts, vocab: Optional[Sequence[str]] = None,
                 rank: int = 50, mode: str = "debug",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.concepts = torch.as_tensor(concepts, dtype=torch.float32,
                                        device=self.device)
        self.vocab = np.asarray(vocab) if vocab is not None else None
        self.rank = rank
        self.mode = mode

    def __call__(self, target):
        target = torch.as_tensor(target, dtype=torch.float32,
                                 device=self.device)
        idxs, comps = _greedy_span(self.concepts, target, self.rank)
        originals = self.concepts[idxs]
        if self.mode == "debug":
            host = idxs.cpu().numpy()
            texts = (list(self.vocab[host]) if self.vocab is not None
                     else list(host))
            return comps, originals, texts
        if self.mode in ("w_filt_rec", "w_rec"):
            basis = comps if self.mode == "w_filt_rec" else originals
            cos = _cosine(target, basis)
            # Reference math (greedy_decomposer.py:78-107) with only the
            # exact-zero denominator guarded, sign-preserving — mixed-sign
            # cosines summing to ~0 would otherwise emit NaN/Inf weights.
            s = cos.sum()
            s = torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)
            return torch.sum(basis * (cos / s)[:, None], dim=0)
        if self.mode == "filt_rec":
            return comps.mean(dim=0)
        if self.mode == "rec":
            return originals.mean(dim=0)
        raise ValueError(f"unknown mode {self.mode!r}")
