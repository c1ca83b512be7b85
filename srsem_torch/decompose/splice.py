"""SpLiCE: sparse nonnegative decomposition of embeddings over a concept
dictionary — the port of srsem/decompose/splice.py.

The reference's ``splice_wrapper``
(reference: additional_approaches/src/my_splice/splice_module.py:8-318) and
its l1-only sibling (splice_module_l1.py):

* ``decompose(emb, l1=...)`` — positive lasso at a fixed l1 penalty;
* ``decompose(emb, rank=...)`` — search the l1 penalty until the solution
  has exactly ``rank`` nonzeros, seeded/updated through a host-side
  {l0-norm → l1} hint cache (reference :66-207; cache JSONs mirror
  ``splice_files/l1p_hint_*.json``);
* ``weights2words`` / ``recompose`` (reference :289-318).

Solvers: "admm" (srsem_torch/decompose/admm.py: the Cholesky factor lives
on the decomposer's device, default the card, made once) and "skl"
(sklearn's positive Lasso with the reference's ``alpha = l1 / (2·dim)``,
host, lazily imported — reference :224-236).  Embeddings, weights and
reconstructions are host numpy arrays, as the JAX package's are: each
ADMM solve comes back as one float32 array.  The rank search is host
Python (its trip count is data-dependent and it mutates the hint cache).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Sequence

import numpy as np

from srsem_torch.decompose.admm import admm_lasso, precompute_factors
from srsem_torch.device import DeviceLike, resolve_device


def _normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / np.clip(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12, None)


class SpliceDecomposer:
    def __init__(
        self,
        concepts: np.ndarray,
        image_mean: np.ndarray,
        vocab: Optional[Sequence[str]] = None,
        l1_hints: Optional[Dict[int, float]] = None,
        rank_search_max_iter: int = 1000,
        rho: float = 5.0,
        device: DeviceLike = None,
    ):
        """``concepts``: (c, dim) concept embeddings; ``image_mean``: (dim,)
        modality mean; ``vocab``: c concept strings (LAION-10k in the
        reference — note its file is named laion1000_vocab.json but holds
        10,000 words, SURVEY.md §2.7); ``device``: where the ADMM factor
        lives and solves run."""
        self.device = resolve_device(device)
        self.concepts = np.asarray(concepts, np.float32)
        self.image_mean = np.asarray(image_mean, np.float32)
        self.vocab = np.asarray(vocab) if vocab is not None else None
        self.rank_search_max_iter = rank_search_max_iter
        # hint cache: {solver: {l0_norm: l1_penalty}}.  ``l1_hints``
        # accepts both a flat {rank: l1} mapping (applied to admm — the
        # reference's precomputed l1p_hint_*.json files) and the nested
        # {"skl": {...}, "admm": {...}} form save_l1p_hint writes, so the
        # save → with_hints_file round-trip works.
        self.l1p_hint: Dict[str, Dict[int, float]] = {"skl": {}, "admm": {}}
        if l1_hints:
            nested = (set(l1_hints) <= {"skl", "admm"}
                      and all(isinstance(v, dict) for v in l1_hints.values()))
            per_solver = (l1_hints if nested else {"admm": l1_hints})
            for solver, hints in per_solver.items():
                self.l1p_hint[solver].update(
                    {int(k): float(v) for k, v in hints.items()})
        self._factors = precompute_factors(self.concepts, rho, self.device)

    # ---- hint cache ------------------------------------------------------

    @classmethod
    def with_hints_file(cls, concepts, image_mean, hints_path: str, **kw):
        with open(hints_path) as f:
            hints = json.load(f)
        return cls(concepts, image_mean, l1_hints=hints, **kw)

    def save_l1p_hint(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.l1p_hint, f)

    def _approximate_l1p(self, solver: str, rank: int) -> float:
        """Bracket the unknown l1 from known (rank, l1) points — rank and l1
        are inversely related (reference :89-149)."""
        known = self.l1p_hint[solver]
        ranks = np.array(list(known.keys()))
        higher = ranks[ranks > rank]
        lower = ranks[ranks < rank]
        lower_bound = known[int(higher.min())] if higher.size else 0.01
        upper_bound = known[int(lower.max())] if lower.size else 1.0
        return (upper_bound + lower_bound) / 2.0

    # ---- solvers ---------------------------------------------------------

    def _decompose_l1(self, emb: np.ndarray, solver: str, l1: float) -> np.ndarray:
        if solver == "admm":
            w = admm_lasso(self.concepts, emb, l1, factors=self._factors)
            return w.cpu().numpy()
        if solver == "skl":
            from sklearn import linear_model

            # sklearn's regularization is off by 2·dim vs ours
            # (reference :224-227).
            alpha = l1 / (2 * self.image_mean.shape[0])
            clf = linear_model.Lasso(alpha=alpha, fit_intercept=False,
                                     positive=True, max_iter=10000, tol=1e-6)
            rows = []
            for i in range(emb.shape[0]):
                clf.fit(self.concepts.T, emb[i])
                rows.append(np.asarray(clf.coef_, np.float32))
            return np.stack(rows)
        raise ValueError(f"unknown solver {solver!r}")

    def _decompose_rank(self, emb: np.ndarray, solver: str, rank: int,
                        return_attempts: bool = False):
        weights_batch, attempts_batch = [], []
        for i in range(emb.shape[0]):
            row = emb[i: i + 1]
            hints = self.l1p_hint[solver]
            l1p = hints.get(rank, None)
            if l1p is None:
                l1p = self._approximate_l1p(solver, rank)
            attempts: Dict[int, np.ndarray] = {}
            for _ in range(self.rank_search_max_iter):
                w = self._decompose_l1(row, solver, l1p)
                l0n = int(np.count_nonzero(w[0]))
                attempts[l0n] = w
                hints[l0n] = float(l1p)
                if l0n == rank:
                    break
                l1p = self._approximate_l1p(solver, rank)
            else:
                return None  # max iterations — reference returns None (:190-193)
            weights_batch.append(w[0])
            attempts_batch.append(attempts)
        if return_attempts:
            return attempts_batch
        return np.stack(weights_batch)

    # ---- public API ------------------------------------------------------

    def decompose(self, embedding: np.ndarray, solver: str = "admm",
                  l1: Optional[float] = None, rank: Optional[int] = None,
                  return_attempts: bool = False):
        """Decompose batched embeddings (n, dim) → sparse weights (n, c).

        Exactly one of ``l1`` / ``rank`` must be given (reference
        :245-278).  Embeddings are mean-centered then renormalized
        (the reference's effective preprocessing at :268-272)."""
        if (l1 is None) == (rank is None):
            raise ValueError("provide exactly one of l1 / rank")
        emb = np.asarray(embedding, np.float32)
        emb = _normalize(emb - self.image_mean)
        if l1 is not None:
            return self._decompose_l1(emb, solver, l1)
        return self._decompose_rank(emb, solver, rank, return_attempts)

    def weights2l0n(self, weights: np.ndarray) -> np.ndarray:
        return np.count_nonzero(np.asarray(weights), axis=1)

    def weights2words(self, weights: np.ndarray):
        """(l0_norms, words, scores) sorted by weight (reference :289-307)."""
        weights = np.asarray(weights)
        l0 = self.weights2l0n(weights)
        order = np.argsort(-weights, axis=1)
        words, scores = [], []
        for i in range(weights.shape[0]):
            top = order[i, : int(l0[i])]
            words.append(self.vocab[top] if self.vocab is not None else top)
            scores.append(weights[i, top])
        return l0, words, scores

    def recompose(self, weights: np.ndarray) -> np.ndarray:
        """weights @ concepts, renormalized, re-meaned (reference :309-318)."""
        recons = _normalize(np.asarray(weights) @ self.concepts)
        return _normalize(recons + self.image_mean)

    # ---- legacy API (reference splice_wrapper_old.py) --------------------

    def force_compute_basis(self, embedding: np.ndarray, rank: int,
                            initial_l1: Optional[float] = None,
                            return_attempts: bool = False,
                            max_iters: int = 1000, solver: str = "admm"):
        """Rank search by sigmoid-damped l1 stepping — the older search
        strategy (reference: splice_wrapper_old.py:16-73): overshoot →
        l1 += damp·l1/2, undershoot → l1 -= damp·l1/2, damping shrinking
        with the iteration count.  Single (1, dim) embedding."""
        emb = _normalize(np.asarray(embedding, np.float32) - self.image_mean)
        l1p = 0.25 if initial_l1 is None else initial_l1
        results = {}
        for it in range(1, max_iters + 1):
            w = self._decompose_l1(emb, solver, l1p)
            l0n = int(np.count_nonzero(w[0]))
            _, words, scores = self.weights2words(w)
            results[l0n] = {"l1p": l1p, "weights": w[0],
                            "trunc_scores": scores[0], "words": words[0]}
            if l0n == rank:
                return results if return_attempts else results[rank]
            damp = (-1 / (1 + math.exp(-(it / 200) - 3))) + 1
            l1p = l1p + damp * l1p / 2 if l0n > rank else l1p - damp * l1p / 2
        return None

    def project_to_basis(self, weights: np.ndarray, emb: np.ndarray,
                         solver: str = "admm") -> np.ndarray:
        """Project embeddings onto the concept support of previously-found
        weights: restrict the dictionary to the nonzero concepts, decompose
        with a near-zero l1, recompose — a comparable "filtered" embedding
        for the reconstruction (reference: splice_wrapper_old.py:120-167).
        The sub-decomposer solves on this one's device."""
        weights = np.atleast_2d(np.asarray(weights))
        emb = np.atleast_2d(np.asarray(emb, np.float32))
        out = []
        for b in range(weights.shape[0]):
            support = np.nonzero(weights[b])[0]
            sub = SpliceDecomposer(self.concepts[support], self.image_mean,
                                   device=self.device)
            w = sub.decompose(emb[b: b + 1], solver=solver, l1=1e-4)
            out.append(sub.recompose(w)[0])
        return np.stack(out)

    def find_all_basis_rank_range(self, embedding: np.ndarray,
                                  start_rank: int, end_rank: int,
                                  solver: str = "admm") -> Dict[int, np.ndarray]:
        """Decompositions for every rank in [start, end], sharing the hint
        cache across ranks (reference: splice_wrapper_old.py:169-228)."""
        out: Dict[int, np.ndarray] = {}
        for rank in range(start_rank, end_rank + 1):
            w = self.decompose(embedding, solver=solver, rank=rank)
            if w is not None:
                out[rank] = w
        return out
