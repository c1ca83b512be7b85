"""Evaluation metrics: MSE and SRCC (Spearman rank correlation) — a copy
of srsem/train/metrics.py (numpy only).

These are the reference's north-star comparisons (README reports SRCC/MSE of
each regressor vs the user study — reference: README.md:98-105).  SRCC runs
host-side on gathered predictions (a few hundred pairs), matching scipy's
tie-average convention.
"""

from __future__ import annotations

import numpy as np


def mse(pred, target) -> float:
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return float(np.mean((pred - target) ** 2))


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean rank), 1-based."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = ranks[order[i: j + 1]].mean()
        i = j + 1
    return ranks


def srcc(pred, target) -> float:
    """Spearman rank correlation coefficient."""
    pred = np.asarray(pred, np.float64).ravel()
    target = np.asarray(target, np.float64).ravel()
    if len(pred) < 2:
        return float("nan")
    rp, rt = _ranks(pred), _ranks(target)
    rp = rp - rp.mean()
    rt = rt - rt.mean()
    denom = np.sqrt((rp ** 2).sum() * (rt ** 2).sum())
    if denom == 0:
        return float("nan")
    return float((rp * rt).sum() / denom)
