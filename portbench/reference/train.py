"""Plain float32 CLU decoder training steps: the decoder on batch
statistics over given tower taps, masked MSE, and Adam written out
(torch's defaults: betas 0.9 and 0.999, eps 1e-8, bias-corrected).

The steps start from the raw weights, or from a saved state (the leaves,
BatchNorm statistics, Adam's moments and step count) to follow one more
step.  ``fault="half"`` plants a fault a training step can have (half of
the batch left out, the mean taken over the rest), for the readings that
set a training cell's limits; a step that returns its state unchanged
reads 1 by the change's measure and needs no run.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from portbench.reference.heads import clu_maps, ident, masked_mse
from portbench.reference.towers import Rounding, clip_taps

Tensor = torch.Tensor

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def trainable_keys(sd: Dict[str, Tensor]) -> List[str]:
    """The decoder's convs and BatchNorm affines (every parameter outside
    the tower)."""
    return [k for k in sd if k.startswith("decoder.")
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]


def stat_keys(sd: Dict[str, Tensor]) -> List[str]:
    """The decoder's BatchNorm running statistics."""
    return [k for k in sd if k.startswith("decoder.")
            and k.endswith(("running_mean", "running_var"))]


def tower_taps(a: Tensor, b: Tensor, sd, rounding: Rounding = Rounding(),
               chunk: int = 40):
    """Taps of the 2N normalized NHWC images, in blocks of ``chunk``."""
    x = torch.cat([a, b]).permute(0, 3, 1, 2)
    parts = [clip_taps(x[i:i + chunk], sd, rounding=rounding)
             for i in range(0, x.shape[0], chunk)]
    taps = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    n = a.shape[0]
    return ({k: v[:n] for k, v in taps.items()},
            {k: v[n:] for k, v in taps.items()})


def train_steps(sd: Dict[str, Tensor], batches, lr: float,
                decoder_ctx: Callable = contextlib.nullcontext,
                q: Callable = ident, fault: Optional[str] = None,
                start: Optional[dict] = None) -> dict:
    """Adam steps on ``batches``, each ``((taps_a, taps_b), y, mask)`` on
    the device: from the raw weights ``sd``, or from ``start`` (``leaves``,
    ``stats``, ``m``, ``v`` and ``t``, Adam's step count so far).
    ``decoder_ctx`` and ``q`` lower the decoder's precision for a control.
    Returns each step's loss, the first step's gradients, and the
    trainable leaves and BN statistics after the last step."""
    start = start or {}
    state = dict(sd)
    params = {k: start.get("leaves", sd)[k].clone().requires_grad_(True)
              for k in trainable_keys(sd)}
    state.update(params)
    state.update({k: start.get("stats", sd)[k].clone() for k in stat_keys(sd)})
    m = {k: start["m"][k].clone() if "m" in start else torch.zeros_like(p)
         for k, p in params.items()}
    v = {k: start["v"][k].clone() if "v" in start else torch.zeros_like(p)
         for k, p in params.items()}
    losses, first = [], None
    for t, ((taps_a, taps_b), y, mask) in enumerate(batches,
                                                    start.get("t", 0) + 1):
        if fault == "half":
            h = y.shape[0] // 2
            taps_a = {k: x[:h] for k, x in taps_a.items()}
            taps_b = {k: x[:h] for k, x in taps_b.items()}
            y, mask = y[:h], mask[:h]
        with decoder_ctx():
            loss = masked_mse(clu_maps(taps_a, taps_b, state, train=True,
                                       q=q), y, mask)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(BETA1).add_((1 - BETA1) * g)
                v[k].mul_(BETA2).add_((1 - BETA2) * g * g)
                denom = (v[k] / (1 - BETA2 ** t)).sqrt() + EPS
                p.sub_(lr / (1 - BETA1 ** t) * m[k] / denom)
    return {"losses": losses, "grads": first,
            "leaves": {k: p.detach() for k, p in params.items()},
            "stats": {k: state[k] for k in stat_keys(sd)}}
