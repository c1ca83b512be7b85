"""Train and eval steps — the port of srsem/train/steps.py.

One card, no mesh (multi-GPU waits for ROADMAP A9b).  The tower is frozen
in every step this module builds: it runs under ``torch.no_grad`` through
``tower`` (the fused tower of srsem_torch/backbones/fused_resnet.py, or the
module's backbone), one pass over the 2N images of a pair batch, and only
the head or decoder sees autograd, as the JAX package's
``stop_gradient`` on the taps has it.  The loss is masked MSE, so the
loader's padded final batch keeps one shape: padded rows enter the
decoder's BatchNorm batch statistics, as in JAX, and not the loss.

A train step returns the loss as a 0-d tensor on the card and never waits
for it: the caller decides when the host syncs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from srsem_torch.models.local_models import CluUnet

Tensor = torch.Tensor


def masked_mse(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """Mean squared error over valid rows in float32; maps broadcast the
    row mask.  ``pred`` and ``target`` broadcast as numpy arrays do, or
    raise the ``ValueError`` JAX raises (a raw map against scalar labels,
    ``unet_global`` in ``train_global``)."""
    try:
        torch.broadcast_shapes(pred.shape, target.shape)
    except RuntimeError:
        raise ValueError(
            "Incompatible shapes for broadcasting: shapes="
            f"[{tuple(pred.shape)}, {tuple(target.shape)}]") from None
    err = (pred.float() - target.float()) ** 2
    mask = mask.float()
    if err.dim() > 1:
        mask_b = mask.reshape((-1,) + (1,) * (err.dim() - 1))
        return (err * mask_b).sum() / (mask.sum() * err[0].numel() + 1e-9)
    return (err * mask).sum() / (mask.sum() + 1e-9)


@dataclasses.dataclass
class StepFns:
    #: ``(a, b, y, mask) -> loss``: one Adam step on the trainable subset.
    train_step: Callable
    #: ``(a, b, y, mask) -> (pred, loss)``: no gradients, BN on running
    #: statistics.
    eval_step: Callable


def build_step_fns(model, optimizer: torch.optim.Optimizer,
                   is_map_model: bool = False,
                   tower: Optional[Callable] = None) -> StepFns:
    """Train and eval steps over ``model`` (a GlobalPairScorer or a
    CluUnet) and ``optimizer`` (over the model's trainable parameters).

    ``tower`` maps NHWC images to ``(embedding, taps)``; default the
    module's backbone.  ``is_map_model`` trains a CluUnet's decoder with
    batch statistics (``train=True``); a CluUnet trained as a global model
    (``head="unet_global"``) keeps its BatchNorms on running statistics,
    as the JAX package applies it without ``train``."""
    tower = tower or model.backbone
    is_clu = isinstance(model, CluUnet)

    def apply(a: Tensor, b: Tensor, train: bool) -> Tensor:
        n = a.shape[0]
        with torch.no_grad():
            emb, taps = tower(torch.cat([a, b], dim=0))
        taps_a = {k: v[:n] for k, v in taps.items()}
        taps_b = {k: v[n:] for k, v in taps.items()}
        if is_clu:
            return model.decode_from_taps(taps_a, taps_b, a, b,
                                          train=train and is_map_model)
        return model.score_from_taps(emb[:n], emb[n:], taps_a, taps_b)

    def train_step(a: Tensor, b: Tensor, y: Tensor, mask: Tensor) -> Tensor:
        loss = masked_mse(apply(a, b, True), y, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(a: Tensor, b: Tensor, y: Tensor, mask: Tensor):
        pred = apply(a, b, False)
        return pred, masked_mse(pred, y, mask)

    return StepFns(train_step=train_step, eval_step=eval_step)
