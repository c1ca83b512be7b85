"""Train and eval steps — the port of srsem/train/steps.py.

A frozen tower runs under ``torch.no_grad`` through ``tower`` (the fused
tower of srsem_torch/backbones/fused_resnet.py, or the module's
backbone), one pass over the 2N images of a pair batch, and only the head
or decoder sees autograd, as the JAX package's ``stop_gradient`` on the
taps has it.  A tower that trains (``enc_ft``, LoRA, the full fine-tune;
``tower=None``) runs inside the model's own forward under autograd, as
JAX's ``model.apply`` does.  The loss is masked MSE, so the loader's
padded final batch keeps one shape: padded rows enter the decoder's
BatchNorm batch statistics, as in JAX, and not the loss.

On a mesh (srsem_torch/core/meshes.py) each rank steps on its slice of
the batch, and the reductions JAX's psums make global are collectives
here: the mask count is summed over ``data`` before the division, so the
loss is ``sum(err * mask) / sum(mask)`` over the global batch whatever
rows each rank holds (DDP's mean of per-rank means is not, when the
padded rows sit on one rank); the trainable gradients are summed over
``data`` (the model ranks of a data group hold equal ones); a CluUnet's
decoder BatchNorm takes its batch statistics over ``data``
(``CluUnet.sync_batch_norm``).  With the rank-local 1x1 mesh no
collective runs and the step is the one-card step.

A train step returns the loss as a 0-d tensor on the device and never
waits for it: the caller decides when the host syncs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from srsem_torch.core.meshes import Mesh, all_reduce, gather_batch
from srsem_torch.models.local_models import CluUnet
from srsem_torch.parallel.sharding import require_sharded
from srsem_torch.utils.profiling import span

Tensor = torch.Tensor


def masked_mse(pred: Tensor, target: Tensor, mask: Tensor,
               mesh: Optional[Mesh] = None) -> Tensor:
    """Mean squared error over valid rows in float32; maps broadcast the
    row mask.  ``pred`` and ``target`` broadcast as numpy arrays do, or
    raise the ``ValueError`` JAX raises (a raw map against scalar labels,
    ``unet_global`` in ``train_global``).  On a ``mesh`` the rows are this
    rank's slice and the divisor is the global valid count: the result is
    the rank's share, and ``global_loss`` sums the shares."""
    try:
        torch.broadcast_shapes(pred.shape, target.shape)
    except RuntimeError:
        raise ValueError(
            "Incompatible shapes for broadcasting: shapes="
            f"[{tuple(pred.shape)}, {tuple(target.shape)}]") from None
    err = (pred.float() - target.float()) ** 2
    mask = mask.float()
    count = mask.sum() if mesh is None else all_reduce(mesh, mask.sum())
    if err.dim() > 1:
        mask_b = mask.reshape((-1,) + (1,) * (err.dim() - 1))
        return (err * mask_b).sum() / (count * err[0].numel() + 1e-9)
    return (err * mask).sum() / (count + 1e-9)


def global_loss(loss: Tensor, mesh: Optional[Mesh] = None) -> Tensor:
    """The detached loss over the global batch: the ranks' shares summed
    over ``data``."""
    loss = loss.detach()
    return loss if mesh is None else all_reduce(mesh, loss)


def sync_gradients(params, mesh: Optional[Mesh] = None) -> None:
    """Sum the gradients of ``params`` over ``data`` in one flat bucket
    (every rank holds gradients for the same parameters)."""
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    summed = all_reduce(mesh, _flatten_dense_tensors(grads))
    for g, s in zip(grads, _unflatten_dense_tensors(summed, grads)):
        g.copy_(s)


def adam_step(optimizer: torch.optim.Optimizer, loss: Tensor,
              mesh: Optional[Mesh] = None) -> Tensor:
    """One optimizer step on ``loss`` (a rank's share on a mesh, the
    gradients summed over ``data``); returns the global loss."""
    optimizer.zero_grad(set_to_none=True)
    with span("srsem.backward"):
        loss.backward()
        sync_gradients([p for g in optimizer.param_groups
                        for p in g["params"]], mesh)
    with span("srsem.optimizer"):
        optimizer.step()
    return global_loss(loss, mesh)


@dataclasses.dataclass
class StepFns:
    #: ``(a, b, y, mask) -> loss``: one Adam step on the trainable subset.
    train_step: Callable
    #: ``(a, b, y, mask) -> (pred, loss)``: no gradients, BN on running
    #: statistics.
    eval_step: Callable


def build_step_fns(model, optimizer: torch.optim.Optimizer,
                   is_map_model: bool = False,
                   tower: Optional[Callable] = None,
                   mesh: Optional[Mesh] = None) -> StepFns:
    """Train and eval steps over ``model`` (a GlobalPairScorer or a
    CluUnet) and ``optimizer`` (over the model's trainable parameters).

    ``tower`` maps NHWC images to ``(embedding, taps)`` of the frozen
    tower; None runs the model's forward, whose tower trains.
    ``is_map_model`` trains a CluUnet's decoder with batch statistics
    (``train=True``); a CluUnet trained as a global model
    (``head="unet_global"``) keeps its BatchNorms on running statistics,
    as the JAX package applies it without ``train``.  On a ``mesh`` the
    steps take this rank's slice of the batch; the loss is global, and
    ``eval_step``'s predictions are gathered over ``data``."""
    require_sharded(mesh, model)
    is_clu = isinstance(model, CluUnet)
    if is_clu and mesh is not None:
        model.sync_batch_norm(mesh)

    def apply(a: Tensor, b: Tensor, train: bool) -> Tensor:
        if tower is None:
            with span("srsem.forward"):
                return (model(a, b, train=train and is_map_model) if is_clu
                        else model(a, b))
        n = a.shape[0]
        with torch.no_grad(), span("srsem.tower"):
            emb, taps = tower(torch.cat([a, b], dim=0))
        taps_a = {k: v[:n] for k, v in taps.items()}
        taps_b = {k: v[n:] for k, v in taps.items()}
        with span("srsem.forward"):
            if is_clu:
                return model.decode_from_taps(taps_a, taps_b, a, b,
                                              train=train and is_map_model)
            return model.score_from_taps(emb[:n], emb[n:], taps_a, taps_b)

    def train_step(a: Tensor, b: Tensor, y: Tensor, mask: Tensor) -> Tensor:
        with span("srsem.train_step", rows=a.shape[0]):
            pred = apply(a, b, True)
            with span("srsem.loss"):
                loss = masked_mse(pred, y, mask, mesh)
            return adam_step(optimizer, loss, mesh)

    @torch.no_grad()
    def eval_step(a: Tensor, b: Tensor, y: Tensor, mask: Tensor):
        pred = apply(a, b, False)
        loss = global_loss(masked_mse(pred, y, mask, mesh), mesh)
        return (pred if mesh is None else gather_batch(mesh, pred)), loss

    return StepFns(train_step=train_step, eval_step=eval_step)
