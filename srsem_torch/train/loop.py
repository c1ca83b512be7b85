"""Training loops for the global regressor and the CLU decoder — the port
of srsem/train/loop.py (``run_training``, ``evaluate``, ``train_global``,
``train_local``).

Adam and masked MSE, validation every epoch (MSE, and SRCC for scalar
scores), a checkpoint every epoch in the JAX package's layout
(``{"trainable", "opt_state", "batch_stats"}``, so either package's CLI
reads the other's), on one card.

A frozen base tower (no LoRA factors, no gradients) is folded once a
run (``fold_tower``) and runs through ``fused_apply`` when ``fused_tower``
is on (None, the default, turns it on exactly for such a tower): the
Hopper bottleneck kernels (``fused_bottleneck``,
``fused_bottleneck_tiled``) in every train and validation step on the
card, their plain versions on the CPU.  The JAX package trains through its
module tower; the two agree to float32 rounding
(tests/test_torch_port_train.py).  A tower that trains (``enc_ft``, LoRA,
the full fine-tune) or carries LoRA factors runs as the module, under
autograd, as in JAX: the folded weights would go stale after the first
step, so an explicit ``fused_tower=True`` raises JAX's ``ValueError``
(srsem/eval/scorer.py:58-63).  The head or decoder runs as a module, in
training and in validation (as JAX's ``eval_step``): the decoder kernel
folds running statistics and cannot train BatchNorm.

Batches arrive as numpy from the loader and go to the card through pinned
memory with non-blocking copies.  The epoch loss accumulates on the card;
the per-batch losses kept every ``log_every`` steps are written after the
epoch's last step, so no step waits for the card.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from srsem_torch.backbones.fused_resnet import (
    fold_tower,
    fused_apply,
    resolve_fused_tower,
)
from srsem_torch.config import GlobalModelConfig, LocalModelConfig, TrainConfig
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import CluUnet, make_local_model
from srsem_torch.train import checkpoint as ckpt
from srsem_torch.train.logging import default_writer
from srsem_torch.train.metrics import mse, srcc
from srsem_torch.train.partition import trainable_predicate
from srsem_torch.train.steps import build_step_fns
from srsem_torch.utils.convert import (
    jax_adam_state,
    jax_trainable_params,
    load_backbone_params,
    load_jax_global_params,
    load_jax_local_params,
)


class TrainResult(dict):
    """dict with attribute access for the summary fields."""

    __getattr__ = dict.__getitem__


def _backbone_kind(model) -> str:
    return getattr(model, "backbone_kind", None) or model.cfg.backbone.kind


def frozen_tower(backbone, kind: str, fused: bool = True):
    """``x -> (embedding, taps)`` of a frozen tower: folded once and run
    through the fused tower, or the module itself."""
    if not fused:
        return backbone
    dtype = backbone.dtype
    with torch.no_grad():
        folded = fold_tower(backbone, dtype)
    return lambda x: fused_apply(kind, backbone, x, dtype, folded=folded)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: through pinned memory, without waiting,
    for the card."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def batch_to_device(batch, device: torch.device):
    """A loader batch ``(((a, b), y), mask)`` as four tensors on
    ``device``."""
    ((a, b), y), mask = batch
    return [to_device(v, device) for v in (a, b, y, mask)]


def has_lora(model) -> bool:
    return isinstance(getattr(model, "lora_rank", None), int)


def build_training(model, is_map_model: bool, predicate, lr: float,
                   device: torch.device, fused_tower: Optional[bool] = None):
    """``model`` on ``device`` with gradients on the ``predicate`` subset
    only, Adam over that subset, and the step functions: over the folded
    tower when the tower is the frozen base tower and ``fused_tower`` does
    not turn it off, else over the module's own forward; returns
    ``(steps, optimizer)``."""
    model.to(device)
    trainable, tower_trains = [], False
    for name, p in model.named_parameters():
        on = bool(predicate(tuple(name.split("."))))
        p.requires_grad_(on)
        if on:
            trainable.append(p)
            tower_trains |= name.startswith("backbone.")
    frozen = not (tower_trains or has_lora(model))
    fused = resolve_fused_tower(fused_tower, frozen, _backbone_kind(model))
    optimizer = torch.optim.Adam(trainable, lr=lr)
    tower = (frozen_tower(model.backbone, _backbone_kind(model), fused)
             if frozen else None)
    return build_step_fns(model, optimizer, is_map_model, tower), optimizer


def run_training(
    model,
    is_map_model: bool,
    train_loader,
    val_loader,
    cfg: TrainConfig,
    predicate,
    writer=None,
    variables=None,
    backbone_params=None,
    device: DeviceLike = None,
    fused_tower: Optional[bool] = None,
) -> TrainResult:
    """Masked-MSE Adam training of ``model``'s ``predicate`` subset;
    returns the final metrics and the trained state (``trainable``,
    ``opt_state``, ``batch_stats`` in the JAX layout, and ``model``).

    ``variables``: a warm start in the JAX layout (``{"params": ...,
    optionally "batch_stats": ...}``, numpy arrays or tensors), loaded
    strictly over the model's own weights.  ``backbone_params``: a tower
    (a JAX-layout param tree or a torchvision / OpenAI-CLIP state dict,
    CLI ``--backbone-checkpoint``) loaded over the model's tower."""
    dev = resolve_device(device)
    own_writer = writer is None
    writer = writer or default_writer()
    if variables is not None:
        load = (load_jax_local_params if isinstance(model, CluUnet)
                else load_jax_global_params)
        load(model, variables)
    if backbone_params is not None:
        load_backbone_params(model.backbone, _backbone_kind(model),
                             backbone_params)
    steps, optimizer = build_training(model, is_map_model, predicate, cfg.lr,
                                      dev, fused_tower)

    step = 0
    val_metrics = {}
    for epoch in range(cfg.epochs):
        t0 = time.time()
        epoch_loss, n_batches, logged = torch.zeros((), device=dev), 0, []
        for batch in train_loader:
            loss = steps.train_step(*batch_to_device(batch, dev))
            step += 1
            n_batches += 1
            epoch_loss += loss
            if step % cfg.log_every == 0:
                logged.append((step, loss))
        for s, loss in logged:
            writer.write(s, {"train_loss_batch": float(loss)})

        val_metrics = evaluate(steps, val_loader, dev, is_map_model)
        writer.write(step, {
            "epoch": epoch,
            "train_loss_epoch": float(epoch_loss) / max(1, n_batches),
            "epoch_seconds": time.time() - t0,
            **{f"val_{k}": v for k, v in val_metrics.items()},
        })
        if cfg.checkpoint_dir:
            params, stats = jax_trainable_params(model)
            ckpt.save_checkpoint(cfg.checkpoint_dir, step, {
                "trainable": params,
                "opt_state": jax_adam_state(model, optimizer),
                "batch_stats": stats,
            }, keep_last=cfg.checkpoint_keep_last)

    if own_writer:
        writer.close()
    params, stats = jax_trainable_params(model)
    return TrainResult(
        trainable=params, batch_stats=stats,
        opt_state=jax_adam_state(model, optimizer), step=step,
        val_metrics=val_metrics, model=model)


def evaluate(steps, loader, device: torch.device, is_map_model: bool) -> dict:
    """Gather predictions; MSE (and SRCC for scalar scores) over the valid
    rows, and the batch losses weighted by each batch's valid rows."""
    preds, targets, losses = [], [], []
    for batch in loader:
        ((_, _), y), mask = batch
        pred, loss = steps.eval_step(*batch_to_device(batch, device))
        valid = np.asarray(mask) > 0
        preds.append(pred.float().cpu().numpy()[valid])
        targets.append(np.asarray(y)[valid])
        losses.append((float(loss), float(valid.sum())))
    preds_np = np.concatenate(preds) if preds else np.zeros((0,))
    targets_np = np.concatenate(targets) if targets else np.zeros((0,))
    n_valid = sum(w for _, w in losses)
    out = {"loss": (float(sum(l * w for l, w in losses) / n_valid)
                    if n_valid else float("nan")),
           "mse": mse(preds_np, targets_np) if len(preds_np) else float("nan")}
    if not is_map_model and len(preds_np) > 1:
        out["srcc"] = srcc(preds_np, targets_np)
    return out


def train_global(cfg: GlobalModelConfig, tcfg: TrainConfig,
                 train_loader, val_loader, **kw) -> TrainResult:
    """Train a global pair-scoring regressor's head, and with ``enc_ft``
    the tower too (reference: sweep_train,
    CLIPLPIPS_REG_training_sweep_example.py:118-206), from weights seeded
    with ``tcfg.seed``."""
    model = make_global_model(cfg, torch.Generator().manual_seed(tcfg.seed))
    return run_training(model, False, train_loader, val_loader, tcfg,
                        trainable_predicate(enc_ft=cfg.enc_ft), **kw)


def train_local(cfg: LocalModelConfig, tcfg: TrainConfig,
                train_loader, val_loader, **kw) -> TrainResult:
    """Train a CLU map model's decoder, and with ``lora_rank`` LoRA factors
    or the whole tower (reference: sweep_train,
    CLU_training_sweep_example.py:78-180), from weights seeded with
    ``tcfg.seed``."""
    model = make_local_model(
        cfg, generator=torch.Generator().manual_seed(tcfg.seed))
    predicate = trainable_predicate(
        lora=isinstance(cfg.lora_rank, int),
        full_finetune=cfg.full_finetune)
    return run_training(model, True, train_loader, val_loader, tcfg,
                        predicate, **kw)
