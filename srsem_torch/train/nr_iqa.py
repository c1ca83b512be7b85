"""Training the NR-IQA head — the port of srsem/train/nr_iqa.py.

* :func:`degrade` — per-sample synthetic degradations with their five
  quality labels: a Gaussian blur (sigma ``3·s``, floored at 1e-3, radius
  7, edge-padded separable convolutions), blocky compression artifacts
  (a blend toward each 8x8 block's mean over the ``hb*8 × wb*8`` crop),
  contrast toward the per-image mean, desaturation, and a clip to [0, 1];
* :func:`train_nr_iqa` — head-only MSE training with Adam (optax's
  defaults): the tower is frozen and runs under ``no_grad`` through the
  fused tower, folded once; only ``head.*`` gets gradients.

The host RNG is the JAX package's: ``np.random.default_rng(seed)``, one
``permutation`` an epoch, one ``uniform(size=(n, 4))`` a batch, then one
for validation, so the two packages see the same batches and severities.

The checkpoint is JAX's layout (``{"trainable", "tower_seed"}`` through
srsem_torch/train/checkpoint.py) plus ``tower_init: "torch"``: the head is
only meaningful against the random tower it was trained on, which the port
draws from ``torch.Generator().manual_seed(tower_seed)`` and JAX from
``PRNGKey(tower_seed)``.  ``load_nr_iqa_head`` rebuilds the port's tower
and refuses a checkpoint without the marker (one the JAX package wrote).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.eval.nr_iqa import NrIqaHead, jax_head_params, load_jax_nr_iqa
from srsem_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

Tensor = torch.Tensor

#: The checkpoint leaf that marks the tower as the port's own random init.
TOWER_MARKER = ("tower_init", "torch")


def _sep_blur(x: Tensor, sigma: Tensor, radius: int) -> Tensor:
    """Separable Gaussian blur of NHWC ``x`` with one sigma an image:
    edge-padded, along H then W."""
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=x.device)
    k = torch.exp(-0.5 * (taps[None] / sigma.clamp_min(1e-3)[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)  # (N, 2r+1)
    n, h, w, _ = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 0, radius, radius),
               mode="replicate").permute(0, 2, 3, 1)
    x = sum(xp[:, i:i + h] * k[:, i].view(n, 1, 1, 1)
            for i in range(2 * radius + 1))
    xp = F.pad(x.permute(0, 3, 1, 2), (radius, radius, 0, 0),
               mode="replicate").permute(0, 2, 3, 1)
    return sum(xp[:, :, i:i + w] * k[:, i].view(n, 1, 1, 1)
               for i in range(2 * radius + 1))


def _blockify(x: Tensor, amount: Tensor, block: int = 8) -> Tensor:
    """Blend each block×block block toward its mean color, over the crop
    the blocks cover."""
    n, h, w, c = x.shape
    hb, wb = h // block, w // block
    crop = x[:, :hb * block, :wb * block]
    means = crop.reshape(n, hb, block, wb, block, c).mean(dim=(2, 4))
    blocky = means.repeat_interleave(block, 1).repeat_interleave(block, 2)
    a = amount.view(n, 1, 1, 1)
    out = x.clone()
    out[:, :hb * block, :wb * block] = crop * (1 - a) + blocky * a
    return out


def degrade(images, severities, radius: int = 7) -> Tuple[Tensor, Tensor]:
    """``images`` (N, H, W, 3) in [0,1] and ``severities`` (N, 4) in [0,1]
    (blur, artifacts, contrast, color) → (degraded, labels (N, 5)): each
    dimension's ``1 - severity`` after the overall ``1 - mean(severity)``.
    Tensors stay on their device; numpy goes to the CPU."""
    x = torch.as_tensor(images, dtype=torch.float32)
    sev = torch.as_tensor(severities, dtype=torch.float32, device=x.device)
    n = x.shape[0]
    col = lambda j: sev[:, j].view(n, 1, 1, 1)  # noqa: E731
    x = _sep_blur(x, sev[:, 0] * 3.0, radius)
    x = _blockify(x, sev[:, 1])
    mean = x.mean(dim=(1, 2), keepdim=True)
    x = x * (1 - 0.8 * col(2)) + mean * (0.8 * col(2))
    gray = x.mean(dim=-1, keepdim=True)
    x = x * (1 - col(3)) + gray * col(3)
    labels = torch.cat([1.0 - sev.mean(dim=-1, keepdim=True), 1.0 - sev],
                       dim=-1)
    return x.clamp(0.0, 1.0), labels


def normalize_imagenet(x: Tensor) -> Tensor:
    """[0,1] NHWC → ImageNet-normalized, on x's device (the scorer's
    input: ``Preprocess.for_backbone("resnet50")``)."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


@dataclasses.dataclass
class NrIqaTrainResult:
    #: The trained model (the tower as it was, the head trained).
    model: NrIqaHead
    losses: List[float]
    val_mse: float


def train_nr_iqa(
    images: np.ndarray,
    epochs: int = 5,
    batch_size: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    checkpoint_dir: Optional[str] = None,
    val_fraction: float = 0.25,
    device: DeviceLike = None,
    variables: Optional[Mapping[str, Any]] = None,
) -> NrIqaTrainResult:
    """Train the head on synthetic degradations of ``images`` (N, H, W, 3)
    in [0,1], from weights drawn from ``torch.Generator().manual_seed(
    seed)`` or, when given, JAX ``NrIqaHead`` ``params`` (``variables``:
    ``{"params": ...}``).  Each epoch draws fresh severities."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = np.asarray(images, np.float32)
    n_val = max(1, int(len(images) * val_fraction))
    train_imgs, val_imgs = images[:-n_val], images[-n_val:]

    model = NrIqaHead(compute_dtype=compute_dtype).reset_parameters(
        torch.Generator().manual_seed(seed))
    if variables is not None:
        load_jax_nr_iqa(model, variables["params"])
    model.to(dev)
    folded = model.fold()
    optimizer = torch.optim.Adam(model.head.parameters(), lr=lr)

    def batch(imgs: np.ndarray) -> Tuple[Tensor, Tensor]:
        sev = rng.uniform(0.0, 1.0, size=(len(imgs), 4)).astype(np.float32)
        x, y = degrade(torch.from_numpy(imgs).to(dev),
                       torch.from_numpy(sev).to(dev))
        return normalize_imagenet(x), y

    def mse(x: Tensor, y: Tensor) -> Tensor:
        return ((model(x, folded) - y) ** 2).mean()

    losses: List[Tensor] = []
    for _ in range(epochs):
        order = rng.permutation(len(train_imgs))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            loss = mse(*batch(train_imgs[order[start: start + batch_size]]))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
    with torch.no_grad():
        val_mse = float(mse(*batch(val_imgs)))

    if checkpoint_dir:
        from srsem_torch.train.checkpoint import save_checkpoint

        save_checkpoint(checkpoint_dir, len(losses), {
            "trainable": jax_head_params(model),
            "tower_seed": np.int32(seed),
            TOWER_MARKER[0]: TOWER_MARKER[1]})
    return NrIqaTrainResult(model=model, losses=[float(v) for v in losses],
                            val_mse=val_mse)


def load_nr_iqa_head(checkpoint_dir: str,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> NrIqaHead:
    """The trained head over the port's random tower of the checkpoint's
    ``tower_seed``.  A checkpoint without the ``tower_init`` marker was
    written by the JAX package, whose head belongs to a tower drawn from
    ``PRNGKey(tower_seed)`` that the port cannot rebuild: it raises
    ``ValueError`` rather than score that head against another tower."""
    from srsem_torch.train.checkpoint import restore_checkpoint

    raw: Dict[str, Any] = restore_checkpoint(checkpoint_dir)
    if raw.get(TOWER_MARKER[0]) != TOWER_MARKER[1]:
        raise ValueError(
            f"{checkpoint_dir}: NR-IQA checkpoint without "
            f"{TOWER_MARKER[0]}={TOWER_MARKER[1]!r} — written by the JAX "
            "package, whose head was trained against a tower drawn from "
            "jax.random.PRNGKey(tower_seed), which the port cannot rebuild; "
            "retrain it with the port's train-nr-iqa")
    seed = int(raw.get("tower_seed", 0))
    model = NrIqaHead(compute_dtype=compute_dtype).reset_parameters(
        torch.Generator().manual_seed(seed))
    return load_jax_nr_iqa(model, raw["trainable"], partial=True)
