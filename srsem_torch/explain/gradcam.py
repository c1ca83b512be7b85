"""Grad-CAM by autograd on tap offsets — the port of srsem/explain/gradcam.py.

Replaces the reference's pytorch_grad_cam dependency
(reference: additional_approaches/src/gcam_utils.py:6-36).  The towers
take ``tap_offsets``, an additive zero at a tap point
(srsem_torch/backbones/resnet.py, vit.py), so the gradient of a scalar
target with respect to that offset is the gradient with respect to the
tapped activation.  Classic Grad-CAM then averages the gradient over space
into channel weights, takes relu(Σ wᶜ·actᶜ), min-max normalizes (floor
1e-7) and resizes to the image, all in float32.

ViT taps are token sequences; the class token is dropped and the rest
reshaped to the patch grid — the reference's ``reshape_transform``
(reference: gcam_utils.py:10-17).

Grad-CAM runs the module tower: ``embed_fn(img, tap_offsets) ->
(embedding, taps)`` is typically a tower's ``forward`` (the fused kernel
tower has no backward, as the JAX package's Pallas tower has none).  Only
the offset takes a gradient (``torch.autograd.grad`` with ``inputs``), so
the tower's parameters need none.  Each CAM runs one forward and one
backward on the image's device: the offset's entry is None, and the tower
makes the zero offset in the tap's shape (JAX learns it with
``eval_shape``, which runs nothing).  Both functions resize with
``ops/image.py::resize_bilinear``, which computes what the JAX package's
two resizes compute in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from srsem_torch.explain.targets import as_tensor
from srsem_torch.ops.image import resize_bilinear

Tensor = torch.Tensor


def _cam_from(act: Tensor, grad: Tensor,
              grid_hw: Optional[Tuple[int, int]]) -> Tensor:
    """act/grad: float32 (N, H, W, C) or (N, 1+T, C) token layout."""
    if act.dim() == 3:  # tokens → grid, dropping the class token
        n, _, c = act.shape
        gh, gw = grid_hw
        act = act[:, 1:, :].reshape(n, gh, gw, c)
        grad = grad[:, 1:, :].reshape(n, gh, gw, c)
    weights = grad.mean(dim=(1, 2), keepdim=True)  # GAP over space
    cam = torch.clamp_min((weights * act).sum(dim=-1), 0.0)  # (N, H, W)
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / torch.clamp_min(hi - lo, 1e-7)


def _cam(embed_fn: Callable, img: Tensor, tap_name: str,
         target_fn: Callable, grid_hw: Optional[Tuple[int, int]]) -> Tensor:
    offsets = {tap_name: None}  # the tower makes the zero offset
    with torch.enable_grad():
        emb, taps = embed_fn(img, offsets)
        if offsets[tap_name] is None:
            raise ValueError(f"embed_fn made no offset for tap {tap_name!r}")
        objective = torch.sum(target_fn(emb))
        grad, = torch.autograd.grad(objective, [offsets[tap_name]])
    return _cam_from(taps[tap_name].detach().float(), grad.float(), grid_hw)


def grad_cam_tensor(
    embed_fn: Callable,
    img,
    tap_name: str,
    target_fn: Callable[[Tensor], Tensor],
    out_hw: Optional[Tuple[int, int]] = None,
    grid_hw: Optional[Tuple[int, int]] = None,
) -> Tensor:
    """``grad_cam`` as a float32 tensor on the device the tower ran on."""
    cam = _cam(embed_fn, as_tensor(img), tap_name, target_fn, grid_hw)
    if out_hw is not None:
        cam = resize_bilinear(cam[..., None], out_hw)[..., 0]
    return cam


def grad_cam(
    embed_fn: Callable,
    img,
    tap_name: str,
    target_fn: Callable[[Tensor], Tensor],
    out_hw: Optional[Tuple[int, int]] = None,
    grid_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Compute a CAM.

    ``embed_fn(img, tap_offsets) -> (embedding, taps)`` — typically a
    tower's forward (or a closure that normalizes and moves ``img`` first);
    ``img`` is a tensor (it stays on its device) or an array (a CPU
    tensor).  ``target_fn`` maps the embedding to the scalar objective
    (srsem_torch.explain.targets).  Returns (N, out_h, out_w) float32 in
    [0, 1], a host array as JAX's.
    """
    return grad_cam_tensor(embed_fn, img, tap_name, target_fn, out_hw,
                           grid_hw).cpu().numpy()


def grad_cam_matrix(
    embed_fn: Callable,
    images: Sequence,
    embeddings,
    tap_name: str,
    target_factory: Callable[[Tensor], Callable],
    out_hw: Tuple[int, int],
    grid_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """All-pairs CAM grid: CAM of image i under the target built from
    embedding j → (n, n, H, W)
    (reference: gcam_utils.py:23-36 compute_gradcams_matrix)."""
    n = len(images)
    imgs = [as_tensor(im) for im in images]
    imgs = [im[None] if im.dim() == 3 else im for im in imgs]
    embeddings = as_tensor(embeddings)
    out = np.empty((n, n, *out_hw), np.float32)
    for i in range(n):
        for j in range(n):
            cam = _cam(embed_fn, imgs[i], tap_name,
                       target_factory(embeddings[j]), grid_hw)
            out[i, j] = resize_bilinear(cam[..., None],
                                        out_hw)[0, ..., 0].cpu().numpy()
    return out
