"""Inputs made from a seed on the device and handed to the host, as the
program's callers hold them: uint8 NHWC image pairs in pageable memory,
and the normalized float32 batches the training loader yields (a frozen
copy of ``chip_smoke.py::host_batch``'s contract: ``(((a, b), y), mask)``
with maps in [0, 1] and every row valid)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: Offset of the input stream's seed from the weights' seed.
INPUT_STREAM = 0x5EED


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed + INPUT_STREAM) % (2 ** 63))


def _images(gen, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) float32 in [0, 255]: smooth colour fields at an
    eighth of the size, upsampled, with pixel-level detail."""
    base = torch.rand(n, 3, size // 8, size // 8, generator=gen, device=device)
    img = F.interpolate(base, size=(size, size), mode="bilinear",
                        align_corners=False) * 255.0
    img = img + 24.0 * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).permute(0, 2, 3, 1)


def _degraded(gen, gt: torch.Tensor, noise: int) -> torch.Tensor:
    """``gt`` plus uniform integer noise in [-noise, noise], clipped."""
    d = torch.randint(-noise, noise + 1, gt.shape, generator=gen,
                      device=gt.device)
    return (gt.round() + d).clamp(0, 255)


def pair_pool(seed: int, n: int, size: int, noise: int, device,
              chunk: int = 256):
    """``n`` (GT, SR) uint8 host arrays of (n, size, size, 3)."""
    gen = _gen(seed, device)
    gts, srs = [], []
    for i in range(0, n, chunk):
        gt = _images(gen, min(chunk, n - i), size, device)
        srs.append(_degraded(gen, gt, noise).to(torch.uint8).cpu())
        gts.append(gt.round().to(torch.uint8).cpu())
    return torch.cat(gts).numpy(), torch.cat(srs).numpy()


def _rectangles(gen, n: int, size: int, per_row: int, device):
    """(n, 1, size, size) float masks: ``per_row`` rectangles a row, each
    side 10-40% of the image, placed at random."""
    side = (0.1 + 0.3 * torch.rand(n, per_row, 2, generator=gen,
                                   device=device)) * size
    corner = torch.rand(n, per_row, 2, generator=gen, device=device) * (
        size - side)
    grid = torch.arange(size, device=device, dtype=torch.float32)
    inside = lambda k: ((grid >= corner[..., k, None])  # noqa: E731
                        & (grid < (corner + side)[..., k, None]))
    rows, cols = inside(0), inside(1)              # (n, per_row, size)
    masks = rows[..., :, None] & cols[..., None, :]
    return masks.any(dim=1, keepdim=True).float()


def train_pool(seed: int, batches: int, n: int, size: int, mean, std,
               device, regions: int = 3):
    """``batches`` loader batches ``(((a, b), y), mask)`` of ``n`` rows, as
    the CLU training data are made (the reference's inpainting maps): the
    SR image is the GT with ``regions`` rectangles replaced by another
    image's content, the target map 1 where the content is kept and 0
    where it was replaced (edges blurred over 9 pixels); normalized float32
    NHWC pairs, every row valid; numpy on the host."""
    gen = _gen(seed, device)
    m = torch.tensor(mean, device=device)
    s = torch.tensor(std, device=device)
    out = []
    for _ in range(batches):
        gt = _images(gen, n, size, device).round()
        other = _images(gen, n, size, device).round()
        hole = _rectangles(gen, n, size, regions, device)
        sr = gt * (1 - hole.permute(0, 2, 3, 1)) + other * hole.permute(
            0, 2, 3, 1)
        y = 1 - F.avg_pool2d(hole, 9, 1, 4, count_include_pad=False)[:, 0]
        a = ((gt / 255.0 - m) / s).cpu().numpy()
        b = ((sr / 255.0 - m) / s).cpu().numpy()
        out.append((((a, b), y.cpu().numpy()), np.ones((n,), np.float32)))
    return out
