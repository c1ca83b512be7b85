"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A run
that asked for the card and finds none raises; it never carries on on
the CPU, where a timing or a kernel check would mean something else.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False — pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev

