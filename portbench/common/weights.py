"""Raw weights drawn from a seed on the device, in two large calls (one
normal, one uniform draw) sliced by a layout (``reference/layout.py``)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.layout import Spec


def draw(layout: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``layout``, float32 on ``device`` (the counters
    int64), the same for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, rule in layout:
        if rule[0] in sizes:
            sizes[rule[0]] += math.prod(shape)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, torch.Tensor] = {}
    for key, shape, rule in layout:
        kind, n = rule[0], math.prod(shape)
        if kind in at:
            flat = (normal if kind == "normal" else uniform)[at[kind]:at[kind] + n]
            at[kind] += n
            t = (flat * rule[1] if kind == "normal"
                 else rule[1] + flat * (rule[2] - rule[1]))
            out[key] = t.reshape(shape)
        elif kind == "const":
            out[key] = torch.full(shape, float(rule[1]), device=device)
        else:  # BatchNorm's num_batches_tracked
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out
