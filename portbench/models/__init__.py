"""A configuration's model: how the port builds it from raw weights, and
the plain reference beside it.  ``configs/<name>.json`` names its module
here under ``"model"``."""

from __future__ import annotations

import torch


def meta_state(raw_layout) -> dict:
    """A layout's state dict on the meta device (for counting)."""
    return {k: torch.empty(shape, device="meta",
                           dtype=torch.int64 if rule[0] == "count"
                           else torch.float32)
            for k, shape, rule in raw_layout}


def count_flops(fn):
    """``(flops, result)`` of ``fn()``: convolutions and matrix products,
    counted by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return counter.get_total_flops(), out
