"""Traffic drivers: the general generators the traffic files name under
``"driver"``.  A driver builds a cell's inputs and program from the seed,
makes one call (or training step) at a time for the harness's window,
and after the window compares a sample of what the program produced with
the plain reference.

``control`` (a name of ``reference/lowprec.py::CONTROLS``) puts the
reference, with a part computed in the configuration's next lower
precision, in the program's place: the readings that set a cell's upper
limits (``portbench/calibrate.py``).
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

from portbench.common.weights import draw
from portbench.reference.towers import normalize


class Reservoir:
    """A uniform sample of ``k`` of the offered items, drawn from the
    seed (algorithm R): the same seed and count keep the same items."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.items: List = []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            r = self.rng.randrange(self.seen + 1)
            if r < self.k:
                self.items[r] = item
        self.seen += 1


class Driver:
    """What every driver shares: the configuration's model module, its raw
    weights drawn on the device (a host copy kept for the reference), the
    cell's shapes for the per-layer readers."""

    #: Whether each call's host-clock time is a request latency.
    latency = True
    #: Whether a call decodes (serves maps) rather than trains.
    decodes = True

    def __init__(self, cfg: dict, traffic: dict, model, seed: int, device,
                 control=None):
        self.cfg, self.traffic, self.model = cfg, traffic, model
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.reservoir = Reservoir(traffic["check_calls"], seed)
        self.failed = 0
        self.laps: Dict[str, float] = {}
        self._lap = time.perf_counter()

    def lap(self, name: str) -> None:
        """Record the seconds since the last lap under ``name``."""
        now = time.perf_counter()
        self.laps[name] = now - self._lap
        self._lap = now

    def draw_weights(self, sample=None) -> Dict[str, torch.Tensor]:
        """The raw weights from the seed; a model with ``settle`` sets its
        running statistics from ``sample()``, normalized NCHW pairs."""
        sd = draw(self.model.raw_layout(self.cfg), self.seed, self.device)
        if hasattr(self.model, "settle"):
            self.model.settle(self.cfg, sd, *sample())
        self.sd_host = {k: v.cpu() for k, v in sd.items()}
        return sd

    def normalized(self, *arrays):
        """uint8 NHWC host arrays as normalized NCHW float32 on the card,
        with the configuration's reference's mean and std."""
        ref = self.model.Reference
        return [normalize(torch.as_tensor(a).to(self.device), ref.mean,
                          ref.std) for a in arrays]

    def reference(self, control=None):
        sd = {k: v.to(self.device) for k, v in self.sd_host.items()}
        return self.model.Reference(self.cfg, sd, control=control)

    def kernel_work(self) -> dict:
        """Each hand-written kernel's work items in one call."""
        return self.model.kernel_work(self.cfg, self.tower_passes(),
                                      self.items_per_call, self.decodes)

    @property
    def min_calls(self) -> int:
        return self.traffic["check_calls"]

    def finish(self) -> None:
        """Wait for the window's last call (the scoring calls end on the
        host already)."""

    def flops_per_call(self) -> Dict[str, float]:
        """Model FLOPs of one call by dtype."""
        out: Dict[str, float] = {}
        counts = self.model.flops(self.cfg)
        for part, n in self.work().items():
            dtype, flops = counts[part]
            out[dtype] = out.get(dtype, 0.0) + flops * n
        return out

    def work(self) -> Dict[str, int]:
        """How many of each counted part one call does."""
        raise NotImplementedError


def finite_gap(gap: float, *tensors: torch.Tensor) -> float:
    """``gap``, or infinity where the program gave a non-finite value."""
    if any(not bool(torch.isfinite(t).all()) for t in tensors):
        return math.inf
    return gap


def in_chunks(fn, n: int, chunk: int, *arrays):
    """``fn`` over row blocks of the host arrays, concatenated on the
    host."""
    out = [fn(*(a[i:i + chunk] for a in arrays)).cpu()
           for i in range(0, n, chunk)]
    return torch.cat(out)


def nchw(taps: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """The program's NHWC taps ``names`` as NCHW on the host, in their
    dtype."""
    return {k: taps[k].permute(0, 3, 1, 2).cpu() for k in names}


def on(device, taps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host taps as float32 on ``device``."""
    return {k: v.to(device).float() for k, v in taps.items()}


class TapGap:
    """The worst tap's mean absolute gap between the program's taps and
    the reference's, as a share of the reference's mean magnitude,
    summed over the blocks offered."""

    def __init__(self):
        self.num: Dict[str, float] = {}
        self.den: Dict[str, float] = {}

    def offer(self, got: Dict[str, torch.Tensor],
              want: Dict[str, torch.Tensor]) -> None:
        for k, w in want.items():
            self.num[k] = self.num.get(k, 0.0) + float(
                (got[k].float() - w).abs().double().sum())
            self.den[k] = self.den.get(k, 0.0) + float(w.abs().double().sum())

    def value(self) -> float:
        return max(self.num[k] / max(self.den[k], 1e-30) for k in self.num)
