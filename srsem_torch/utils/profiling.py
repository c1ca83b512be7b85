"""Tracing / profiling helpers — the port of srsem/utils/profiling.py on
``torch.profiler``.

* ``annotate(name)`` — a named region in the trace
  (``torch.profiler.record_function``);
* ``capture_trace(dir)`` — a ``torch.profiler.profile`` over CPU activity,
  and CUDA activity where a card is present, written into ``dir`` as a
  Chrome trace (``trace.json``; chrome://tracing or Perfetto reads it);
* ``StepTimer`` — a rolling wall-clock throughput meter.

The CLI's global ``--profile DIR`` (before the subcommand) wraps the whole
subcommand in ``capture_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[None]:
    """Profile the block and write ``log_dir/trace.json`` (Chrome trace).

    CUDA activity is traced only where ``torch.cuda.is_available()``, so a
    CPU run never initializes CUDA through the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-clock throughput meter.  CUDA calls return before the
    card finishes: tick after a ``.cpu()`` or ``torch.cuda.synchronize()``
    of the step's output for truthful numbers."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._items = []

    def tick(self, n_items: int = 1) -> None:
        self._times.append(time.perf_counter())
        self._items.append(n_items)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._items.pop(0)

    @property
    def items_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return sum(self._items[1:]) / dt if dt > 0 else None

    def metrics(self, prefix: str = "") -> Dict[str, float]:
        rate = self.items_per_sec
        return {f"{prefix}items_per_sec": rate} if rate else {}
