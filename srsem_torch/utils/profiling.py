"""The port's tracer: spans at its layer boundaries and process counters
(the port of srsem/utils/profiling.py, on ``torch.profiler``).

* ``span(name, **attrs)`` — a named region at a layer boundary.  Off, it
  reads one flag and ``torch.autograd._profiler_enabled()`` and returns a
  shared no-op context.  It is on between ``enable()`` and ``disable()``,
  and in any thread that a running ``torch.profiler`` records: it then
  enters ``torch.profiler.record_function(name)`` where the profiler
  records (the span lands in the trace on the clock of the device
  operations) and appends ``{name, id, parent, call, t0_ns, t1_ns,
  attrs}`` to a bounded buffer (``MAX_SPANS``; overflow counts
  ``spans_dropped``).  ``parent`` is the enclosing span on the same
  thread, ``call`` the outermost one's id, so the spans of one call, step
  or request share it; stamps are ``time.perf_counter_ns()``.
* ``record(name, t0_ns, **attrs)`` — a span that began at ``t0_ns``,
  possibly on another thread, and ends now (a request's wait in a queue).
* ``count(name, n=1)`` — always-on process counters under one lock, for
  work off the hot path (set-up) or one add a call.
* ``snapshot()`` — ``{"spans": [...], "counters": {...}}``; the counters
  include the kernel wrappers' ``.launches`` (``launches.<wrapper>``,
  their running totals since import).  ``reset()`` clears the spans and
  the counters.
* ``self_ms(spans, name)`` — the spans' durations less the union of
  their children's, in ms.
* ``capture_trace(dir)`` — a ``torch.profiler.profile`` over CPU activity,
  and CUDA activity where a card is present, with the recorder on (so the
  threads the profiler does not see record too), written into ``dir`` as
  a Chrome trace (``trace.json``; chrome://tracing or Perfetto reads it)
  and the block's spans with the counters (``spans.json``).

The CLI's global ``--profile DIR`` (before the subcommand) wraps the whole
subcommand in ``capture_trace``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List

import torch

#: The most spans the buffer holds; later ones are counted, not kept.
MAX_SPANS = 200_000

_profiler_enabled = torch.autograd._profiler_enabled
_on = False
_lock = threading.Lock()
_spans: List[dict] = []
_counters: Dict[str, float] = {}
_ids = itertools.count(1)


class _Local(threading.local):
    """Each thread's stack of open spans."""

    def __init__(self):
        self.stack: list = []


_local = _Local()


class _Off:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, val, tb) -> None:
        return None


_OFF = _Off()


def enable() -> None:
    """Record spans from every thread until ``disable()``."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _keep(rec: dict) -> None:
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(rec)
            return
        _counters["spans_dropped"] = _counters.get("spans_dropped", 0) + 1


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "t0", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        stack = _local.stack
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        stack.append(self)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _keep({"name": self.name, "id": self.id, "parent": self.parent,
               "call": self.call, "t0_ns": self.t0, "t1_ns": t1,
               "attrs": self.attrs})


def span(name: str, **attrs):
    """A context over one layer's work (see the module's docstring)."""
    if not _on and not _profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def record(name: str, t0_ns: int, **attrs) -> None:
    """A finished span from ``t0_ns`` until now, under the current
    thread's open span (if on)."""
    if not _on and not _profiler_enabled():
        return
    stack = _local.stack
    outer = stack[-1] if stack else None
    sid = next(_ids)
    _keep({"name": name, "id": sid, "parent": outer.id if outer else None,
           "call": outer.call if outer else sid, "t0_ns": t0_ns,
           "t1_ns": time.perf_counter_ns(), "attrs": attrs})


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _launches() -> Dict[str, int]:
    from srsem_torch.ops import fused_attention as fa
    from srsem_torch.ops import fused_bottleneck as fb
    from srsem_torch.ops import fused_decoder as fd
    from srsem_torch.ops import fused_head as fh

    wrappers = (fb.fused_bottleneck, fb.fused_bottleneck_tiled,
                fd.fused_decoder_level, fd.fused_decoder_level_tiled,
                fh.fused_stage_score, fh.fused_global_score,
                fh.fused_grouped_score, fa.fused_attention)
    return {f"launches.{w.__name__}": w.launches for w in wrappers}


def snapshot() -> dict:
    """The recorded spans and the counters (copies)."""
    with _lock:
        spans, counters = list(_spans), dict(_counters)
    counters.update(_launches())
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the recorded spans and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


def self_ms(spans: List[dict], name: str) -> float:
    """Milliseconds inside the spans named ``name``, less the union of the
    intervals their direct children cover."""
    children: Dict[int, list] = {}
    for s in spans:
        children.setdefault(s["parent"], []).append((s["t0_ns"], s["t1_ns"]))
    total = 0
    for s in spans:
        if s["name"] != name:
            continue
        covered, last = 0, None
        for t0, t1 in sorted(children.get(s["id"], ())):
            if last is None or t0 > last:
                covered, last = covered + t1 - t0, t1
            elif t1 > last:
                covered, last = covered + t1 - last, t1
        total += s["t1_ns"] - s["t0_ns"] - covered
    return total / 1e6


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[None]:
    """Profile the block, with the recorder on, and write
    ``log_dir/trace.json`` (Chrome trace) and ``log_dir/spans.json`` (the
    block's spans and the counters).

    CUDA activity is traced only where ``torch.cuda.is_available()``, so a
    CPU run never initializes CUDA through the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, start = _on, time.perf_counter_ns()
    enable()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        if not was_on:
            disable()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        snap = snapshot()
        snap["spans"] = [s for s in snap["spans"] if s["t0_ns"] >= start]
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(snap, f)
