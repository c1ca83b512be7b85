"""The profiled part of a ``--trace 1`` run and its reduction.

Frozen copies from ``chip_smoke.py``: ``kernel_group`` is its
``_kernel_group`` (device operations sorted into groups by name) and
``busy_union`` the interval union of its ``profile_scoring`` (the device is
busy where any device operation runs).  The rest reads the same profile:
device operations by name, and the idle gaps between them, each named by
what the host was doing in the middle of it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

def kernel_group(name: str) -> str:
    """chip_smoke.py::_kernel_group."""
    if "fused_bottleneck" in name:
        return "bottleneck kernel"
    if "fused_decoder" in name:
        return "decoder kernel"
    if "fused_head" in name:
        return "head kernel"
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "adam" in low or "multi_tensor_apply" in low:
        return "optimizer (Adam)"
    if any(k in low for k in ("dgrad", "wgrad", "bprop", "backward")):
        return "cudnn conv backward and other backward"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit",
                              "gemm", "cutlass", "sm90")):
        return "cudnn conv"
    return "other (elementwise, pooling, casts)"


def busy_union(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy, last = busy + end - start, end
        elif end > last:
            busy, last = busy + end - last, end
    return busy


@dataclass
class Profile:
    """Device operations of ``calls`` profiled calls (times in seconds)."""

    calls: int
    wall_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]          # (name, start, end)
    by_name: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds(self, pred: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.ops if pred(n))

    def group_ms_per_call(self, group: str) -> float:
        return 1e3 * self.seconds(lambda n: kernel_group(n) == group) / self.calls


def _idle_gaps(ops, host, t0: float, t1: float, top: int = 10):
    """The ``top`` longest stretches of ``[t0, t1]`` with no device
    operation, each named by the two innermost host events (harness spans,
    host operations, runtime calls) running at its middle, outer first."""
    gaps, last = [], t0
    for s, e in sorted((s, e) for _, s, e in ops):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        inner = sorted((he - hs, name) for name, hs, he in host
                       if hs <= mid <= he)
        label = " > ".join(n for _, n in reversed(inner[:2]))
        named.append((label or "no host event", e - s))
    return named


def profile_calls(torch, call: Callable[[], object], calls: int,
                  cuda: bool = True) -> Profile:
    """``torch.profiler`` (CPU and CUDA) over ``calls`` calls that end on
    the host; the wall time runs from the first call to the last one's
    end, after a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with record_function("portbench.window"):
            t_start = time.perf_counter()
            for _ in range(calls):
                with record_function("portbench.call"):
                    call()
            sync()
            wall = time.perf_counter() - t_start
    ops, host = [], []
    window = None
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "portbench."):
            # A span's copy on the device's timeline is no device work.
            if e.device_type != DeviceType.CUDA and e.name == "portbench.window":
                window = (start, end)
            if e.device_type != DeviceType.CUDA:
                host.append((e.name, start, end))
            continue
        if e.device_type == DeviceType.CUDA:
            ops.append((e.name, start, end))
        else:
            host.append((e.name, start, end))
    by_name: Dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    t0, t1 = window if window else (min(s for _, s, _ in ops),
                                    max(e for _, _, e in ops))
    prof_out = Profile(calls=calls, wall_s=wall,
                       busy_s=busy_union([(s, e) for _, s, e in ops]),
                       ops=ops, by_name=by_name)
    if ops:
        prof_out.idle_gaps = _idle_gaps(ops, host, t0, t1)
    return prof_out


def breakdown(prof: Profile, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, ``[[name, seconds], ...]``."""
    ops = sorted(prof.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in prof.idle_gaps[:top]]}
