"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs, weights and program from the seed, warms up
(all of it ``setup_s``), calls the program in a closed loop for
``--seconds``, and with ``--trace 1`` then profiles a few more calls for
the per-layer metrics.  Once the window has closed and the program is
freed, it compares a sample of what the window produced with the plain
reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``); each number compared, beside its limit,
ends standard error and the result line (``checks``).

It refuses to run without as many CUDA cards as the cell asks for, and
fails when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Kernel caches at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "portbench" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "portbench" / "triton"}
#: Top-level module names no run may have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "srsem")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             adjust=None, control=None) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line's
    object.  ``adjust(cell)`` may resize the cell (the CPU tests do);
    ``control`` (a name of ``reference/lowprec.py::CONTROLS``) puts that
    lower-precision reference in the program's place."""
    import torch

    from portbench.common import trace as tr
    from portbench.common.spec import Cell, module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(name)
    if adjust:
        adjust(cell)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    imported = time.perf_counter()
    drv = cell.driver.Driver(cell.config, cell.traffic, cell.model, seed,
                             device, control=control)
    drv.setup()
    sync()
    setup_s = time.perf_counter() - T0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    latencies, i = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        drv.call(i)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        i += 1
        if t1 - start >= seconds and i >= drv.min_calls:
            break
    drv.finish()
    window_s = time.perf_counter() - start
    calls = i
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    prof = None
    if trace:
        n = cell.traffic["profile_calls"]
        more = iter(range(calls, calls + n))
        prof = tr.profile_calls(torch, lambda: drv.call(next(more)), n, cuda)
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = drv.check()
    limits = (cell.limits or {}).get("limits", {})
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = (drv.failed == 0 and bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values()))

    ctx = types.SimpleNamespace(
        cell=cell, driver=drv, setup_s=setup_s, calls=calls,
        window_s=window_s, latencies=latencies,
        items=calls * drv.items_per_call, profile=prof,
        window_peak_bytes=window_peak)
    wanted = cell.per_layer() if trace else cell.end_to_end()
    metrics = {}
    for m in wanted:
        value = module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.entry["chips"],
           "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": correct, "attempted": ctx.items,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.wall_s
        result["breakdown"] = tr.breakdown(prof)
    result["card"] = power_limit() if cuda else "cpu"
    result["laps"] = {"imports": imported - T0, **drv.laps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    import torch

    from portbench.common.spec import Cell

    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}: not measured",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: refused", file=sys.stderr)
        return 3
    print("setup laps " + json.dumps(result.pop("laps")), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
