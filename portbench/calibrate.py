"""The readings a cell's limits are set from, in one process on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 7 8 9] [--controls lower head] \\
        [--fault-seeds 7 8 9] [--seconds 2] \\
        [--set traffic.KEY=JSON ...] [--out calibrate.jsonl]

For each ``--seeds`` seed a run of the program with a short window at
the cell's own load (the numbers it compares); for each of
``--controls`` (names of ``reference/lowprec.py::CONTROLS``; ``lower``,
the contract's control, by default) and each ``--control-seeds`` seed
the same with that lower-precision reference in the program's place; for
each ``--fault-seeds`` seed of a training cell, the reference with half
of each batch left out against the reference.  ``--set`` changes a key of the cell's traffic or
configuration file for a witness (``config.port_config.backbone.
compute_dtype="float32"``).  One JSON line a reading, on standard output and in
``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench.common.spec import Cell
from portbench.run import run_cell


def setter(pairs):
    """``adjust(cell)`` setting each ``traffic.KEY`` or ``config.A.B``
    to its JSON value."""
    def adjust(cell):
        for pair in pairs:
            path, value = pair.split("=", 1)
            head, *keys = path.split(".")
            d = cell.traffic if head == "traffic" else cell.config
            for k in keys[:-1]:
                d = d[k]
            d[keys[-1]] = json.loads(value)
    return adjust


def fault_half(name: str, seed: int, adjust) -> dict:
    """A training cell's numbers for the reference with half of each
    batch left out, against the reference."""
    cell = Cell(name)
    adjust(cell)
    drv = cell.driver.Driver(cell.config, cell.traffic, cell.model, seed,
                             "cuda", control="head")
    drv.setup()
    batches, ref = drv.reference_batches(), drv.reference()
    return drv.compare(ref.train(batches, drv.lr, fault="half"),
                       ref.train(batches, drv.lr))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=["lower"])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    jobs = ([("program", s) for s in args.seeds]
            + [(c, s) for c in args.controls for s in args.control_seeds]
            + [("fault_half", s) for s in args.fault_seeds])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        if kind == "fault_half":
            numbers = fault_half(args.workload, seed, setter(args.set))
        else:
            r = run_cell(args.workload, seed, args.seconds, False, "cuda",
                         adjust=setter(args.set),
                         control=None if kind == "program" else kind)
            numbers = {k: c["value"] for k, c in r["checks"].items()}
        line = json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                           "set": args.set,
                           "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
