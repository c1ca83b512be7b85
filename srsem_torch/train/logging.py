"""Metric writers (stdout / JSONL / composite) — a copy of
srsem/train/logging.py without its optional wandb adapter, which no
ported command uses.

The reference logs per-batch and per-epoch losses to wandb
(reference: CLIPLPIPS_REG_training_sweep_example.py:74-98); here a writer
is anything with ``write(step, metrics)`` and ``close()``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


class StdoutWriter:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        body = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        print(f"{self.prefix}[step {step}] {body}", file=sys.stderr, flush=True)

    def close(self) -> None:
        pass


class JsonlWriter:
    def __init__(self, path: str):
        self.f = open(path, "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


class MultiWriter:
    def __init__(self, *writers):
        self.writers = writers

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        for w in self.writers:
            w.write(step, metrics)

    def close(self) -> None:
        for w in self.writers:
            w.close()


def default_writer(jsonl_path: Optional[str] = None, prefix: str = ""):
    if jsonl_path:
        return MultiWriter(StdoutWriter(prefix), JsonlWriter(jsonl_path))
    return StdoutWriter(prefix)
