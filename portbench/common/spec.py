"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration: the ``file`` its entry gives (``configs/<name>.json``),
  whose ``"model"`` names ``models/<model>.py``;
* a traffic mix: ``traffic/<traffic>.json``, whose ``"driver"`` names
  ``drivers/<driver>.py``;
* a metric: ``metrics/<name>.py`` with ``read(ctx)``;
* a cell's limits: ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    if "." not in name:
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench, self.entry = bench, cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(PKG / "traffic" / f"{self.entry['traffic']}.json")
        self.model = module("models", self.config["model"])
        self.driver = module("drivers", self.traffic["driver"])
        limits = PKG / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.is_file() else None

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.applies(m)]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.applies(m) and m["moves"] in reported]

    def applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]
