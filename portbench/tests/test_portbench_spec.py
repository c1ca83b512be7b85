"""BENCHMARK.json loads, keeps to the benchmark's contract, and every file
a cell needs is found by name."""

import json
import re

import pytest

from portbench.common.spec import PKG, ROOT, Cell, benchmark, module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

BENCH = benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    # A full check: 2 + 14 runs a cell, each run_seconds + 60, each cell
    # 180 s more to compile, 1,200 s spare, within 43,200 s at 24 cells.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert not c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_what_the_contract_asks():
    for name in CELLS:
        cell = Cell(name, BENCH)
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = Cell(name, BENCH)
    assert cell.config["model"] and hasattr(cell.model, "Reference")
    assert hasattr(cell.driver, "Driver")
    assert cell.limits is not None, f"no portbench/limits/{name}.json"
    for k, v in cell.limits["limits"].items():
        assert v > 0, k
        assert cell.limits["readings"][k]["lower"] < v < cell.limits[
            "readings"][k]["upper"], k
    assert "lower" in cell.limits["controls"]
    for m in cell.end_to_end() + cell.per_layer():
        assert callable(module("metrics", m["name"]).read)


def test_config_files_state_their_source_and_assumptions():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] and cfg["assumed"]
        assert (PKG / "models" / f"{cfg['model']}.py").is_file()
