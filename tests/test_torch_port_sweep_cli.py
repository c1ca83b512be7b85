"""The port's sweep CLIs (``sweep-global``, ``sweep-clu``; srsem_torch/
train/sweep.py) vs the JAX CLI's, in process, on the files and initial
weights of tests/test_torch_port_train_cli.py.

A sweep point builds its configuration from the package defaults (224 px,
bf16, 30 or 60 epochs); both packages' ``BackboneConfig`` and
``TrainConfig`` are wrapped here to 64 px float32, one epoch of batch 4
(and one CPU device for JAX), so each point trains one or two steps.  Per
point, the validation metrics agree within rtol 3e-3.
"""

import json

import numpy as np
import pytest

import srsem.core.config as jax_config
import srsem_torch.train.sweep as port_sweep
from srsem.cli.main import main as jax_main
from srsem_torch.cli.main import main as port_main
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_train_cli import (  # noqa: F401 — fixtures
    SIZE,
    _reference_cpu_convs,
    files,
    jax_init,
)


@pytest.fixture()
def small_points(monkeypatch):
    for module in (jax_config, port_sweep):
        bb, tc = module.BackboneConfig, module.TrainConfig
        monkeypatch.setattr(module, "BackboneConfig", lambda _bb=bb, **kw: _bb(
            **{**kw, "image_size": SIZE, "compute_dtype": "float32"}))
        monkeypatch.setattr(module, "TrainConfig", lambda _tc=tc, **kw: _tc(
            **{**kw, "epochs": 1, "batch_size": 4,
               "mesh": jax_config.MeshConfig(data_axis=1)}))


def _summaries(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_sweep_global_matches_jax(files, tmp_path, capsys, jax_init,
                                  small_points):
    """The depth grid {1, 2, 3} on the CLIP tower: three points, each the
    same validation SRCC and MSE, and the same summary names."""
    out = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        assert main(["sweep-global", str(files / "scores.csv"), str(files),
                     "--backbone-checkpoint", str(files / "tower.msgpack"),
                     "--summary", str(tmp_path / f"{name}.jsonl"),
                     *extra]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in out["port"]] == [r["name"] for r in out["jax"]]
    assert len(out["port"]) == 3
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_allclose([got["val_srcc"], got["val_mse"]],
                                   [want["val_srcc"], want["val_mse"]],
                                   rtol=3e-3, atol=1e-5, err_msg=got["name"])
    rows = _summaries(tmp_path / "port.jsonl")
    assert [r["point"] for r in rows] == [{"depth": d} for d in (1, 2, 3)]


def test_sweep_clu_matches_jax(files, tmp_path, capsys, jax_init,
                               small_points):
    """One point of the CLU grid (the axes limited as a user limits them;
    the tower trains in no point): the same validation MSE."""
    argv = [str(files / "pairs.csv"), "--limit-axis", "lora_rank=None",
            "--limit-axis", "imgamincaps=4", "--limit-axis", "only_hq=False",
            "--limit-axis", "threshold=0.4",
            "--limit-axis", "backbone_kind='resnet50_clip'"]
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        assert main(["sweep-clu", *argv, "--summary",
                     str(tmp_path / f"{name}.jsonl"), *extra]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == {"points": 1}
    got, want = (_summaries(tmp_path / f"{n}.jsonl") for n in ("port", "jax"))
    assert got[0]["name"] == want[0]["name"]
    assert got[0]["point"] == want[0]["point"]
    np.testing.assert_allclose(got[0]["mse"], want[0]["mse"], rtol=3e-3)
