"""The port's training fast paths and tower training through its CLI
(srsem_torch/cli/main.py) on the CPU: each flag of the JAX CLI runs,
prints the JAX CLI's JSON keys, and writes checkpoints in the JAX
package's layout, which the JAX package's ``restore_checkpoint`` reads and
the port loads back.  The numbers themselves are held to JAX in the
library-level tests (tests/test_torch_port_amortized_*.py), so the JAX CLI
is not run here.  Tower training through the CLI:
tests/test_torch_port_finetune_cli.py.

Files: tests/test_torch_port_train_cli.py's (64 px, float32, a CLIP tower
with random BN statistics); the sweeps' package defaults are wrapped to
64 px float32, one epoch of batch 4, as tests/test_torch_port_sweep_cli.py
does, and the CLU decoder to width 1/8 (``narrow_decoder``): the layout
checked here does not depend on the width, and the full-width decoder's
120M parameters only cost time on the CPU.
"""

import json

import numpy as np
import pytest

import srsem_torch.train.loop as port_loop
import srsem_torch.train.multisweep as port_multisweep

from srsem.train.checkpoint import restore_checkpoint as jax_restore
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig, LocalModelConfig
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import load_jax_local_params
from test_torch_port_sweep_cli import small_points  # noqa: F401 — fixture
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_train_cli import (  # noqa: F401 — fixtures
    SETS,
    SIZE,
    TRAIN_SETS,
    files,
)

CPU = ["--device", "cpu"]
WM = 0.125


@pytest.fixture()
def narrow_decoder(monkeypatch):
    """Every CluUnet the training commands build, at decoder width 1/8."""
    def make(cfg, split_tower=False, width_mult=1.0, generator=None):
        return make_local_model(cfg, split_tower, WM, generator)

    for module in (port_loop, port_multisweep):
        monkeypatch.setattr(module, "make_local_model", make)
CLU = ["--min-caps", "4", *SETS, *TRAIN_SETS, "--train-set", "epochs=1"]
SWEEP_CLU = ["--limit-axis", "imgamincaps=4", "--limit-axis", "only_hq=False",
             "--limit-axis", "backbone_kind='resnet50_clip'"]


def _run(argv, capsys):
    assert port_main(argv + CPU) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _decoder_layout(tree):
    """The CluUnet decoder's JAX parameter paths: ``decoder.{lvl}`` with
    conv1, bn1, conv2 and (levels 1-4) bn2."""
    return {k[:2] for k in flatten_dict(tree)}


DECODER = ({(f"decoder.{lvl}", m) for lvl in range(5)
            for m in ("conv1", "bn1", "conv2")}
           | {(f"decoder.{lvl}", "bn2") for lvl in range(1, 5)})


def _check_clu_checkpoint(directory):
    """Read by the JAX package's restore_checkpoint: ``{trainable,
    batch_stats}`` with the decoder's layout; loaded back into a port
    CluUnet, every leaf lands."""
    restored = jax_restore(str(directory))
    assert set(restored) == {"trainable", "batch_stats"}
    assert _decoder_layout(restored["trainable"]) == DECODER
    assert {k[:2] for k in flatten_dict(restored["batch_stats"])} == {
        k for k in DECODER if k[1].startswith("bn")}
    model = make_local_model(LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")),
        width_mult=WM)
    load_jax_local_params(model, {"params": restored["trainable"],
                                  "batch_stats": restored["batch_stats"]},
                          partial=True)
    w = restored["trainable"]["decoder.2"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        model.decoder[2][0].weight.permute(2, 3, 1, 0).numpy(), w)


@pytest.mark.parametrize("argv", [
    ["train-clu", "{pairs}", "--cached-diffs"],
    ["train-clu", "{pairs}", "--thresholds", "none", "0.4"],
    ["sweep-global", "{scores}", "{root}", "--shared-tower"],
    ["sweep-global", "{scores}", "{root}", "--cached-diffs"],
    ["sweep-global", "{scores}", "{root}", "--cached-stats"],
    ["sweep-global", "{scores}", "{root}", "--closed-form", "--l2", "1e-3"],
    ["sweep-clu", "{pairs}", "--limit-axis", "lora_rank=None",
     "--shared-thresholds"],
], ids=["cached-diffs", "thresholds", "shared-tower", "sweep-cached-diffs",
        "cached-stats", "closed-form", "shared-thresholds"])
def test_fast_paths_run(files, tmp_path, capsys, small_points,
                        narrow_decoder, argv):
    """Each fast path of the JAX CLI: its JSON keys, and its checkpoints
    or summary lines."""
    names = {"pairs": files / "pairs.csv", "scores": files / "scores.csv",
             "root": files}
    argv = [a.format(**names) for a in argv]
    ck = tmp_path / "ckpt"
    if argv[0] == "train-clu":
        out = _run(argv + CLU + ["--checkpoint-dir", str(ck)], capsys)
        if "--cached-diffs" in argv:
            assert set(out) == {"val_metrics", "train_loss"}
            assert set(out["val_metrics"]) == {"mse"}
            assert np.isfinite(out["train_loss"])
            _check_clu_checkpoint(ck)
        else:
            assert [r["name"] for r in out] == ["threshold-None",
                                                "threshold-0.4"]
            for r in out:
                assert set(r) == {"name", "train_loss", "val_mse"}
                assert np.isfinite(r["val_mse"])
                _check_clu_checkpoint(ck / r["name"])
    elif argv[0] == "sweep-global":
        out = _run(argv + ["--backbone-checkpoint",
                           str(files / "tower.msgpack")], capsys)
        assert [r["name"] for r in out] == ["depth-1", "depth-2", "depth-3"]
        for r in out:
            assert set(r) == {"name", "val_srcc", "val_mse"}
            assert np.isfinite(r["val_mse"])
    else:
        summary = tmp_path / "sweep.jsonl"
        out = _run(argv + SWEEP_CLU + ["--summary", str(summary)], capsys)
        assert out == {"points": 3}
        rows = [json.loads(line) for line in summary.read_text().splitlines()]
        assert [r["point"]["threshold"] for r in rows] == [None, 0.4, 0.9]
        for r in rows:
            assert r["shared_thresholds"] is True
            assert set(r) == {"name", "point", "seconds", "shared_thresholds",
                              "mse", "train_loss"}


def test_thresholds_and_cached_diffs_pick_one(files):
    with pytest.raises(SystemExit, match="pick one"):
        port_main(["train-clu", str(files / "pairs.csv"), "--cached-diffs",
                   "--thresholds", "0.4", *CLU, *CPU])
