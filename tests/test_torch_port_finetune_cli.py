"""Tower training through the port's CLI (srsem_torch/cli/main.py) on the
CPU: ``train-global --set enc_ft=True``, ``train-clu --set lora_rank=8``
and the CLU grid's ``lora_rank`` axis (None, 32, "full") in ``sweep-clu``
run, and their checkpoints hold the tower's trained leaves in the JAX
package's layout, which the JAX package's ``restore_checkpoint`` reads and
the port loads back.  The train steps themselves are held to JAX in
tests/test_torch_port_finetune.py.  Files and sizes (the CLU decoder at
width 1/8): tests/test_torch_port_fast_cli.py's.
"""

import json

import numpy as np
import pytest
import torch

from srsem.train.checkpoint import restore_checkpoint as jax_restore
from srsem_torch.config import BackboneConfig, LocalModelConfig
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train.checkpoint import restore_checkpoint
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import load_jax_local_params
from test_torch_port_fast_cli import (  # noqa: F401 — fixture
    CLU,
    SETS,
    SIZE,
    SWEEP_CLU,
    TRAIN_SETS,
    WM,
    _run,
    narrow_decoder,
)
from test_torch_port_sweep_cli import small_points  # noqa: F401 — fixture
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_train_cli import files  # noqa: F401 — fixture


@pytest.mark.parametrize("argv", [
    ["train-global", "{scores}", "{root}", "--set", "enc_ft=True",
     "--set", "depth=1"],
    ["train-clu", "{pairs}", "--set", "lora_rank=8", *CLU],
    ["sweep-clu", "{pairs}", *SWEEP_CLU, "--limit-axis", "threshold=0.4"],
], ids=["enc_ft", "lora", "sweep-lora-axis"])
def test_tower_training_runs(files, tmp_path, capsys, small_points,
                             narrow_decoder, argv):
    """enc_ft and LoRA train the tower through the CLI and checkpoint its
    trained leaves in the JAX layout (the BN statistics under enc_ft, the
    factors alone under LoRA); the CLU grid's lora_rank axis (None, 32,
    "full") runs every point."""
    names = {"pairs": files / "pairs.csv", "scores": files / "scores.csv",
             "root": files}
    argv = [a.format(**names) for a in argv]
    ck = tmp_path / "ckpt"
    if argv[0] == "sweep-clu":
        summary = tmp_path / "sweep.jsonl"
        assert _run(argv + ["--summary", str(summary)], capsys) == {
            "points": 3}
        rows = [json.loads(line) for line in summary.read_text().splitlines()]
        assert [r["point"]["lora_rank"] for r in rows] == [None, 32, "full"]
        assert all(np.isfinite(r["mse"]) for r in rows)
        return
    extra = [] if argv[0] == "train-clu" else [*SETS, *TRAIN_SETS,
                                                "--train-set", "epochs=1"]
    out = _run(argv + extra + ["--checkpoint-dir", str(ck)], capsys)
    assert out["steps"] >= 1 and np.isfinite(out["val_metrics"]["mse"])
    restored = jax_restore(str(ck))
    tower = flatten_dict(restored["trainable"]["backbone"])
    moments = flatten_dict(restored["opt_state"]["0"]["mu"]["backbone"])
    assert set(moments) == set(tower)
    if "enc_ft=True" in argv:
        assert ("stages.3.2", "bn3", "var") in tower
        assert ("attnpool", "out_proj", "kernel") in tower
        assert tower[("stem.conv1", "kernel")].shape == (3, 3, 3, 32)
    else:
        assert {k[-1] for k in tower} == {"lora_a", "lora_b"}
        assert tower[("stages.2.0", "downsample_conv", "lora_a")].shape == (
            512, 8)
        assert tower[("stem.conv1", "lora_b")].shape == (8, 32)
        restore = restore_checkpoint(str(ck))
        model = make_local_model(LocalModelConfig(
            backbone=BackboneConfig(kind="resnet50_clip", image_size=SIZE,
                                    compute_dtype="float32"), lora_rank=8),
            width_mult=WM)
        load_jax_local_params(model, {"params": restore["trainable"],
                                      "batch_stats": restore["batch_stats"]},
                              partial=True)
        torch.testing.assert_close(
            getattr(model.backbone.layer3[0].downsample, "0").lora_a,
            torch.from_numpy(np.asarray(
                tower[("stages.2.0", "downsample_conv", "lora_a")])))
