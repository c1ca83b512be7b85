"""The port's training CLIs (srsem_torch/cli/main.py: ``train-global``,
``eval-global``, ``train-clu``) vs the JAX CLI (srsem/cli/main.py) in
process, on the same tiny files, and checkpoints read both ways.

Data: a user-study set (``SR/`` and ``HQ/`` images and a CSV; SR = the GT
blended with a permuted copy at strength α, label α, as
tests/test_srcc_rehearsal.py plants its signal) and a KonIQ-style pairs CSV
with pickled cosine maps.  Both CLIs get the same ``--backbone-checkpoint``
(a flax msgpack CLIP tower with random BN statistics), 64 px, float32,
``mesh.data_axis=1`` for JAX (one CPU device).  Each CLI draws its
model's initial weights from its own generator; the port's
``make_*_model`` are wrapped here to start from the weights JAX's
``run_training`` draws (``PRNGKey(seed)``), so the two train the same
model.  Tolerances as
tests/test_torch_port_train.py: losses and metrics rtol 3e-3, trained
parameters atol 2·n_steps·lr; eval-global on the same checkpoint within
1e-4 (tests/test_torch_port_cli.py's score tolerance).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import srsem_torch.train.loop as port_loop
from srsem.cli.main import main as jax_main
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.models.local_models import make_local_model as jax_make_local
from srsem.utils.convert import convert_clip_resnet50
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.models.global_models import make_global_model
from srsem_torch.train.checkpoint import restore_checkpoint
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import load_jax_global_params, load_jax_local_params

SIZE, LR = 64, 1e-4
SETS = ["--set", f"backbone.image_size={SIZE}",
        "--set", "backbone.compute_dtype=float32"]
TRAIN_SETS = ["--train-set", "batch_size=4", "--train-set", "mesh.data_axis=1"]


@pytest.fixture(autouse=True)
def _reference_cpu_convs():
    """The CPU's reference float32 convolutions, not oneDNN's, whose conv
    backward lands ~5e-3 from a float64 reference on the decoder
    (tests/test_torch_port_train.py)."""
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tower, a user-study set under both CSV conventions, and a
    pairs CSV with pickled maps."""
    root = tmp_path_factory.mktemp("study")
    rng = np.random.default_rng(0)
    model = make_global_model(GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")),
        torch.Generator().manual_seed(1))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.backbone.named_modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if name.endswith(
                    "bn3") else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))
    tower = root / "tower.msgpack"
    tower.write_bytes(serialization.to_bytes(
        convert_clip_resnet50(model.backbone.state_dict(), image_size=SIZE)))
    (root / "SR").mkdir()
    (root / "HQ").mkdir()
    scores, answers, pairs = [], [], ["img_a_pth,img_b_pth,out_paths,ima_ncaps"]
    for i in range(10):
        gt = rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)
        alpha = (i + 0.5) / 10
        perm = rng.permutation(gt.reshape(-1, 3)).reshape(gt.shape)
        sr = ((1 - alpha) * gt + alpha * perm).astype(np.uint8)
        Image.fromarray(gt).save(root / "HQ" / f"{i}.jpg", quality=95)
        Image.fromarray(sr).save(root / "SR" / f"m_{i}.png")
        scores.append(f"m_{i}.png,{alpha!r}")
        answers.append(f"m_{i}.png,{'Yes' if alpha < 0.5 else 'No'}")
        cosmap = rng.uniform(0, 1, (16, 16)).astype(np.float32)
        with open(root / f"map_{i}.pkl", "wb") as f:
            pickle.dump(cosmap, f)
        pairs.append(f"{root / 'HQ' / f'{i}.jpg'},{root / 'SR' / f'm_{i}.png'},"
                     f"{root / f'map_{i}.pkl'},{[1, 4, 4, 4, 8, 2, 4, 1, 2, 2][i]}")
    (root / "scores.csv").write_text(
        "img_names,userStudyScores\n" + "\n".join(scores) + "\n")
    (root / "answers.csv").write_text(
        "Super Resolution Image,Answer\n" + "\n".join(answers) + "\n")
    (root / "pairs.csv").write_text("\n".join(pairs) + "\n")
    return root


@pytest.fixture()
def jax_init(monkeypatch):
    """The port's training CLIs start from JAX's initial weights: the
    variables ``run_training`` draws with ``PRNGKey(42)`` (the default
    seed) for the configuration the CLI builds."""
    real_global, real_local = port_loop.make_global_model, port_loop.make_local_model
    z = jnp.zeros((1, SIZE, SIZE, 3))

    def bb(cfg):
        return JaxBackboneConfig(kind=cfg.backbone.kind,
                                 image_size=cfg.backbone.image_size,
                                 compute_dtype=cfg.backbone.compute_dtype)

    def make_global(cfg, generator=None):
        jm = jax_make_global(JaxGlobalConfig(backbone=bb(cfg), head=cfg.head,
                                             depth=cfg.depth))
        return load_jax_global_params(
            real_global(cfg, generator),
            jax.device_get(jm.init(jax.random.PRNGKey(42), z, z)))

    def make_local(cfg, generator=None):
        jm = jax_make_local(JaxLocalConfig(backbone=bb(cfg)))
        return load_jax_local_params(
            real_local(cfg, generator=generator),
            jax.device_get(jm.init(jax.random.PRNGKey(42), z, z, train=False)))

    monkeypatch.setattr(port_loop, "make_global_model", make_global)
    monkeypatch.setattr(port_loop, "make_local_model", make_local)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got, want, rtol, atol, what):
    fg, fw = flatten_dict(got), flatten_dict(want)
    assert set(fg) == set(fw), what
    for key, w in fw.items():
        np.testing.assert_allclose(np.asarray(fg[key], np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {key}")


def test_train_global_and_eval_global_match_jax(files, tmp_path, capsys,
                                                jax_init):
    """train-global (stages_cnn depth 3, two epochs of two steps) in both
    CLIs: the same validation metrics and trained head; then eval-global
    of each checkpoint in both CLIs (JAX reads the port's, the port
    reads JAX's): the same n, SRCC and MSE."""
    common = [str(files / "scores.csv"), str(files), "--backbone-checkpoint",
              str(files / "tower.msgpack"), *SETS]
    out = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        assert main(["train-global", *common, *TRAIN_SETS,
                     "--train-set", "epochs=2", "--checkpoint-dir",
                     str(tmp_path / name), *extra]) == 0
        out[name] = _last_json(capsys)
    assert out["port"]["steps"] == out["jax"]["steps"] == 4
    for key in ("loss", "mse", "srcc"):
        np.testing.assert_allclose(out["port"]["val_metrics"][key],
                                   out["jax"]["val_metrics"][key],
                                   rtol=3e-3, atol=1e-5, err_msg=key)
    ckpt = {n: restore_checkpoint(str(tmp_path / n)) for n in out}
    _close(ckpt["port"]["trainable"], ckpt["jax"]["trainable"], 1e-3,
           2 * 4 * LR, "trainable")
    assert int(ckpt["port"]["opt_state"]["0"]["count"]) == 4
    assert set(flatten_dict(ckpt["port"]["opt_state"])) == set(
        flatten_dict(ckpt["jax"]["opt_state"]))
    evals = {}
    for reader, main, extra in (("jax", jax_main, []),
                                ("port", port_main, ["--device", "cpu"])):
        for writer in ("jax", "port"):
            assert main(["eval-global", *common, "--backbone",
                         "resnet50_clip", "--checkpoint", str(tmp_path / writer),
                         "--batch-size", "4", *extra]) == 0
            evals[reader, writer] = _last_json(capsys)
    for writer in ("jax", "port"):
        got, want = evals["port", writer], evals["jax", writer]
        assert got["n"] == want["n"] == 10
        np.testing.assert_allclose([got["srcc"], got["mse"]],
                                   [want["srcc"], want["mse"]],
                                   rtol=1e-4, atol=1e-6, err_msg=writer)
    # --val-only on the other CSV convention (binarized answers).
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        assert main(["eval-global", str(files / "answers.csv"), str(files),
                     "--backbone", "resnet50_clip", "--backbone-checkpoint",
                     str(files / "tower.msgpack"), *SETS, "--val-only",
                     "--checkpoint", str(tmp_path / "port"), *extra]) == 0
        evals[main] = _last_json(capsys)
    assert evals[port_main]["n"] == evals[jax_main]["n"] == 2
    np.testing.assert_allclose(evals[port_main]["mse"], evals[jax_main]["mse"],
                               rtol=1e-4)


def test_train_clu_matches_jax(files, tmp_path, capsys, jax_init):
    """train-clu (full-width decoder, maps binarized at 0.4, rows with at
    least 4 captions: five, one held out, one step): the same validation
    MSE, trained decoder and BatchNorm running statistics."""
    common = [str(files / "pairs.csv"), "--backbone-checkpoint",
              str(files / "tower.msgpack"), "--min-caps", "4", *SETS,
              *TRAIN_SETS, "--train-set", "epochs=1",
              "--train-set", "map_threshold=0.4"]
    out = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        assert main(["train-clu", *common, "--checkpoint-dir",
                     str(tmp_path / name), *extra]) == 0
        out[name] = _last_json(capsys)
    assert out["port"]["steps"] == out["jax"]["steps"] == 1
    np.testing.assert_allclose(out["port"]["val_metrics"]["mse"],
                               out["jax"]["val_metrics"]["mse"], rtol=3e-3)
    ckpt = {n: restore_checkpoint(str(tmp_path / n)) for n in out}
    _close(ckpt["port"]["trainable"], ckpt["jax"]["trainable"], 1e-3,
           2 * LR, "decoder")
    _close(ckpt["port"]["batch_stats"], ckpt["jax"]["batch_stats"], 1e-3,
           1e-4, "batch_stats")


@pytest.mark.parametrize("argv", [
    ["train-clu", "{pairs}", "--cached-diffs"],
    ["train-clu", "{pairs}", "--thresholds", "none", "0.4"],
    ["sweep-global", "{scores}", "{root}", "--shared-tower"],
    ["sweep-global", "{scores}", "{root}", "--cached-diffs"],
    ["sweep-global", "{scores}", "{root}", "--cached-stats"],
    ["sweep-global", "{scores}", "{root}", "--closed-form"],
    ["sweep-clu", "{pairs}", "--limit-axis", "lora_rank=None",
     "--shared-thresholds"],
], ids=["cached-diffs", "thresholds", "shared-tower", "sweep-cached-diffs",
        "cached-stats", "closed-form", "shared-thresholds"])
def test_fast_paths_raise_citing_a8(files, argv):
    names = {"pairs": files / "pairs.csv", "scores": files / "scores.csv",
             "root": files}
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        port_main([a.format(**names) for a in argv] + ["--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["train-global", "{scores}", "{root}", "--set", "enc_ft=True"],
    ["train-clu", "{pairs}", "--set", "lora_rank=8"],
    ["sweep-clu", "{pairs}"],
], ids=["enc_ft", "lora", "sweep-lora-axis"])
def test_tower_training_raises_citing_a7(files, tmp_path, argv):
    """Before any point trains: the default CLU grid has LoRA points."""
    names = {"pairs": files / "pairs.csv", "scores": files / "scores.csv",
             "root": files}
    summary = tmp_path / "sweep.jsonl"
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        port_main([a.format(**names) for a in argv] + (
            ["--summary", str(summary)] if argv[0] == "sweep-clu"
            else SETS[:2]) + ["--device", "cpu"])
    assert not summary.exists()


def test_training_needs_the_card_unless_asked(files):
    """Without --device the training CLIs run on the card; with none
    present they fail before loading anything."""
    for argv in (["train-global", str(files / "scores.csv"), str(files)],
                 ["train-clu", str(files / "pairs.csv")]):
        with pytest.raises(RuntimeError, match="is_available"):
            port_main(argv)
