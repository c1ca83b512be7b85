"""The port's CLI (srsem_torch/cli/main.py) vs the JAX CLI
(srsem/cli/main.py) with trained checkpoints, in process, on the same
files: ``score`` (stages_cnn on the ImageNet tower, and wperlay_cnn at
depth 11 on the CLIP tower through ``--set``), ``score-groups`` and
``score-maps-groups`` (the CLU decoder and its ``batch_stats``).

Both CLIs get the same ``--backbone-checkpoint`` (a flax msgpack tower
tree, as ``srsem convert`` writes) and the same ``--checkpoint`` directory
(srsem's ``save_checkpoint`` of a trainable subset, an Adam opt_state and
batch_stats).  Weights come from seeded port models with random BN
statistics through srsem/utils/convert.py.  f32, 64 px, batch 2; scores
within 1e-4, maps within 2e-4; a corrupt file gives a NaN row in both.
"""

import csv

import numpy as np
import optax
import pytest
import torch
from flax import serialization
from PIL import Image

from srsem.cli.main import main as jax_main
from srsem.train.checkpoint import save_checkpoint
from srsem.utils.convert import (
    convert_clip_resnet50,
    convert_clu_decoder,
    convert_global_head,
    convert_torch_resnet50,
)
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model

SIZE = 64


def _randomize_bn(model, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (FrozenBatchNorm, torch.nn.BatchNorm2d)):
                c = m.weight.shape[0]
                closing = (name.endswith(("bn3", "downsample.1"))
                           and "layer" in name)
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if closing
                                   else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))


def _write_tower(path, backbone, kind):
    sd = backbone.state_dict()
    tree = (convert_clip_resnet50(sd) if kind == "resnet50_clip"
            else convert_torch_resnet50(sd))
    path.write_bytes(serialization.to_bytes(tree))


def _write_checkpoint(directory, trainable, batch_stats):
    """A training-loop checkpoint (srsem/train/loop.py:138-142) at step 7,
    with a stale pointer-less step 3 beside it."""
    tree = {"trainable": trainable, "opt_state": optax.adam(1e-4).init(trainable),
            "batch_stats": batch_stats}
    save_checkpoint(str(directory), 3, tree)
    save_checkpoint(str(directory), 7, tree)


def _read(path):
    """CSV rows; pandas (the JAX CLI) writes NaN as an empty field."""
    with open(path, newline="") as f:
        return [{k: v if k.startswith("img") or k == "image_name"
                 else float(v or "nan") for k, v in row.items()}
                for row in csv.DictReader(f)]


@pytest.mark.parametrize("kind,sets", [
    ("resnet50", []),
    ("resnet50_clip", ["--set", "head=wperlay_cnn", "--set", "depth=11"])],
    ids=["stages_cnn", "wperlay_cnn"])
def test_score_with_checkpoint_matches_jax(tmp_path, kind, sets):
    head, depth = ("wperlay_cnn", 11) if sets else ("stages_cnn", 3)
    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind=kind, image_size=SIZE, compute_dtype="float32"),
        head=head, depth=depth)
    model = make_global_model(cfg, torch.Generator().manual_seed(4))
    _randomize_bn(model.backbone, 4)
    with torch.no_grad():  # a trained head: nonnegative, live, not the seed's
        for layer in model.aggregator.w_layers:
            layer.weight.abs_().mul_(30.0)
            layer.bias.add_(1.0)
    _write_tower(tmp_path / "tower.msgpack", model.backbone, kind)
    _write_checkpoint(tmp_path / "ckpt",
                      convert_global_head(model.aggregator.state_dict()), {})
    rng = np.random.default_rng(1)
    rows = []
    for i in range(3):
        a = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-30, 31, a.shape) // (i + 1),
                    0, 255).astype(np.uint8)
        Image.fromarray(a).save(tmp_path / f"gt{i}.png")
        Image.fromarray(b).save(tmp_path / f"sr{i}.png")
        rows.append(f"{tmp_path / f'gt{i}.png'},{tmp_path / f'sr{i}.png'}")
    (tmp_path / "bad.png").write_bytes(b"not a PNG")
    rows[1] = rows[1].split(",")[0] + f",{tmp_path / 'bad.png'}"
    (tmp_path / "pairs.csv").write_text("img_a_pth,img_b_pth\n"
                                        + "\n".join(rows) + "\n")
    common = [str(tmp_path / "pairs.csv"), "--backbone", kind,
              "--backbone-checkpoint", str(tmp_path / "tower.msgpack"),
              "--checkpoint", str(tmp_path / "ckpt"), "--batch-size", "2",
              "--set", f"backbone.image_size={SIZE}",
              "--set", "backbone.compute_dtype=float32", *sets]
    assert jax_main(["score", *common, "--out", str(tmp_path / "jax.csv")]) == 0
    assert port_main(["score", *common, "--device", "cpu",
                      "--out", str(tmp_path / "port.csv")]) == 0
    want = np.array([r["score"] for r in _read(tmp_path / "jax.csv")])
    got = np.array([r["score"] for r in _read(tmp_path / "port.csv")])
    assert np.isnan(want[1]) and np.isnan(got[1])
    keep = [0, 2]
    assert (want[keep] > 1.0).all() and abs(want[0] - want[2]) > 1e-2
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-4, atol=1e-4)
    # Without the checkpoint the port's seeded head scores otherwise.
    assert port_main(["score", *common[:5], *common[7:], "--device", "cpu",
                      "--out", str(tmp_path / "seeded.csv")]) == 0
    seeded = np.array([r["score"] for r in _read(tmp_path / "seeded.csv")])
    assert not np.allclose(seeded[keep], got[keep], rtol=1e-2)


def _folders(root, seed):
    """GT + two SR folders of three stems, SR noise by stem and folder;
    one SR file corrupt."""
    rng = np.random.default_rng(seed)
    dirs = [root / n for n in ("gt", "esrgan", "swinir")]
    for d in dirs:
        d.mkdir()
    for i, stem in enumerate(("im0", "im1", "im2")):
        img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
        Image.fromarray(img).save(dirs[0] / f"{stem}.png")
        for j, d in enumerate(dirs[1:]):
            noisy = np.clip(img.astype(int) + rng.integers(-30, 31, img.shape)
                            // (i + j + 1), 0, 255).astype(np.uint8)
            Image.fromarray(noisy).save(d / f"{stem}.png")
    (dirs[2] / "im1.png").write_bytes(b"not a PNG")
    return dirs


def _assert_rows_close(want, got, tol):
    assert [r["image_name"] for r in got] == [r["image_name"] for r in want]
    for rw, rg in zip(want, got):
        assert list(rg) == list(rw)
        w = np.array([rw[k] for k in rw if k != "image_name"])
        g = np.array([rg[k] for k in rw if k != "image_name"])
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_score_groups_with_checkpoint_matches_jax(tmp_path):
    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50", image_size=SIZE, compute_dtype="float32"), depth=2)
    model = make_global_model(cfg, torch.Generator().manual_seed(5))
    _randomize_bn(model.backbone, 5)
    with torch.no_grad():
        for layer in model.aggregator.w_layers:
            layer.weight.abs_().mul_(30.0)
            layer.bias.add_(1.0)
    _write_tower(tmp_path / "tower.msgpack", model.backbone, "resnet50")
    _write_checkpoint(tmp_path / "ckpt",
                      convert_global_head(model.aggregator.state_dict()), {})
    common = [*map(str, _folders(tmp_path, 3)), "--image-size", str(SIZE),
              "--dtype", "float32", "--depth", "2", "--batch-size", "2",
              "--checkpoint", str(tmp_path / "ckpt"),
              "--backbone-checkpoint", str(tmp_path / "tower.msgpack")]
    assert jax_main(["score-groups", *common,
                     "--out", str(tmp_path / "jax.csv")]) == 0
    assert port_main(["score-groups", *common, "--device", "cpu",
                      "--out", str(tmp_path / "port.csv")]) == 0
    want, got = _read(tmp_path / "jax.csv"), _read(tmp_path / "port.csv")
    assert np.isnan(got[1]["swinir"]) and got[0]["esrgan"] > 1.0
    _assert_rows_close(want, got, 1e-4)


def test_score_maps_groups_with_checkpoint_matches_jax(tmp_path):
    cfg = LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"))
    model = make_local_model(cfg, generator=torch.Generator().manual_seed(6))
    _randomize_bn(model, 6)
    with torch.no_grad():
        model.decoder[0][3].weight.mul_(0.1)
        model.decoder[0][3].bias.add_(0.5)
    _write_tower(tmp_path / "tower.msgpack", model.backbone, "resnet50_clip")
    dec = convert_clu_decoder({k: v for k, v in model.state_dict().items()
                               if k.startswith("decoder.")})
    _write_checkpoint(tmp_path / "ckpt", dec["params"], dec["batch_stats"])
    dirs = _folders(tmp_path, 2)
    common = [*map(str, dirs), "--image-size", str(SIZE), "--dtype", "float32",
              "--batch-size", "2", "--checkpoint", str(tmp_path / "ckpt"),
              "--backbone-checkpoint", str(tmp_path / "tower.msgpack")]
    assert jax_main(["score-maps-groups", *common,
                     "--out", str(tmp_path / "jax.csv"),
                     "--maps-dir", str(tmp_path / "jax_maps")]) == 0
    assert port_main(["score-maps-groups", *common, "--device", "cpu",
                      "--out", str(tmp_path / "port.csv"),
                      "--maps-dir", str(tmp_path / "port_maps")]) == 0
    want, got = _read(tmp_path / "jax.csv"), _read(tmp_path / "port.csv")
    _assert_rows_close(want, got, 1e-4)
    assert np.isnan(got[1]["swinir_map_mean"])
    maps = sorted(p.name for p in (tmp_path / "jax_maps").glob("*.npy"))
    assert maps == sorted(p.name for p in (tmp_path / "port_maps").glob("*.npy"))
    assert len(maps) == 4
    for name in maps:
        w = np.load(tmp_path / "jax_maps" / name)
        assert w.std() > 1e-3
        np.testing.assert_allclose(np.load(tmp_path / "port_maps" / name), w,
                                   rtol=2e-4, atol=2e-4)
