"""Port GroupedPairScorer (srsem_torch/eval/grouped.py) and
``score-groups`` vs the JAX package's GroupedPairScorer, same weights, and
vs the port's own PairScorer on the repeated pairs.

Weights come from a seeded port model with random frozen-BN statistics,
go to JAX variables through srsem/utils/convert.py and come back into a
fresh port model through ``load_jax_global_params`` (as in
tests/test_torch_port_scorer.py).  f32, 64 px, depth 3.  Against JAX
(dense XLA tower, one-device mesh) the tolerance is 1e-3, the JAX
package's own over the 16-block tower (tests/test_fused_bottleneck.py);
against the port's PairScorer on the same tower path 1e-5, the head's
float32 sums in another order.
"""

import csv
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.meshes import create_mesh
from srsem.eval.grouped import GroupedPairScorer as JaxGroupedPairScorer
from srsem.utils.convert import convert_global_head, convert_torch_resnet50
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.eval.grouped import GroupedPairScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import make_global_model
from srsem_torch.utils.convert import load_jax_global_params
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]
CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=64, compute_dtype="float32"), depth=3)


def _jax_variables(seed):
    """JAX GlobalPairScorer variables (numpy) from a seeded port model:
    random frozen BN (small gammas close each residual branch), head
    weights made nonnegative and scaled so the squared diffs carry each
    score, biases +1 so the final ReLU passes every score."""
    model = make_global_model(CFG, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name, m in model.backbone.named_modules():
        if isinstance(m, FrozenBatchNorm):
            c = m.weight.shape[0]
            closing = name.endswith(("bn3", "downsample.1"))
            m.weight.copy_(torch.tensor(rng.uniform(0.1, 0.3, c) if closing
                                        else rng.uniform(0.5, 1.5, c)))
            m.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    head = convert_global_head(model.aggregator.state_dict())["aggregator"]
    head = {k: {"kernel": np.abs(v["kernel"]) * 100.0, "bias": v["bias"] + 1.0}
            for k, v in head.items()}
    return {"params": {
        "backbone": convert_torch_resnet50(model.backbone.state_dict()),
        "aggregator": head}}


@pytest.fixture(scope="module")
def variables():
    return _jax_variables(3)


@pytest.fixture(scope="module")
def port_model(variables):
    return load_jax_global_params(make_global_model(CFG), variables)


def _groups(seed, g, k):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (g, 64, 64, 3), dtype=np.uint8)
    noise = rng.integers(-40, 41, (g, k, 64, 64, 3))
    sr = np.clip(gt[:, None].astype(int) + noise, 0, 255).astype(np.uint8)
    return gt, sr


def test_grouped_scorer_matches_jax(variables, port_model):
    g, k = 2, 2
    gt, sr = _groups(4, g, k)
    jcfg = JaxGlobalConfig(backbone=JaxBackboneConfig(
        kind="resnet50", image_size=64, compute_dtype="float32"),
        head="stages_cnn", depth=3)
    jax_scorer = JaxGroupedPairScorer(jcfg, variables, k=k, batch_size=g,
                                      mesh=create_mesh(data=1))
    want = np.asarray(jax.device_get(jax_scorer.score_arrays(gt, sr)))
    assert want.shape == (g, k) and (want > 1.5).all()
    for fused in (True, False):
        got = GroupedPairScorer(CFG, port_model, k=k, batch_size=g,
                                fused_tower=fused,
                                device="cpu").score_arrays(gt, sr)
        assert got.dtype == torch.float32 and got.shape == (g, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", [1, 3])
def test_grouped_scorer_matches_pairwise(port_model, k):
    g = 2
    gt, sr = _groups(5, g, k)
    got = GroupedPairScorer(CFG, port_model, k=k, batch_size=g,
                            device="cpu").score_arrays(gt, sr)
    pairs = PairScorer(CFG, port_model, batch_size=g * k, device="cpu")
    want = pairs.score_arrays(np.repeat(gt, k, axis=0),
                              sr.reshape(g * k, 64, 64, 3))
    torch.testing.assert_close(got.reshape(-1), want, rtol=1e-5, atol=1e-5)


def test_grouped_scorer_heads(port_model):
    """The MLP heads have no grouped form (JAX's ValueError); a ViT head
    needs the ViT tower (a ValueError on a ResNet) and builds on it, its
    head packed for the kernel; wperlay_cnn builds on the CLIP tower."""
    import dataclasses

    for head, err, match in (("emb_lin", ValueError, "use PairScorer"),
                             ("stages_cnn_pooling", ValueError, "PairScorer")):
        with pytest.raises(err, match=match):
            GroupedPairScorer(dataclasses.replace(CFG, head=head), port_model,
                              k=2, device="cpu")
    with pytest.raises(ValueError, match="ViT tower"):
        make_global_model(dataclasses.replace(CFG, head="stages_vit"))
    vit = dataclasses.replace(
        CFG, head="single_lin_vit", depth=1,
        backbone=BackboneConfig(kind="vit_clip", image_size=64,
                                compute_dtype="float32", vit_width=96,
                                vit_depth=4, vit_heads=4))
    scorer = GroupedPairScorer(vit, make_global_model(vit), k=2, device="cpu")
    assert scorer.pairs.head.channels == (96, 96)
    w = scorer.pairs.head.w.reshape(2, 96)
    assert torch.equal(w[0], w[1])
    clip = dataclasses.replace(
        CFG, head="wperlay_cnn", depth=11,
        backbone=dataclasses.replace(CFG.backbone, kind="resnet50_clip"))
    scorer = GroupedPairScorer(clip, make_global_model(clip), k=2,
                               device="cpu")
    assert len(scorer.pairs.model.tap_names) == 12
    assert scorer.pairs.head.channels == (256,) * 3 + (512,) * 3 + (
        1024,) * 3 + (2048,) * 3


def _folders(root: Path):
    """GT + two SR folders of three images; one SR file is corrupt, one GT
    stem has no SR match."""
    rng = np.random.default_rng(9)
    dirs = [root / n for n in ("HQ", "esrgan", "swinir")]
    for d in dirs:
        d.mkdir()
    for i in range(3):
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        Image.fromarray(img).save(dirs[0] / f"im{i}.png")
        for d in dirs[1:]:
            noisy = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
            Image.fromarray(noisy.astype(np.uint8)).save(d / f"im{i}.jpg")
    Image.fromarray(img).save(dirs[0] / "lonely.png")
    (dirs[2] / "im1.jpg").write_bytes(b"not a JPEG")
    return dirs


def test_folder_set_nan_row_for_corrupt_file(tmp_path, port_model):
    gt, *srs = _folders(tmp_path)
    scorer = GroupedPairScorer(CFG, port_model, k=2, batch_size=2,
                               num_workers=2, device="cpu")
    rows = scorer.score_folder_set(str(gt), [str(d) for d in srs])
    assert [r["image_name"] for r in rows] == ["im0", "im1", "im2"]
    assert list(rows[0]) == ["image_name", "esrgan", "swinir"]
    assert np.isnan([rows[1]["esrgan"], rows[1]["swinir"]]).all()
    ok = [r[n] for r in (rows[0], rows[2]) for n in ("esrgan", "swinir")]
    assert np.isfinite(ok).all() and min(ok) > 0
    with pytest.raises(ValueError, match="expected 2 SR folders"):
        scorer.score_folder_set(str(gt), [str(srs[0])])


def test_cli_score_groups_writes_csv(tmp_path):
    gt, esrgan, swinir = _folders(tmp_path)
    out = tmp_path / "groups.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "score-groups", str(gt),
         str(esrgan), str(swinir), "--device", "cpu", "--batch-size", "2",
         "--image-size", "64", "--dtype", "float32", "--depth", "2",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert ('"groups": 3' in proc.stdout and '"nan_groups": 1' in proc.stdout
            and '"device": "cpu"' in proc.stdout)
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["image_name"] for r in rows] == ["im0", "im1", "im2"]
    assert list(rows[0]) == ["image_name", "esrgan", "swinir"]
    assert rows[1]["esrgan"] == "nan" and rows[1]["swinir"] == "nan"
    assert float(rows[0]["swinir"]) >= 0.0
    refused = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "score-groups", str(gt),
         str(esrgan), "--device", "cpu", "--checkpoint",
         str(tmp_path / "ckpt")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0
    assert "FileNotFoundError: no checkpoint under" in refused.stderr
