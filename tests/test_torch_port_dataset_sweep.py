"""Port DualScorer (srsem_torch/eval/dataset_sweep.py) and ``sweep-dataset``
vs the JAX package's DualScorer (srsem/eval/dataset_sweep.py), same
weights, and vs the port's own PairScorers.

One tower pass an image feeds both the global head and the CLU decoder.
Weights: a seeded port global model (resnet50_clip, stages_cnn, depth 3,
live head) and a seeded CluUnet whose tower is the global model's, carried
to JAX variables through srsem/utils/convert.py.  f32, 64 px.  Against JAX
(dense XLA tower) scores agree within 1e-3 and maps within 2e-3, the
tolerances of tests/test_torch_port_grouped.py:100 and
tests/test_torch_port_clu.py:199; against the port's two PairScorers and
grouped against pairwise within 1e-5 (the same kernels on the same taps).
"""

import csv
import math
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
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.core.meshes import create_mesh
from srsem.eval.dataset_sweep import DualScorer as JaxDualScorer
from srsem.utils.convert import (
    convert_clip_resnet50,
    convert_clu_decoder,
    convert_global_head,
)
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.eval.dataset_sweep import DualScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]
BB = BackboneConfig(kind="resnet50_clip", image_size=64,
                    compute_dtype="float32")
GCFG = GlobalModelConfig(backbone=BB, head="stages_cnn", depth=3)
LCFG = LocalModelConfig(backbone=BB)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small CPU ops: two intra-op threads a process beat the host's count
    when test workers share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_bn(model, seed):
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


@pytest.fixture(scope="module")
def models():
    """(global model, CluUnet on the same tower, JAX variables of both)."""
    gm = make_global_model(GCFG, torch.Generator().manual_seed(3))
    _random_bn(gm.backbone, 3)
    lm = make_local_model(LCFG, generator=torch.Generator().manual_seed(4))
    _random_bn(lm.decoder, 4)
    with torch.no_grad():
        for layer in gm.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
        lm.decoder[0][3].weight.mul_(0.1)
        lm.decoder[0][3].bias.add_(0.5)
    lm.backbone.load_state_dict(gm.backbone.state_dict())
    tower = convert_clip_resnet50(gm.backbone.state_dict())
    gvars = {"params": {"backbone": tower,
                        **convert_global_head(gm.aggregator.state_dict())}}
    dec = convert_clu_decoder({k: v for k, v in lm.state_dict().items()
                               if k.startswith("decoder.")})
    lvars = {"params": {"backbone": tower, **dec["params"]},
             "batch_stats": dec["batch_stats"]}
    return gm, lm, gvars, lvars


def _jax_dual(gvars, lvars, batch_size):
    jbb = JaxBackboneConfig(kind="resnet50_clip", image_size=64,
                            compute_dtype="float32")
    return JaxDualScorer(JaxGlobalConfig(backbone=jbb, head="stages_cnn",
                                         depth=3),
                         JaxLocalConfig(backbone=jbb), gvars, lvars,
                         mesh=create_mesh(data=1), batch_size=batch_size)


def _folders(root: Path):
    """HQ/ and sr_out/ with four stems; SR 3 is corrupt; a GT-only stem."""
    gt, sr = root / "HQ", root / "sr_out"
    gt.mkdir()
    sr.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        arr = rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(gt / f"{i}.jpg", quality=95)
        noisy = np.clip(arr.astype(int) + rng.integers(-30, 31, arr.shape),
                        0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(sr / f"{i}.png")
    (sr / "3.png").write_bytes(b"junk")
    Image.fromarray(arr).save(gt / "lonely.jpg")
    return gt, sr


def _check_rows(rows, want, tol):
    assert [r["image"] for r in rows] == ["0", "1", "2", "3"]
    for r, w in zip(rows, want):
        for key, t in (("score", tol[0]), ("map_mean", tol[1]),
                       ("map_min", tol[1])):
            if r["image"] == "3":
                assert math.isnan(r[key]) and math.isnan(w[key])
            else:
                np.testing.assert_allclose(r[key], w[key], rtol=t, atol=t)


def test_score_folders_matches_jax(models, tmp_path):
    """Two chunks of two pairs (chunk 2 decodes while chunk 1 scores); the
    corrupt SR's row is NaN in every column, the others match JAX."""
    gm, lm, gvars, lvars = models
    gt, sr = _folders(tmp_path)
    want = _jax_dual(gvars, lvars, 2).score_folders(str(gt), str(sr))
    want = want.to_dict("records")
    rows = DualScorer(GCFG, LCFG, gm, lm, batch_size=2, num_workers=2,
                      device="cpu").score_folders(str(gt), str(sr))
    assert min(w["score"] for w in want[:3]) > 1.5  # the head is live
    assert all(0.5 < w["map_mean"] < 1.0 for w in want[:3])
    _check_rows(rows, want, (1e-3, 2e-3))


def test_score_group_arrays_matches_jax_and_pairwise(models):
    gm, lm, gvars, lvars = models
    g, k = 2, 2
    rng = np.random.default_rng(2)
    gt = rng.integers(0, 256, (g, 64, 64, 3), dtype=np.uint8)
    sr = np.clip(gt[:, None].astype(int) + rng.integers(-40, 41, (g, k, 64, 64,
                                                                  3)),
                 0, 255).astype(np.uint8)
    ws, wm = _jax_dual(gvars, lvars, g).score_group_arrays(gt, sr)
    ws, wm = np.asarray(jax.device_get(ws)), np.asarray(jax.device_get(wm))
    dual = DualScorer(GCFG, LCFG, gm, lm, batch_size=g, device="cpu")
    scores, maps = dual.score_group_arrays(gt, sr)
    assert scores.shape == (g, k) and maps.shape == (g, k, 64, 64)
    np.testing.assert_allclose(scores.numpy(), ws, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(maps.numpy(), wm, rtol=2e-3, atol=2e-3)
    ps, pm = dual.score_both(np.repeat(gt, k, axis=0),
                             sr.reshape(g * k, 64, 64, 3))
    torch.testing.assert_close(scores.reshape(-1), ps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(maps.reshape(g * k, 64, 64), pm, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_dual_matches_two_pair_scorers(models, fused):
    """One tower pass feeding both heads == the global and the local
    PairScorer run one after the other, on the kernel path and on the
    plain module path."""
    gm, lm, _, _ = models
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 41, a.shape), 0,
                255).astype(np.uint8)
    dual = DualScorer(GCFG, LCFG, gm, lm, batch_size=3, fused_tower=fused,
                      fused_decoder=fused, device="cpu")
    scores, maps = dual.score_both(a, b)
    want_s = PairScorer(GCFG, gm, batch_size=3, fused_tower=fused,
                        device="cpu").score_arrays(a, b)
    want_m = PairScorer(LCFG, lm, batch_size=3, model_kind="local",
                        fused_tower=fused, fused_decoder=fused,
                        device="cpu").score_arrays(a, b)
    torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(maps, want_m, rtol=1e-5, atol=1e-5)


def test_rejects_mismatched_backbones_and_heads(models):
    gm, lm, _, _ = models
    for kind, size in (("resnet50", 64), ("resnet50_clip", 32)):
        lcfg = LocalModelConfig(backbone=BackboneConfig(
            kind=kind, image_size=size, compute_dtype="float32"))
        with pytest.raises(ValueError, match="backbones must match"):
            DualScorer(GCFG, lcfg, gm, lm, device="cpu")
    pooled = GlobalModelConfig(backbone=BB, head="stages_cnn_pooling")
    with pytest.raises(ValueError, match="conv heads"):
        DualScorer(pooled, LCFG, gm, lm, device="cpu")
    if not torch.cuda.is_available():  # cuda by default: no CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DualScorer(GCFG, LCFG, gm, lm)


def test_native_decode_backend(models, tmp_path):
    """decode_backend='native' decodes through the C++ library: the
    corrupt SR still gives the NaN row, and the rest match the PIL run
    within the decoders' resampling difference."""
    from srsem_torch import native

    if not native.available():
        pytest.skip(f"native decoder unavailable: {native.build_error()}")
    gm, lm, _, _ = models
    gt, sr = _folders(tmp_path)
    pil = DualScorer(GCFG, LCFG, gm, lm, batch_size=4,
                     device="cpu").score_folders(str(gt), str(sr))
    nat = DualScorer(GCFG, LCFG, gm, lm, batch_size=4, decode_backend="native",
                     device="cpu").score_folders(str(gt), str(sr))
    assert [math.isnan(r["score"]) for r in nat] == [False] * 3 + [True]
    _check_rows(nat, pil, (0.05, 0.05))


def test_cli_sweep_dataset(tmp_path):
    gt, sr = _folders(tmp_path)
    template = str(tmp_path / "scores_{folder}.csv")
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "sweep-dataset", str(gt),
         str(sr), "--device", "cpu", "--batch-size", "4", "--out-template",
         template],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"nan": 1' in proc.stdout and '"device": "cpu"' in proc.stdout
    with open(tmp_path / "scores_sr_out.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["image", "score", "map_mean", "map_min"]
    assert [r["image"] for r in rows] == ["0", "1", "2", "3"]
    assert rows[3]["score"] == "nan" and rows[3]["map_min"] == "nan"
    assert all(0.0 <= float(r["map_min"]) <= 1.0 for r in rows[:3])
