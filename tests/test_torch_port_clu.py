"""Port CLU map model (srsem_torch/models/local_models.py), its scorers
(srsem_torch/eval/scorer.py, grouped.py) and ``score-maps-groups`` vs the
JAX package, same weights.

Weights come from a seeded port model with random BN statistics.  They go
to JAX variables through srsem/utils/convert.py (convert_clip_resnet50,
convert_clu_decoder — they read the port's own state dict) and come back
into a fresh port model through ``load_jax_local_params``.

* The model: ``width_mult=0.125``, 64 px, f32, v2 off and on; the module's
  ``decode_from_diffs`` and ``fused_serving_decode`` (default, and every
  level fused and tiled) vs JAX ``decode_from_diffs`` at 2e-4, the JAX
  package's own fused-decoder tolerance (tests/test_fused_decoder.py:83-85).
* The scorers take no width multiplier, so they run at full width at
  32 px, batch 2 (as __graft_entry__.py:246-253 does), against JAX's dense
  path at 2e-3 (tests/test_fused_decoder.py:111).
"""

import copy
import csv
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.eval.scorer import PairScorer as JaxPairScorer
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.models.local_models import folded_decoder_weights as jax_folded
from srsem.utils.convert import convert_clip_resnet50, convert_clu_decoder
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.config import BackboneConfig, LocalModelConfig
from srsem_torch.eval.grouped import GroupedMapScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.local_models import (
    DEFAULT_FUSE_LEVELS,
    CluUnet,
    folded_decoder_weights,
    fused_serving_decode,
    make_local_model,
)
from srsem_torch.ops import fused_decoder as tfd
from srsem_torch.utils.convert import load_jax_local_params

REPO = Path(__file__).resolve().parents[1]


def seeded_clu(cfg, seed, width_mult=1.0):
    """A port CluUnet with seeded weights and random BN statistics (small
    gammas closing each residual branch keep the tower's activations O(1);
    a map head scaled by 0.1 keeps most of the sigmoid off its flat top,
    and a +0.5 bias keeps its ReLU open)."""
    model = make_local_model(cfg, width_mult=width_mult,
                             generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (FrozenBatchNorm, torch.nn.BatchNorm2d)):
                c = m.weight.shape[0]
                closing = name.endswith(("bn3", "downsample.1")) and "layer" in name
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if closing
                                   else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))
        model.decoder[0][3].weight.mul_(0.1)
        model.decoder[0][3].bias.add_(0.5)
    return model


def jax_variables(model):
    """JAX CluUnet variables (numpy) from the port model's state dict."""
    sd = model.state_dict()
    dec = convert_clu_decoder({k: v for k, v in sd.items()
                               if k.startswith("decoder.")})
    tower = convert_clip_resnet50({k[len("backbone."):]: v for k, v in sd.items()
                                   if k.startswith("backbone.")})
    return {"params": {"backbone": tower, **dec["params"]},
            "batch_stats": dec["batch_stats"]}


def _diffs(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 0.5, (n, size >> (i + 1), size >> (i + 1), c))
            .astype(np.float32) ** 2
            for i, c in enumerate((64, 256, 512, 1024, 2048))]


SMALL = LocalModelConfig(backbone=BackboneConfig(
    kind="resnet50_clip", image_size=64, compute_dtype="float32"))


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "v2"])
def small(request):
    v2 = request.param
    cfg = LocalModelConfig(backbone=SMALL.backbone, v2=v2)
    variables = jax_variables(seeded_clu(cfg, 3, width_mult=0.125))
    port = CluUnet(v2=v2, compute_dtype=torch.float32, image_size=64,
                   width_mult=0.125).eval().requires_grad_(False)
    load_jax_local_params(port, variables)
    jax_model = JaxCluUnet(backbone_kind="resnet50_clip", v2=v2,
                           compute_dtype=jnp.float32, image_size=64,
                           decoder_dtype=jnp.float32, width_mult=0.125)
    diffs = _diffs(4, 2, 64)
    img_sq = (np.random.default_rng(5).uniform(0, 0.1, (2, 64, 64, 1))
              .astype(np.float32) if v2 else None)
    want = np.asarray(jax_model.apply(
        variables, [jnp.asarray(d) for d in diffs],
        None if img_sq is None else jnp.asarray(img_sq), False,
        method=JaxCluUnet.decode_from_diffs))
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    return port, variables, [t(d) for d in diffs], t(img_sq), want


def test_decode_from_diffs_matches_jax(small):
    port, _, diffs, img_sq, want = small
    got = port.decode_from_diffs(diffs, img_sq)
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    assert want.std() > 1e-3  # the map is not constant
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fuse,tiled", [
    (DEFAULT_FUSE_LEVELS, None),
    ((0, 1, 2, 3, 4), {0: 8, 1: 3, 2: 3, 3: 3, 4: 1})])
def test_fused_serving_decode_matches_jax(small, fuse, tiled):
    """Default routing (levels 0-2 fused, 0-1 tiled) and every level fused
    and tiled (ragged tiles, and u=None at level 4) == JAX's module."""
    port, _, diffs, img_sq, want = small
    counts = (tfd.fused_decoder_level.launches,
              tfd.fused_decoder_level_tiled.launches)
    got = fused_serving_decode(port, diffs, img_sq, fuse_levels=fuse,
                               tiled_rows=tiled)
    assert counts == (tfd.fused_decoder_level.launches,
                      tfd.fused_decoder_level_tiled.launches)  # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_folded_decoder_weights_match_jax(small):
    port, variables, diffs, _, _ = small
    for lvl in range(5):
        cd = diffs[lvl].shape[-1] + (1 if port.v2 else 0)
        got = folded_decoder_weights(port, lvl, cd)
        want = jax_folded(variables, lvl, cd)
        assert got[-1] == want[-1]  # final_kernel
        for g, w in zip(got[:-1], want[:-1]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)


def test_state_dict_round_trip(small):
    """Port state dict → convert_clu_decoder → load_jax_local_params gives
    back the same weights exactly."""
    port, variables, _, _, _ = small
    again = jax_variables(port)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    for (pa, a), (pb, b) in zip(flat(again), flat(variables)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


FULL = LocalModelConfig(backbone=BackboneConfig(
    kind="resnet50_clip", image_size=32, compute_dtype="float32"))


@pytest.fixture(scope="module")
def full_model():
    return seeded_clu(FULL, 6)


def test_pair_scorer_matches_jax(full_model):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    jcfg = JaxLocalConfig(backbone=JaxBackboneConfig(
        kind="resnet50_clip", image_size=32, compute_dtype="float32"))
    jax_scorer = JaxPairScorer(jcfg, jax_variables(full_model), batch_size=2,
                               model_kind="local")
    want = np.asarray(jax.device_get(jax_scorer.score_arrays(a, b)))
    assert want.shape == (2, 32, 32)
    # The map spreads far beyond the 2e-3 tolerance, and most of it lies
    # off the sigmoid's flat ends, so a wrong decode cannot pass.
    inner = (want > 0.51) & (want < 0.99)
    assert want.std() > 2e-2 and inner.mean() > 0.25, (want.std(),
                                                        inner.mean())
    for fused in (True, False):
        got = PairScorer(FULL, full_model, batch_size=2, model_kind="local",
                         fused_tower=fused, fused_decoder=fused,
                         device="cpu").score_arrays(a, b)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_grouped_scorer_matches_pairwise(full_model):
    rng = np.random.default_rng(8)
    gt = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    sr = rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    grouped = GroupedMapScorer(FULL, full_model, k=2, batch_size=2,
                               device="cpu").score_arrays(gt, sr)
    pairs = PairScorer(FULL, full_model, batch_size=4, model_kind="local",
                       device="cpu")
    want = pairs.score_arrays(np.repeat(gt, 2, axis=0), sr.reshape(4, 32, 32, 3))
    assert grouped.shape == (2, 2, 32, 32)
    torch.testing.assert_close(grouped.reshape(4, 32, 32), want,
                               rtol=1e-5, atol=1e-5)


def _folders(root: Path):
    rng = np.random.default_rng(9)
    dirs = [root / n for n in ("gt", "esrgan", "swinir")]
    for d in dirs:
        d.mkdir()
    for i in range(3):
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        Image.fromarray(img).save(dirs[0] / f"im{i}.png")
        for d in dirs[1:]:
            noisy = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
            Image.fromarray(noisy.astype(np.uint8)).save(d / f"im{i}.jpg")
    (dirs[2] / "im1.jpg").write_bytes(b"not a JPEG")
    return dirs


def test_score_paths_nan_map_for_corrupt_file(tmp_path, full_model):
    gt, sr, _ = _folders(tmp_path)
    pairs = [(str(gt / f"im{i}.png"), str(sr / f"im{i}.jpg")) for i in range(3)]
    pairs[1] = (pairs[1][0], str(tmp_path / "swinir" / "im1.jpg"))
    maps = PairScorer(FULL, full_model, batch_size=2, model_kind="local",
                      num_workers=2, device="cpu").score_paths(pairs)
    assert maps.shape == (3, 32, 32) and maps.dtype == np.float32
    assert np.isnan(maps[1]).all()
    ok = np.delete(maps, 1, axis=0)
    assert np.isfinite(ok).all() and (ok >= 0.5).all() and (ok <= 1).all()


def test_cli_score_maps_groups_writes_csv(tmp_path):
    gt, esrgan, swinir = _folders(tmp_path)
    out = tmp_path / "maps.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "score-maps-groups", str(gt),
         str(esrgan), str(swinir), "--device", "cpu", "--batch-size", "2",
         "--image-size", "32", "--dtype", "float32", "--out", str(out),
         "--maps-dir", str(tmp_path / "maps")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"nan_groups": 1' in proc.stdout and '"device": "cpu"' in proc.stdout
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["image_name"] for r in rows] == ["im0", "im1", "im2"]
    assert list(rows[0]) == ["image_name", "esrgan_map_mean", "esrgan_map_min",
                             "swinir_map_mean", "swinir_map_min"]
    assert rows[1]["esrgan_map_mean"] == "nan"
    assert 0.5 <= float(rows[0]["swinir_map_min"]) <= 1.0
    assert len(list((tmp_path / "maps").glob("*.npy"))) == 4


def test_module_options_agree(small):
    """``split_tower`` (two tower passes) equals the one 2N pass; the
    fused decode honours ``sigmoid=False`` (the unet_global copy) and a
    bf16 ``output_dtype`` as the module does; ``train=True`` runs the
    decoder's BatchNorms on batch statistics (training, ROADMAP A6)."""
    port, _, diffs, img_sq, _ = small
    rng = np.random.default_rng(10)
    a, b = (torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
            for _ in range(2))
    one = port(a, b)
    port.split_tower = True
    try:
        torch.testing.assert_close(port(a, b), one, rtol=1e-5, atol=1e-5)
    finally:
        port.split_tower = False
    for sigmoid, out_dtype in ((False, torch.float32), (True, torch.bfloat16)):
        port.sigmoid, port.output_dtype = sigmoid, out_dtype
        try:
            want = port.decode_from_diffs(diffs, img_sq)
            got = fused_serving_decode(port, diffs, img_sq)
        finally:
            port.sigmoid, port.output_dtype = True, torch.float32
        assert got.dtype == want.dtype == out_dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-4,
                                   atol=2e-4 if sigmoid is False else 1e-2)
    # train=True reaches the decoder: batch statistics in the map, and
    # the running statistics move (on copies: the fixture is shared).
    trained, twin = copy.deepcopy(port), copy.deepcopy(port)
    got = trained(a, b, train=True)
    _, taps = twin.backbone(torch.cat([a, b]))
    want = twin.decode_from_taps({k: v[:2] for k, v in taps.items()},
                                 {k: v[2:] for k, v in taps.items()}, a, b,
                                 train=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, one, rtol=1e-3, atol=1e-3)
    bn = trained.decoder[1][1]
    assert not torch.equal(bn.running_mean, port.decoder[1][1].running_mean)
    with pytest.raises(NotImplementedError, match="A7"):
        CluUnet(lora_rank=4)
