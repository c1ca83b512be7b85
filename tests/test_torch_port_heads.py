"""The port's CNN global heads (srsem_torch/models/global_models.py) —
wperlay_cnn, stages_cnn_pooling, emb_lin and unet_global — and their
scorers vs the JAX package, same weights.

Weights come from seeded port models with random frozen-BN statistics.
They go to JAX variables through srsem/utils/convert.py
(convert_{clip,torch}_resnet50 for the tower, convert_global_head for the
heads, convert_clu_decoder for unet_global's decoder: all read the port's
own state dict) and come back into fresh port models through
``load_jax_global_params`` / ``load_jax_local_params``.

The JAX side runs its tower once per backbone (jitted, dense XLA) and
each head through ``GlobalPairScorer.score_from_taps`` (CluUnet's
``decode_from_taps`` for unet_global) on those taps.  f32, 64 px, batch 2.
Tolerances: 1e-4 for the module, 1e-3 for ``PairScorer`` on the plain
kernel path (the JAX package's own over the 16-block fused tower,
tests/test_fused_bottleneck.py), 2e-4 for the unet_global map
(tests/test_fused_decoder.py:83-85), 1e-4 for the grouped wperlay head.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.resnet import make_backbone as jax_make_backbone
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.meshes import create_mesh
from srsem.data.preprocess import Preprocess as JaxPreprocess
from srsem.eval.grouped import GroupedPairScorer as JaxGroupedPairScorer
from srsem.models.global_models import GlobalPairScorer as JaxGlobalPairScorer
from srsem.models.global_models import make_global_model as jax_make_global_model
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.utils.convert import (
    convert_clip_resnet50,
    convert_clu_decoder,
    convert_global_head,
    convert_torch_resnet50,
)
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.eval.grouped import GroupedPairScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import (
    GlobalPairScorer,
    MlpHead,
    make_global_model,
    wperlay_taps,
)
from srsem_torch.models.local_models import CluUnet
from srsem_torch.utils.convert import load_jax_global_params, load_jax_local_params

SIZE = 64


def _cfg(kind, head, depth=3):
    return GlobalModelConfig(backbone=BackboneConfig(
        kind=kind, image_size=SIZE, compute_dtype="float32"),
        head=head, depth=depth)


def _jax_cfg(cfg):
    return JaxGlobalConfig(backbone=JaxBackboneConfig(
        **dataclasses.asdict(cfg.backbone)), head=cfg.head, depth=cfg.depth)


def _randomize_bn(model, seed):
    """Random BN statistics (small gammas close each residual branch, so
    the tower's activations stay O(1))."""
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


@functools.lru_cache(maxsize=None)
def _tower(kind):
    """One seeded tower a backbone kind: its port state dict, its JAX
    params, a uint8 pair batch (the second pair four times closer) and the
    JAX tower's embeddings and taps of both images (one jitted pass on the
    2N batch)."""
    model = make_global_model(_cfg(kind, "emb_lin"),
                              torch.Generator().manual_seed(1))
    _randomize_bn(model.backbone, 1)
    sd = model.backbone.state_dict()
    bp = (convert_clip_resnet50(sd) if kind == "resnet50_clip"
          else convert_torch_resnet50(sd))
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    noise = rng.integers(-40, 41, a.shape) // np.array([1, 4])[:, None, None, None]
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
    pre = JaxPreprocess.for_backbone(kind, SIZE)
    x = jnp.concatenate([pre.device_normalize(jnp.asarray(a)),
                         pre.device_normalize(jnp.asarray(b))])
    backbone = jax_make_backbone(_jax_cfg(_cfg(kind, "emb_lin")).backbone)
    emb, taps = jax.jit(backbone.apply)({"params": bp}, x)
    emb, taps = np.asarray(emb), {k: np.asarray(v) for k, v in taps.items()}
    return {"sd": sd, "bp": bp, "a": a, "b": b, "x": np.asarray(x),
            "emb": (emb[:2], emb[2:]),
            "taps": ({k: v[:2] for k, v in taps.items()},
                     {k: v[2:] for k, v in taps.items()})}


def _live_head(model, taps):
    """Heads whose scores the final ReLU passes, the pair terms carrying
    each score: conv heads with nonnegative weights scaled so each stage's
    weighted squared diff is about 1 on ``taps`` (an (A, B) pair of tap
    dicts) and biases +1; MLP heads with a nonnegative last layer (its
    inputs are ReLU outputs) and its bias +0.5."""
    with torch.no_grad():
        if isinstance(model.aggregator, MlpHead):
            model.aggregator.fin_lin[-2].weight.abs_()
            model.aggregator.fin_lin[-2].bias.add_(0.5)
            return
        for name, layer in zip(model.tap_names, model.aggregator.w_layers):
            d = ((taps[0][name] - taps[1][name]) ** 2).mean(axis=(0, 1, 2))
            w = layer.weight.abs_().reshape(-1)
            layer.weight.div_(float(torch.tensor(d) @ w))
            layer.bias.add_(1.0)


def _port_and_variables(cfg, seed):
    """A seeded port model on the shared tower, its JAX variables, and a
    fresh port model loaded back from them."""
    t = _tower(cfg.backbone.kind)
    port = make_global_model(cfg, torch.Generator().manual_seed(seed))
    port.backbone.load_state_dict(t["sd"])
    _live_head(port, t["taps"])
    variables = {"params": {
        "backbone": t["bp"],
        **convert_global_head(port.aggregator.state_dict())}}
    fresh = load_jax_global_params(GlobalPairScorer(cfg), variables).eval()
    return port, fresh, variables


CASES = [("resnet50_clip", "wperlay_cnn", 1), ("resnet50_clip", "wperlay_cnn", 3),
         ("resnet50_clip", "wperlay_cnn", 11),
         ("resnet50_clip", "stages_cnn_pooling", 3),
         ("resnet50", "stages_cnn_pooling", 2),
         ("resnet50_clip", "emb_lin", 3), ("resnet50", "emb_lin", 3)]


@pytest.mark.parametrize("kind,head,depth", CASES,
                         ids=[f"{h}-{k}-d{d}" for k, h, d in CASES])
def test_head_matches_jax(kind, head, depth):
    """The port module and PairScorer (fused tower and head kernel on
    their plain versions) == JAX score_from_taps on JAX's tower; the
    port's state dict round-trips through convert_global_head."""
    cfg = _cfg(kind, head, depth)
    port, fresh, variables = _port_and_variables(cfg, seed=depth + 3)
    for key, v in port.aggregator.state_dict().items():
        torch.testing.assert_close(fresh.aggregator.state_dict()[key], v,
                                   rtol=0, atol=0)
    t = _tower(kind)
    jm = JaxGlobalPairScorer(_jax_cfg(cfg))
    want = np.asarray(jm.apply(variables, *t["emb"], *t["taps"],
                               method=JaxGlobalPairScorer.score_from_taps))
    assert want.shape == (2,) and (want > 0).all()
    assert abs(want[0] - want[1]) > 1e-2  # the pairs, not the biases

    pre = Preprocess.for_backbone(kind, SIZE)
    with torch.no_grad():
        module = fresh(pre.device_normalize(torch.tensor(t["a"])),
                       pre.device_normalize(torch.tensor(t["b"])))
    np.testing.assert_allclose(module.numpy(), want, rtol=1e-4, atol=1e-4)
    scorer = PairScorer(cfg, fresh, batch_size=2, device="cpu")
    assert (scorer.head is None) == (head != "wperlay_cnn")
    got = scorer.score_arrays(t["a"], t["b"])
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_unet_global_matches_jax():
    """head="unet_global": the CluUnet copy without the sigmoid, a raw map,
    module and PairScorer (decoder kernel on its plain version, and the
    module's decoder) == JAX decode_from_taps at 2e-4."""
    cfg = _cfg("resnet50_clip", "unet_global")
    t = _tower("resnet50_clip")
    port = make_global_model(cfg, torch.Generator().manual_seed(5))
    assert isinstance(port, CluUnet) and port.sigmoid is False
    port.backbone.load_state_dict(t["sd"])
    _randomize_bn(port.decoder, 5)
    sd = port.state_dict()
    dec = convert_clu_decoder({k: v for k, v in sd.items()
                               if k.startswith("decoder.")})
    variables = {"params": {"backbone": t["bp"], **dec["params"]},
                 "batch_stats": dec["batch_stats"]}
    fresh = load_jax_local_params(make_global_model(cfg), variables)
    for key, v in sd.items():
        torch.testing.assert_close(fresh.state_dict()[key], v, rtol=0, atol=0)

    jm = jax_make_global_model(_jax_cfg(cfg))
    assert isinstance(jm, JaxCluUnet) and jm.sigmoid is False
    x = jnp.asarray(t["x"])
    want = np.asarray(jm.apply(variables, *t["taps"], x[:2], x[2:], False,
                               method=JaxCluUnet.decode_from_taps))
    assert want.shape == (2, SIZE, SIZE) and want.std() > 1e-2
    assert want.min() >= 0 and want.max() > 1.0  # ReLU'd, no sigmoid

    pre = Preprocess.for_backbone("resnet50_clip", SIZE)
    with torch.no_grad():
        module = fresh(pre.device_normalize(torch.tensor(t["a"])),
                       pre.device_normalize(torch.tensor(t["b"])))
    np.testing.assert_allclose(module.numpy(), want, rtol=2e-4, atol=2e-4)
    for fused in (None, False):
        scorer = PairScorer(cfg, fresh, batch_size=2, fused_decoder=fused,
                            device="cpu")
        assert scorer.fused_decoder is (fused is None)
        got = scorer.score_arrays(t["a"], t["b"])
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_grouped_wperlay_matches_jax():
    """GroupedPairScorer(wperlay_cnn, depth 11: the head kernel's 12
    stages) == JAX GroupedPairScorer (dense XLA tower, XLA-fused grouped
    head), G = 2, K = 2; and == the port's PairScorer on the repeated
    pairs."""
    depth = 11
    cfg = _cfg("resnet50_clip", "wperlay_cnn", depth)
    _, fresh, variables = _port_and_variables(cfg, seed=depth + 20)
    rng = np.random.default_rng(depth)
    gt = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    sr = np.clip(gt[:, None].astype(int)
                 + rng.integers(-40, 41, (2, 2, SIZE, SIZE, 3)), 0,
                 255).astype(np.uint8)
    jax_scorer = JaxGroupedPairScorer(_jax_cfg(cfg), variables, k=2,
                                      batch_size=2, mesh=create_mesh(data=1))
    want = np.asarray(jax.device_get(jax_scorer.score_arrays(gt, sr)))
    assert want.shape == (2, 2) and (want > 1.5).all()
    got = GroupedPairScorer(cfg, fresh, k=2, batch_size=2,
                            device="cpu").score_arrays(gt, sr)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    pairs = PairScorer(cfg, fresh, batch_size=4, device="cpu").score_arrays(
        np.repeat(gt, 2, axis=0), sr.reshape(4, SIZE, SIZE, 3))
    torch.testing.assert_close(got.reshape(-1), pairs, rtol=1e-5, atol=1e-5)


WIDTH_CASES = [(k, h, d) for k in ("resnet50_clip", "resnet50")
               for h, d in (("stages_cnn_pooling", 1), ("stages_cnn_pooling", 3),
                            ("emb_lin", 3))] + [("resnet50_clip", "wperlay_cnn", 11)]


@pytest.mark.parametrize("kind,head,depth", WIDTH_CASES,
                         ids=[f"{h}-{k}-d{d}" for k, h, d in WIDTH_CASES])
def test_head_widths_match_jax_init(kind, head, depth):
    """Every head layer's shape equals the JAX init's (jax.eval_shape, no
    compute): the MLPs' input widths come from the config."""
    cfg = _cfg(kind, head, depth)
    z = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(JaxGlobalPairScorer(_jax_cfg(cfg)).init,
                            jax.random.PRNGKey(0), z, z)["params"]["aggregator"]
    want = {k: (v["kernel"].shape, v["bias"].shape) for k, v in shapes.items()}
    port = GlobalPairScorer(cfg)
    jax_layout = convert_global_head(
        {k: v for k, v in port.aggregator.state_dict().items()})["aggregator"]
    got = {k: (v["kernel"].shape, v["bias"].shape) for k, v in jax_layout.items()}
    assert got == want
    if head != "wperlay_cnn":
        width = {"stages_cnn_pooling": 2 * sum((256, 512, 1024, 2048)[3 - depth:]),
                 "emb_lin": 2 * {"resnet50_clip": 1024, "resnet50": 2048}[kind]}
        assert port.aggregator.fin_lin[0].in_features == width[head]


def test_mlp_init_is_truncated_kaiming_fan_out():
    """MlpHead's fresh weights: zero biases, fan_out Kaiming std (the JAX
    _mlp_init's variance scaling 2.0, truncated at two deviations), drawn
    from the caller's generator."""
    head = MlpHead(2048, (1028, 512, 1))
    head.reset_parameters(torch.Generator().manual_seed(0))
    again = MlpHead(2048, (1028, 512, 1))
    again.reset_parameters(torch.Generator().manual_seed(0))
    for m, n in zip(head.fin_lin, again.fin_lin):
        if isinstance(m, torch.nn.Linear):
            std = np.sqrt(2.0 / m.out_features) / 0.87962566103423978
            assert torch.equal(m.weight, n.weight) and not m.bias.any()
            w = m.weight.detach()
            assert w.abs().max() <= 2 * std
            if w.numel() > 1000:
                kaiming = np.sqrt(2.0 / m.out_features)
                assert abs(float(w.std()) - kaiming) < 0.05 * kaiming
    assert [type(m).__name__ for m in head.fin_lin] == ["Linear", "ReLU"] * 3


def test_refusals():
    """fused_decoder=True needs a CluUnet (JAX's ValueError); wperlay_cnn
    needs the CLIP tower and depth <= 11; the ViT heads need the ViT
    tower."""
    cfg = _cfg("resnet50", "stages_cnn")
    model = make_global_model(cfg)
    with pytest.raises(ValueError, match="fused_decoder"):
        PairScorer(cfg, model, fused_decoder=True, device="cpu")
    with pytest.raises(ValueError, match="CluUnet"):
        PairScorer(cfg, model, model_kind="local", device="cpu")
    assert PairScorer(cfg, model, fused_decoder=False,
                      device="cpu").fused_decoder is False
    with pytest.raises(ValueError, match="CLIP"):
        GlobalPairScorer(_cfg("resnet50", "wperlay_cnn"))
    with pytest.raises(ValueError, match="depth"):
        GlobalPairScorer(_cfg("resnet50_clip", "wperlay_cnn", 12))
    with pytest.raises(ValueError, match="unknown global head"):
        GlobalPairScorer(_cfg("resnet50", "nope"))
    for head in ("single_lin_vit", "stages_vit", "wperlay_vit"):
        with pytest.raises(ValueError, match="ViT tower"):
            GlobalPairScorer(_cfg("resnet50_clip", head))
    assert wperlay_taps(0) == ("stages.3.2.act",)
    assert len(wperlay_taps(11)) == 12 and wperlay_taps(11)[0] == "stages.0.0.act"
