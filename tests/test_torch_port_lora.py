"""LoRA in the port (srsem_torch/ops/lora.py, the towers of
srsem_torch/backbones/resnet.py, CluUnet's ``lora_rank``) against the JAX
package's (srsem/ops/lora.py, srsem/backbones/resnet.py), the checkpoint
layout of tower training both ways, and the fused tower's refusal of a
tower it cannot serve.

The JAX towers are initialised with a seeded ``PRNGKey``; their
FrozenBatchNorms get random statistics and their ``lora_a`` factors
random values (zero at init, which would hide the delta), and the
variables go into the port through ``load_backbone_params``.  float32 at
64 px; tower outputs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.resnet import ClipResNet50 as JaxClip
from srsem.backbones.resnet import ImageNetResNet50 as JaxImageNet
from srsem.backbones.resnet import LoraConv as JaxLoraConv
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.eval.scorer import PairScorer as JaxPairScorer
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.ops.lora import is_lora_path as jax_is_lora_path
from srsem.train.checkpoint import restore_checkpoint as jax_restore
from srsem.train.checkpoint import save_checkpoint as jax_save
from srsem.train.partition import partition_params as jax_partition
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem_torch.backbones.resnet import (
    ClipResNet50,
    ImageNetResNet50,
    LoraConv2d,
    conv_nchw,
    to_nchw,
    to_nhwc,
)
from srsem_torch.config import BackboneConfig, LocalModelConfig
from srsem_torch.eval.grouped import GroupedMapScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.local_models import make_local_model
from srsem_torch.ops.lora import is_lora_path
from srsem_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from srsem_torch.train.loop import build_training
from srsem_torch.train.partition import flatten_dict, trainable_predicate
from srsem_torch.utils.convert import (
    jax_adam_state,
    jax_trainable_params,
    load_backbone_params,
    load_jax_local_params,
)
from test_torch_port_train import _random_bn, _two_threads  # noqa: F401

SIZE, RANK = 64, 4
FROZEN_ONLY = "fused_tower serves the frozen base tower only"


def _live_lora(tree, rng):
    """Random ``lora_a`` factors (a zero init makes the delta vanish)."""
    flat = flatten_dict(tree)
    for path, v in flat.items():
        if path[-1] == "lora_a":
            flat[path] = (rng.standard_normal(v.shape) * 0.05).astype(
                np.float32)
    out = {}
    for path, v in flat.items():
        cursor = out
        for k in path[:-1]:
            cursor = cursor.setdefault(k, {})
        cursor[path[-1]] = np.asarray(v)
    return out


@pytest.mark.parametrize("k,cin,cout,rank", [(3, 5, 7, 3), (1, 16, 8, 4),
                                             (7, 3, 6, 2)])
def test_lora_conv_matches_jax(k, cin, cout, rank):
    """The delta reshaped in HWIO order then permuted: a 3x3 conv with
    cin != cout shows any other layout."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    pad = ((k // 2, k // 2),) * 2
    jconv = JaxLoraConv(cout, (k, k), (1, 1), pad, lora_rank=rank,
                        dtype=jnp.float32)
    params = jax.device_get(jconv.init(jax.random.PRNGKey(k), x))["params"]
    params = dict(params, lora_a=(rng.standard_normal(params["lora_a"].shape)
                                  * 0.3).astype(np.float32))
    want = np.asarray(jconv.apply({"params": params}, x))
    conv = LoraConv2d(cin, cout, k, 1, rank)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]))
                          .permute(3, 2, 0, 1))
        conv.lora_a.copy_(torch.from_numpy(params["lora_a"]))
        conv.lora_b.copy_(torch.from_numpy(np.asarray(params["lora_b"])))
    got = to_nhwc(conv_nchw(to_nchw(torch.from_numpy(x)), conv))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert conv.lora_a.shape == params["lora_a"].shape
    assert conv.lora_b.shape == params["lora_b"].shape


def test_is_lora_path_matches_jax():
    for path in [("backbone", "stem.conv1", "lora_a"),
                 ("backbone", "stages.0.0", "conv2", "lora_b"),
                 ("backbone", "stem.conv1", "kernel"), ("decoder.0", "bn1")]:
        assert is_lora_path(path) == jax_is_lora_path(path)


@pytest.mark.parametrize("kind", ["resnet50_clip", "resnet50"])
def test_lora_tower_matches_jax(kind):
    """A LoRA tower (every conv, the downsample convs and the stems
    included; no attention-pool projection): the converted factors'
    forward at 64 px, float32, within 1e-4, and the same parameter
    paths."""
    rng = np.random.default_rng(0)
    if kind == "resnet50_clip":
        jtower = JaxClip(lora_rank=RANK, dtype=jnp.float32, image_size=SIZE)
        tower = ClipResNet50(dtype=torch.float32, image_size=SIZE,
                             lora_rank=RANK)
    else:
        jtower = JaxImageNet(lora_rank=RANK, dtype=jnp.float32)
        tower = ImageNetResNet50(dtype=torch.float32, lora_rank=RANK)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    params = jax.device_get(jtower.init(jax.random.PRNGKey(1), x))["params"]
    params = _live_lora(_random_bn(jax.tree.map(np.asarray, params), rng),
                        rng)
    want_emb, want_taps = jtower.apply({"params": params}, x)
    load_backbone_params(tower, kind, params)
    with torch.no_grad():
        emb, taps = tower(torch.from_numpy(x))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=1e-4,
                               atol=1e-4)
    assert set(taps) == set(want_taps)
    for name, t in taps.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want_taps[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    jax_lora = {p for p in flatten_dict(params) if p[-1].startswith("lora")}
    port_lora = {k for k in tower.state_dict() if "lora" in k}
    assert len(jax_lora) == len(port_lora) == 2 * (53 if kind == "resnet50"
                                                   else 55)
    assert not any(k.startswith("attnpool") for k in port_lora)


def _port_clu(rank):
    return make_local_model(
        LocalModelConfig(backbone=BackboneConfig(
            kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"),
            lora_rank=rank),
        width_mult=0.125, generator=torch.Generator().manual_seed(0))


def _jax_trainable_shapes(rank):
    """JAX's trainable subset of a CluUnet with ``lora_rank`` (shapes only,
    no compile), as train_local partitions it."""
    jmodel = JaxCluUnet(backbone_kind="resnet50_clip", image_size=SIZE,
                        compute_dtype=jnp.float32, lora_rank=rank,
                        width_mult=0.125)
    z = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), z, z))
    pred = jax_predicate(lora=isinstance(rank, int),
                         full_finetune=rank == "full")
    trainable, _ = jax_partition(shapes["params"], pred)
    return {k: tuple(v.shape) for k, v in flatten_dict(trainable).items()}


@pytest.mark.parametrize("rank", [RANK, "full"], ids=["lora", "full"])
def test_tower_checkpoint_round_trips_with_jax(tmp_path, rank):
    """The port's checkpoint of a LoRA or fully fine-tuned CLU after one
    Adam step holds JAX's trainable subset, leaf for leaf in JAX's shapes
    (LoRA factors alone, or every tower leaf with the BN statistics), and
    Adam's moments over it; JAX's restore_checkpoint reads it, and a
    checkpoint JAX writes loads back into the port."""
    model = _port_clu(rank)
    steps, opt = build_training(
        model, True, trainable_predicate(lora=rank != "full",
                                         full_finetune=rank == "full"),
        1e-3, torch.device("cpu"))
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 3))
                             .astype(np.float32)) for _ in range(2))
    steps.train_step(a, b, torch.rand(2, SIZE, SIZE), torch.ones(2))
    params, stats = jax_trainable_params(model)
    shapes = {k: v.shape for k, v in flatten_dict(params).items()}
    assert shapes == _jax_trainable_shapes(rank)
    tower = flatten_dict(params["backbone"])
    if rank == "full":
        assert ("stages.1.0", "downsample_bn", "var") in tower
        assert not np.allclose(tower[("stem.bn1", "mean")], 0.0)
    else:
        assert {k[-1] for k in tower} == {"lora_a", "lora_b"}
    save_checkpoint(str(tmp_path / "port"), 1, {
        "trainable": params, "opt_state": jax_adam_state(model, opt),
        "batch_stats": stats})
    restored = jax_restore(str(tmp_path / "port"))
    assert int(restored["opt_state"]["0"]["count"]) == 1
    for key, want in flatten_dict(params).items():
        np.testing.assert_array_equal(flatten_dict(restored["trainable"])[key],
                                      want)
    assert set(flatten_dict(restored["opt_state"]["0"]["mu"])) == set(shapes)

    # JAX writes, the port reads: another model takes the checkpoint.
    jax_save(str(tmp_path / "jax"), 1, {"trainable": restored["trainable"],
                                        "batch_stats": restored["batch_stats"]})
    back = restore_checkpoint(str(tmp_path / "jax"))
    other = _port_clu(rank)
    load_jax_local_params(other, {"params": back["trainable"],
                                  "batch_stats": back["batch_stats"]},
                          partial=True)
    own = other.state_dict()
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(own[k], v, rtol=0, atol=0, msg=k)


def test_fused_tower_refuses_lora_as_jax():
    """An explicit fused tower for a LoRA or fully fine-tuned CLU raises
    JAX's ValueError in every scorer and in the train loop; the default
    (None) runs the module tower for them and the fused tower for a
    frozen base tower."""
    for rank in (RANK, "full"):
        jcfg = JaxLocalConfig(backbone=JaxBackboneConfig(
            kind="resnet50_clip", image_size=SIZE), lora_rank=rank)
        with pytest.raises(ValueError, match=FROZEN_ONLY):
            JaxPairScorer(jcfg, {}, model_kind="local", fused_tower=True)
    model = _port_clu(RANK)
    cfg = LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"),
        lora_rank=RANK)
    for make in (lambda ft: PairScorer(cfg, model, model_kind="local",
                                       fused_tower=ft, device="cpu"),
                 lambda ft: GroupedMapScorer(cfg, model, k=2,
                                             fused_tower=ft, device="cpu")):
        with pytest.raises(ValueError, match=FROZEN_ONLY):
            make(True)
    assert not PairScorer(cfg, model, model_kind="local",
                          device="cpu").fused_tower
    base = LocalModelConfig(backbone=cfg.backbone)
    assert PairScorer(base, _port_clu(None), model_kind="local",
                      device="cpu").fused_tower
    for pred in (trainable_predicate(lora=True),
                 trainable_predicate(full_finetune=True)):
        with pytest.raises(ValueError, match=FROZEN_ONLY):
            build_training(model, True, pred, 1e-4, torch.device("cpu"),
                           fused_tower=True)
    # A LoRA model scores through its module tower: the model's own maps.
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(2))
    scorer = PairScorer(cfg, model, model_kind="local", device="cpu",
                        fused_decoder=False)
    with torch.no_grad():
        want = model(scorer.normalize(a), scorer.normalize(b))
    torch.testing.assert_close(scorer.score_arrays(a, b), want)
