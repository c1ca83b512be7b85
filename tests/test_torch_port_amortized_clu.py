"""The CLU sweep amortizations in the port (srsem_torch/train/
{multisweep,diffcache}.py: the shared-tower threshold sweep and the
cached-diff decoder training) against the JAX package's, and the refusals
both share: LoRA and full fine-tune configurations on the shared and cached
paths, the cache's ``MemoryError``.

Both sides get the same tower (a seeded JAX CLIP tower with random BN
statistics, as ``backbone_params``) and the same initial decoder: JAX's
``make_local_model`` is wrapped here to width 1/8 (the decoder at full
width is what the card runs; on the CPU it only costs time), and the
port's ``make_local_model`` to start from JAX's ``PRNGKey(seed)`` init.
The train stream is one batch, so the batch order of a cached epoch
cannot differ; several epochs run; JAX on one CPU device; float32 at 64
px, oneDNN's convolutions off as in tests/test_torch_port_train.py.
Tolerances: losses and validation MSE within rtol 1e-5; trained decoders
within 2·epochs·lr absolute; BN running statistics within rtol 1e-3 /
atol 1e-4 (tests/test_torch_port_train.py's, after several steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsem.models.local_models as jax_local
import srsem_torch.train.multisweep as port_multisweep
from srsem.backbones.resnet import ClipResNet50 as JaxClip
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.core.config import TrainConfig as JaxTrainConfig
from srsem.train import diffcache as jax_diffcache
from srsem.train import multisweep as jax_multisweep
from srsem_torch.config import BackboneConfig, LocalModelConfig, TrainConfig
from srsem_torch.data.loader import collate, pad_batch
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train import diffcache as port_diffcache
from srsem_torch.train.loop import frozen_tower
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import load_backbone_params, load_jax_local_params
from test_torch_port_train import (  # noqa: F401 — fixture
    _mesh1,
    _random_bn,
    _reference_cpu_convs,
    _two_threads,
)

SIZE, LR, EPOCHS, SEED, WM = 64, 1e-4, 3, 0, 0.125
THRESHOLDS = [None, 0.4, 0.9]


def _batches(seed, sizes, n_thresholds=None, batch_size=None):
    """Masked CLU batches (maps, or (N, T, H, W) per-threshold maps
    binarized from one map, as KoniqPairsMapsDataset(thresholds=...))."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        samples = []
        for _ in range(n):
            a, b = (rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
                    for _ in range(2))
            m = rng.uniform(0, 1, (SIZE, SIZE)).astype(np.float32)
            y = m if n_thresholds is None else np.stack(
                [m if t is None else (m > t).astype(np.float32)
                 for t in THRESHOLDS])
            samples.append(((a, b), y))
        out.append(pad_batch(collate(samples), batch_size or sizes[0]))
    return out


@pytest.fixture(scope="module")
def tower_params():
    jtower = JaxClip(dtype=jnp.float32, image_size=SIZE)
    z = jnp.zeros((1, SIZE, SIZE, 3))
    params = jax.device_get(jtower.init(jax.random.PRNGKey(4), z))["params"]
    return _random_bn(jax.tree.map(np.asarray, params),
                      np.random.default_rng(4))


@pytest.fixture()
def same_init(monkeypatch):
    """JAX's CluUnet at width 1/8, and the port's from JAX's init."""
    real = jax_local.make_local_model
    monkeypatch.setattr(
        jax_local, "make_local_model",
        lambda cfg, split_tower=False, width_mult=1.0: real(cfg, split_tower,
                                                            WM))

    def port_make(cfg, split_tower=False, width_mult=1.0, generator=None):
        jm = real(JaxLocalConfig(backbone=JaxBackboneConfig(
            kind=cfg.backbone.kind, image_size=SIZE,
            compute_dtype="float32")), False, WM)
        z = jnp.zeros((1, SIZE, SIZE, 3))
        variables = jax.device_get(jm.init(jax.random.PRNGKey(SEED), z, z,
                                           train=False))
        return load_jax_local_params(make_local_model(cfg, width_mult=WM),
                                     variables)

    monkeypatch.setattr(port_multisweep, "make_local_model", port_make)


def _cfgs(rank=None):
    bb = dict(kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")
    return (JaxLocalConfig(backbone=JaxBackboneConfig(**bb), lora_rank=rank),
            LocalModelConfig(backbone=BackboneConfig(**bb), lora_rank=rank),
            JaxTrainConfig(lr=LR, batch_size=3, epochs=EPOCHS, seed=SEED),
            TrainConfig(lr=LR, batch_size=3, epochs=EPOCHS, seed=SEED))


def _close(got, want, rtol, atol, what):
    fg, fw = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(fg) == set(fw), what
    for key, w in fw.items():
        np.testing.assert_allclose(fg[key], np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {key}")


def test_shared_tower_threshold_sweep_matches_jax(tower_params, same_init):
    """Three thresholds, one decoder each, on one tower stream: the last
    step's losses, the validation MSE, the trained decoders and their BN
    running statistics."""
    jcfg, pcfg, jtcfg, ptcfg = _cfgs()
    train = _batches(1, [3], len(THRESHOLDS))
    val = _batches(2, [3, 1], len(THRESHOLDS), batch_size=3)
    want = jax_multisweep.train_local_sweep_shared_tower(
        THRESHOLDS, jcfg, jtcfg, train, val, mesh=_mesh1(),
        rng=jax.random.PRNGKey(SEED), backbone_params=tower_params)
    got = port_multisweep.train_local_sweep_shared_tower(
        THRESHOLDS, pcfg, ptcfg, train, val, backbone_params=tower_params,
        device="cpu")
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        np.testing.assert_allclose([g["train_loss"], g["val_mse"]],
                                   [w["train_loss"], w["val_mse"]],
                                   rtol=1e-5, err_msg=g["name"])
        _close(g["trainable"], w["trainable"], 0, 2 * EPOCHS * LR, g["name"])
        _close(g["batch_stats"], w["batch_stats"], 1e-3, 1e-4, g["name"])


def test_cached_diffs_clu_matches_jax(tower_params, same_init):
    """Decoder-only training on the diff cache: the last loss, the
    validation MSE (a ragged batch padded and masked), the trained
    decoder and BN statistics; and the cache's layout, JAX's: a float32
    (n_batches, batch, h, w, c) pyramid shallow to deep, no pixel channel
    without v2, the masks as the loader padded them."""
    jcfg, pcfg, jtcfg, ptcfg = _cfgs()
    train = _batches(3, [3])
    val = _batches(4, [3, 2], batch_size=3)
    want = jax_diffcache.train_local_cached_diffs(
        jcfg, jtcfg, train, val, mesh=_mesh1(), rng=jax.random.PRNGKey(SEED),
        backbone_params=tower_params)
    got = port_diffcache.train_local_cached_diffs(
        pcfg, ptcfg, train, val, backbone_params=tower_params, device="cpu")
    np.testing.assert_allclose([got["train_loss"], got["val_mse"]],
                               [want["train_loss"], want["val_mse"]],
                               rtol=1e-5)
    _close(got["trainable"], want["trainable"], 0, 2 * EPOCHS * LR, "decoder")
    _close(got["batch_stats"], want["batch_stats"], 1e-3, 1e-4, "stats")

    pmodel = make_local_model(pcfg, width_mult=WM)
    load_backbone_params(pmodel.backbone, "resnet50_clip", tower_params)
    cache = port_diffcache.build_local_diff_cache(
        pmodel, frozen_tower(pmodel.backbone, "resnet50_clip"), val,
        torch.device("cpu"))
    assert cache["img_sq"] is None
    assert [tuple(d.shape) for d in cache["diffs"]] == [
        (2, 3, SIZE >> s, SIZE >> s, c)
        for s, c in zip((1, 2, 3, 4, 5), (64, 256, 512, 1024, 2048))]
    assert all(d.dtype == torch.float32 for d in cache["diffs"])
    np.testing.assert_array_equal(cache["mask"].numpy(), [[1, 1, 1],
                                                           [1, 1, 0]])
    np.testing.assert_array_equal(cache["y"].numpy(),
                                  np.stack([y for (_, y), _ in val]))


@pytest.mark.parametrize("rank", [8, "full"], ids=["lora", "full"])
def test_tower_training_refuses_the_amortized_paths_as_jax(rank):
    """A tower that trains cannot share or cache: JAX's ValueErrors, before
    any tower pass."""
    jcfg, pcfg, jtcfg, ptcfg = _cfgs(rank)
    for jfn, pfn, msg in (
            (jax_multisweep.train_local_sweep_shared_tower,
             port_multisweep.train_local_sweep_shared_tower,
             "shared-tower CLU sweep needs a frozen tower"),):
        with pytest.raises(ValueError, match=msg):
            jfn(THRESHOLDS, jcfg, jtcfg, [], [])
        with pytest.raises(ValueError, match=msg):
            pfn(THRESHOLDS, pcfg, ptcfg, [], [], device="cpu")
    msg = "cached-diff CLU training applies to decoder-only configs"
    with pytest.raises(ValueError, match=msg):
        jax_diffcache.train_local_cached_diffs(jcfg, jtcfg, [], [])
    with pytest.raises(ValueError, match=msg):
        port_diffcache.train_local_cached_diffs(pcfg, ptcfg, [], [],
                                                device="cpu")


def test_clu_cache_guard_as_jax(tower_params):
    """Past ``max_bytes`` the CLU cache raises JAX's MemoryError."""
    pmodel = make_local_model(_cfgs()[1], width_mult=WM)
    load_backbone_params(pmodel.backbone, "resnet50_clip", tower_params)
    with pytest.raises(MemoryError, match="CLU diff cache exceeds 4096 bytes; "
                       "lower epochs' cost with the standard train_local"):
        port_diffcache.build_local_diff_cache(
            pmodel, frozen_tower(pmodel.backbone, "resnet50_clip"),
            _batches(5, [1]), torch.device("cpu"), max_bytes=4096)
