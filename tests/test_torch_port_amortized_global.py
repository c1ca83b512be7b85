"""The global sweep amortizations in the port (srsem_torch/train/
{multisweep,diffcache,statcache}.py) against the JAX package's
(srsem/train/{multisweep,diffcache,statcache}.py): the shared tower, the
diff cache, the stat cache and the closed form.

Both sides get the same tower (a seeded JAX ImageNet tower with random BN
statistics, passed as ``backbone_params``) and the same initial heads
(JAX draws each from ``fold_in(PRNGKey(0), i)``; the port's draw from a
``torch.Generator``, so ``point_heads`` is wrapped here to return JAX's).
The train stream is one batch, so a cached epoch's batch order cannot
differ (JAX permutes with ``jax.random``, the port with its generator),
and several epochs run; JAX on one CPU device.  float32 at 64 px.
Tolerances: train losses, validation predictions (through the metrics)
and ``train_mse`` within rtol 1e-5; trained heads within 2·epochs·lr
absolute (Adam's sign noise on near-zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsem_torch.train.diffcache as port_diffcache
import srsem_torch.train.multisweep as port_multisweep
import srsem_torch.train.statcache as port_statcache
from srsem.backbones.resnet import ImageNetResNet50 as JaxImageNet
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import TrainConfig as JaxTrainConfig
from srsem.models.global_models import ConvHeadAggregator as JaxHead
from srsem.train import diffcache as jax_diffcache
from srsem.train import multisweep as jax_multisweep
from srsem.train import statcache as jax_statcache
from srsem.train.statcache import StatCache as JaxStatCache
from srsem_torch.config import BackboneConfig, GlobalModelConfig, TrainConfig
from srsem_torch.train.diffcache import estimate_cache_bytes
from srsem_torch.train.multisweep import SweepPoint, depth_grid, sweep_tower
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import conv_head_from_params
from test_torch_port_train import (  # noqa: F401 — fixture
    _batches,
    _mesh1,
    _random_bn,
    _reference_cpu_convs,
    _two_threads,
)

SIZE, LR, EPOCHS, SEED = 64, 1e-4, 3, 0
CHANNELS = {"layer2.2.act3": 512, "layer3.2.act3": 1024,
            "layer4.2.act3": 2048, "layer1.2.act3": 256}


@pytest.fixture(scope="module")
def setup():
    """The tower, the batches (one train batch of 4; validation 4 + a
    ragged 2), the configurations and the grid (depths 1-3 and a
    binarized-label point)."""
    bb = dict(kind="resnet50", image_size=SIZE, compute_dtype="float32")
    jtower = JaxImageNet(dtype=jnp.float32)
    z = jnp.zeros((1, SIZE, SIZE, 3))
    params = jax.device_get(jtower.init(jax.random.PRNGKey(3), z))["params"]
    params = _random_bn(jax.tree.map(np.asarray, params),
                        np.random.default_rng(3))
    train = _batches(1, [4])
    val = _batches(2, [4, 2], batch_size=4)
    binarize = lambda y: (y > 0.8) * 1.0  # noqa: E731 — both packages
    return dict(
        params=params, train=train, val=val,
        jcfg=JaxGlobalConfig(backbone=JaxBackboneConfig(**bb), depth=3),
        pcfg=GlobalModelConfig(backbone=BackboneConfig(**bb), depth=3),
        jtcfg=JaxTrainConfig(lr=LR, batch_size=4, epochs=EPOCHS, seed=SEED),
        ptcfg=TrainConfig(lr=LR, batch_size=4, epochs=EPOCHS, seed=SEED),
        jpoints=jax_multisweep.depth_grid() + [jax_multisweep.SweepPoint(
            "binarized", 2, label_transform=binarize)],
        ppoints=depth_grid() + [SweepPoint("binarized", 2,
                                           label_transform=binarize)])


def _jax_heads(points):
    """The heads JAX's sweeps draw: point i from fold_in(PRNGKey(SEED), i)."""
    rng = jax.random.PRNGKey(SEED)
    heads = []
    for i, p in enumerate(points):
        names = p.tap_names("resnet50")
        diffs0 = [jnp.zeros((1, 1, 1, CHANNELS[n])) for n in names]
        heads.append(jax.device_get(JaxHead(len(names)).init(
            jax.random.fold_in(rng, i), diffs0)["params"]))
    return heads


@pytest.fixture()
def jax_heads(monkeypatch, setup):
    heads = _jax_heads(setup["jpoints"])
    fn = lambda points, kind, generator: [  # noqa: E731
        conv_head_from_params(h) for h in heads]
    for module in (port_multisweep, port_diffcache, port_statcache):
        monkeypatch.setattr(module, "point_heads", fn)


def _compare(got, want, what, trained=True):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        for key in ("train_loss", "val_mse", "val_srcc"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {g['name']} {key}")
        fg = flatten_dict(g["head_params"])
        fw = flatten_dict(jax.device_get(w["head_params"]))
        assert set(fg) == set(fw)
        for k, v in fw.items():
            np.testing.assert_allclose(
                fg[k], np.asarray(v), rtol=0,
                atol=2 * EPOCHS * LR if trained else 1e-6,
                err_msg=f"{what} {g['name']} {k}")


def _run(setup, jax_fn, port_fn, **kw):
    s = setup
    want = jax_fn(s["jpoints"], s["jcfg"], s["jtcfg"], s["train"], s["val"],
                  mesh=_mesh1(), rng=jax.random.PRNGKey(SEED),
                  backbone_params=s["params"], **kw)
    got = port_fn(s["ppoints"], s["pcfg"], s["ptcfg"], s["train"], s["val"],
                  backbone_params=s["params"], device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("path", ["shared_tower", "cached_diffs",
                                  "cached_stats"])
def test_sweep_matches_jax(setup, jax_heads, path):
    """Three epochs of the four points: the last step's losses, the
    validation metrics and the trained heads."""
    fns = {"shared_tower": (jax_multisweep.train_global_sweep_shared_tower,
                            port_multisweep.train_global_sweep_shared_tower),
           "cached_diffs": (jax_diffcache.train_global_sweep_cached_diffs,
                            port_diffcache.train_global_sweep_cached_diffs),
           "cached_stats": (jax_statcache.train_global_sweep_cached_stats,
                            port_statcache.train_global_sweep_cached_stats)}
    got, want = _run(setup, *fns[path])
    _compare(got, want, path)


def test_cached_stats_closed_form_init_starts_at_the_fit(setup):
    """``closed_form_init`` starts each point at its ridge fit: with no
    epochs the validation metrics are the closed-form sweep's.  (Against
    JAX the trained result is not comparable here: four pairs and 3,840
    weights make the fit interpolate, and Adam's first step then follows
    the sign of residuals at rounding scale.)"""
    s = dict(setup, ptcfg=TrainConfig(lr=LR, batch_size=4, epochs=0,
                                      seed=SEED))
    got = port_statcache.train_global_sweep_cached_stats(
        s["ppoints"], s["pcfg"], s["ptcfg"], s["train"], s["val"],
        closed_form_init=True, backbone_params=s["params"], device="cpu")
    want = port_statcache.solve_global_sweep_closed_form(
        s["ppoints"], s["pcfg"], s["ptcfg"], s["train"], s["val"],
        backbone_params=s["params"], device="cpu")
    for g, w in zip(got, want):
        assert g["train_loss"] == 0.0
        np.testing.assert_allclose([g["val_mse"], g["val_srcc"]],
                                   [w["val_mse"], w["val_srcc"]], rtol=1e-6)


@pytest.fixture(scope="module")
def stat_caches(setup):
    """The train stream's stat caches of both packages, and the port's
    statistics as a JAX StatCache (``same``): the solvers compared on the
    same inputs."""
    s = setup
    names = sorted({n for p in s["ppoints"] for n in p.tap_names("resnet50")})
    jtower = JaxImageNet(dtype=jnp.float32)
    jcache = jax_statcache.build_stat_cache(jtower, s["params"], names,
                                            s["train"], _mesh1())
    tower = sweep_tower(s["pcfg"], s["params"], None, torch.device("cpu"))
    cache = port_statcache.build_stat_cache(tower, names, s["train"],
                                            torch.device("cpu"))
    same = JaxStatCache(stats={k: jnp.asarray(v.numpy())
                               for k, v in cache.stats.items()},
                        y=jnp.asarray(cache.y.numpy()),
                        mask=jnp.asarray(cache.mask.numpy()))
    return names, jcache, cache, same


@pytest.mark.parametrize("l2", [1e-6, 1e3])
def test_closed_form_matches_jax(setup, stat_caches, l2):
    """The stat cache (per-tap spatial means, within the towers' 1e-4);
    the ridge fit of each point on the same statistics in both packages;
    at l2 = 1e3 the whole closed-form sweep.  At l2 = 1e3 the fit is well
    posed: the solution's train predictions and ``train_mse``, and the
    sweep's train and validation MSE, within 1e-5 relative.  At JAX's
    default l2 = 1e-6 it is not (3,840 weights, four pairs): both fits
    interpolate the labels (train MSE below 1e-6) and their train
    predictions agree within 1e-3, while theta differs between two correct
    float32 solvers along the null space and is not compared."""
    names, jcache, cache, same = stat_caches
    for nm in names:
        np.testing.assert_allclose(cache.stats[nm].numpy(),
                                   np.asarray(jcache.stats[nm]), rtol=1e-4,
                                   atol=1e-5, err_msg=nm)
    posed = l2 > 1.0
    for p, jp in zip(setup["ppoints"], setup["jpoints"]):
        sel = p.tap_names("resnet50")
        want = jax_statcache.fit_conv_head_closed_form(
            same, sel, l2=l2, label_transform=jp.label_transform)
        got = port_statcache.fit_conv_head_closed_form(
            cache, sel, l2=l2, label_transform=p.label_transform)
        x = torch.cat([cache.stats[n] for n in sel], -1) / len(sel)
        pred = lambda th: (x @ torch.from_numpy(  # noqa: E731
            np.asarray(th[:-1], np.float32)) + float(th[-1])).numpy()
        if posed:
            np.testing.assert_allclose(got["train_mse"], want["train_mse"],
                                       rtol=1e-5, err_msg=p.name)
            np.testing.assert_allclose(pred(got["theta"]), pred(want["theta"]),
                                       rtol=1e-5, atol=1e-6, err_msg=p.name)
        else:
            assert max(got["train_mse"], want["train_mse"]) < 1e-6, p.name
            np.testing.assert_allclose(pred(got["theta"]), pred(want["theta"]),
                                       rtol=0, atol=1e-3, err_msg=p.name)
        assert set(got["params"]) == set(want["params"])
    if not posed:
        return
    got, want = _run(setup, jax_statcache.solve_global_sweep_closed_form,
                     port_statcache.solve_global_sweep_closed_form, l2=l2)
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        np.testing.assert_allclose([g["train_loss"], g["val_mse"]],
                                   [w["train_loss"], w["val_mse"]],
                                   rtol=1e-5, err_msg=g["name"])


def test_token_head_closed_form_matches_jax(stat_caches):
    """The shared singleLin fit (one weight over the layer-mean statistic)
    and its per-layer form, well posed (l2 = 1e3), on the same
    statistics."""
    names, _, cache, same = stat_caches
    for shared in (False, True):
        sel = ["layer3.2.act3"] if shared else names
        want = jax_statcache.fit_token_head_closed_form(
            same, sel, shared=shared, l2=1e3)
        got = port_statcache.fit_token_head_closed_form(
            cache, sel, shared=shared, l2=1e3)
        np.testing.assert_allclose(got["train_mse"], want["train_mse"],
                                   rtol=1e-5)
        assert set(got["params"]) == set(want["params"])


def test_diff_cache_guard_and_bytes(setup):
    """JAX's MemoryError past ``max_bytes``, and the byte estimate."""
    s = setup
    tower = sweep_tower(s["pcfg"], s["params"], None, torch.device("cpu"))
    with pytest.raises(MemoryError, match="diff cache exceeds 1000 bytes "
                       "after 4 pairs; use the shared-tower sweep"):
        port_diffcache.build_diff_cache(tower, ["layer4.2.act3"], s["train"],
                                        torch.device("cpu"), max_bytes=1000)
    shapes = {"a": (8, 8, 16), "b": (4, 4, 32)}
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        assert estimate_cache_bytes(shapes, 10, dtype) == \
            jax_diffcache.estimate_cache_bytes(shapes, 10, jdtype)
    cache = port_diffcache.build_diff_cache(
        tower, ["layer4.2.act3"], s["val"], torch.device("cpu"))
    assert cache.n_batches == 2 and cache.batch == 4
    assert tuple(cache.diffs["layer4.2.act3"].shape) == (2, 4, 2, 2, 2048)
