"""The port's mesh (srsem_torch/core/meshes.py, srsem_torch/parallel/
sharding.py) against the JAX package's on the CPU: the mesh's shapes and
refusals, the sharded weights' names, and the scorers and the training
loop at ``data = 2``.

The ranks are two spawned gloo processes (tests/torch_mesh_ranks.py); the
JAX references run here on a mesh of two of the conftest's virtual CPU
devices.  The same jobs run once more in this process, without a process
group, on the rank-local 1x1 mesh: the port's one-rank reference.

Weights: a seeded port CLIP tower with random frozen BN statistics, a live
stages_cnn head (depth 2) and a CLU decoder at width 1/8, converted to the
JAX layout with the JAX package's converters (one tower for both models,
as DualScorer shares it); float32 at 64 px.
Tolerances: scores 1e-3 and maps 2e-3 against JAX (the scorer tests'),
1e-6 against the one-rank port; training as tests/test_torch_port_train.py
(losses rtol 3e-3, trained leaves 2·steps·lr, Adam's moments relative to
each leaf's scale, the CLU's BN statistics rtol 1e-3 / atol 1e-4), and
1e-5 between the two-rank and the one-rank port.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsem.eval.dataset_sweep as jax_dual_mod
import srsem.eval.scorer as jax_scorer_mod
import srsem.models.local_models as jax_local_mod
import torch_mesh_ranks as ranks
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.core.config import TrainConfig as JaxTrainConfig
from srsem.core.meshes import create_mesh as jax_create_mesh
from srsem.eval.dataset_sweep import DualScorer as JaxDualScorer
from srsem.eval.grouped import GroupedMapScorer as JaxGroupedMapScorer
from srsem.eval.grouped import GroupedPairScorer as JaxGroupedPairScorer
from srsem.eval.scorer import PairScorer as JaxPairScorer
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.models.local_models import make_local_model as jax_make_local
from srsem.parallel.sharding import param_pspecs as jax_param_pspecs
from srsem.train.loop import run_training as jax_run_training
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem.utils.convert import (
    convert_clip_resnet50,
    convert_clu_decoder,
    convert_global_head,
    convert_torch_resnet50,
)
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.cli.main import main as port_main
from srsem_torch.core.meshes import create_mesh
from srsem_torch.parallel.sharding import param_pspecs, param_shardings
from srsem_torch.train.partition import flatten_dict
from srsem_torch.train.steps import build_step_fns
from srsem_torch.utils.convert import _tower_key
from test_torch_port_train import (  # noqa: F401 — fixtures
    Capture,
    _batches,
    _close,
    _moments_close,
    _random_bn,
    _reference_cpu_convs,
    _two_threads,
)
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE, LR = ranks.SIZE, ranks.LR
JAX_CLIP = JaxBackboneConfig(kind="resnet50_clip", image_size=SIZE,
                             compute_dtype="float32")
JAX_GCFG = JaxGlobalConfig(backbone=JAX_CLIP, head="stages_cnn", depth=2)
JAX_LCFG = JaxLocalConfig(backbone=JAX_CLIP)


def randomize_bn(tower, seed):
    """Random frozen BN statistics, as tests/test_torch_port_train.py's
    ``_random_bn``: small gammas on each residual branch's closing BN keep
    the activations O(1), the shortcut's keep the image's signal (with
    small shortcut gammas too, every 64 px image reaches nearly the same
    deepest taps, and their squared differences are float32 rounding)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, m in tower.named_modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                closing = name.endswith("bn3")
                m.weight.copy_(torch.tensor(
                    rng.uniform(*((0.1, 0.3) if closing else (0.5, 1.5)), c)))
                m.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    return tower


def live_head(head):
    """Nonnegative kernels and a raised bias: the ReLU passes every
    score."""
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.abs_().mul_(50.0)
                m.bias.add_(0.1)
    return head


@pytest.fixture(scope="module")
def weights():
    """Port state dicts and the JAX variables of the same weights."""
    gm = ranks.make_global_model(ranks.GCFG,
                                 torch.Generator().manual_seed(0))
    randomize_bn(gm.backbone, 0)
    live_head(gm.aggregator)
    lm = ranks.make_local_model(ranks.LCFG,
                                generator=torch.Generator().manual_seed(1),
                                width_mult=ranks.WIDTH)
    # One tower for both, as DualScorer shares the global model's.
    lm.backbone.load_state_dict(gm.backbone.state_dict())
    dec = convert_clu_decoder(lm.decoder.state_dict())
    return {
        "global": gm.state_dict(), "local": lm.state_dict(),
        "jax_global": {"params": {
            "backbone": convert_clip_resnet50(gm.backbone.state_dict()),
            "aggregator": convert_global_head(
                gm.aggregator.state_dict())["aggregator"]}},
        "jax_local": {"params": {
            "backbone": convert_clip_resnet50(lm.backbone.state_dict()),
            **dec["params"]}, "batch_stats": dec["batch_stats"]},
    }


def jax_mesh(data, model=1):
    return jax_create_mesh(data=data, model=model,
                           devices=jax.devices("cpu")[:data * model])


# ---- the mesh itself ----------------------------------------------------------


def test_create_mesh_shapes_and_refusals_match_jax():
    """Without a process group the world is one rank: the shapes JAX
    builds on one device, and its ValueError texts where it has none."""
    one = jax.devices("cpu")[:1]
    mesh = create_mesh(device="cpu")
    assert mesh.shape == dict(jax_create_mesh(devices=one).shape)
    assert mesh.shape == {"data": 1, "model": 1}
    assert not mesh.distributed and mesh.is_main
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    for kw in ({"data": 2}, {"model": 2}, {"data": 1, "model": 2}):
        with pytest.raises(ValueError) as jax_err:
            jax_create_mesh(devices=one, **kw)
        with pytest.raises(ValueError) as port_err:
            create_mesh(device="cpu", **kw)
        assert str(port_err.value) == str(jax_err.value)


def test_param_pspecs_name_the_convs_jax_shards():
    """The same tower weights named for the model axis as JAX names them
    (HWIO's last dimension, OIHW's first), on the ImageNet tower at 64 px;
    with a trivial model axis nothing is sharded."""
    model = ranks.global_model(cfg=ranks.GlobalModelConfig(
        backbone=ranks.IMAGENET, head="stages_cnn", depth=3))
    jax_tree = convert_torch_resnet50(model.backbone.state_dict())
    for min_dim in (512, 1024):
        specs = param_pspecs(model.backbone, min_dim)
        jspecs = flatten_dict(jax_param_pspecs(jax_tree, min_dim))
        want = {_tower_key(path)[0] for path, s in jspecs.items() if s != ()}
        got = {name for name, s in specs.items() if s}
        assert got == want and len(got) > 0
        for name in got:
            assert specs[name][0] == "model"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    param_shardings(create_mesh(device="cpu"), model.backbone, 512)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_one_rank_mesh_step_equals_the_plain_step(weights, tmp_path):
    """A one-rank gloo process group's mesh runs every collective of the
    CLU train step, and gives today's step bit for bit."""
    batch = [torch.from_numpy(x) for x in _flat(_batches(
        4, [3], (SIZE, SIZE), 4)[0])]

    def step(mesh):
        model = ranks.local_model(weights["local"])
        model.decoder.requires_grad_(True)
        opt = torch.optim.Adam(model.decoder.parameters(), lr=LR)
        steps = build_step_fns(model, opt, True, model.backbone, mesh)
        loss = steps.train_step(*batch)
        return loss, model.state_dict()

    loss0, state0 = step(None)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = create_mesh(device="cpu")
        assert mesh.distributed and mesh.shape == {"data": 1, "model": 1}
        loss1, state1 = step(mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(state0[k], state1[k]) for k in state0)


def test_cli_mesh_flags(capsys, tmp_path):
    """``info`` reports the world and its default mesh; ``train-global``
    builds its mesh from ``--train-set mesh.*`` (a mesh larger than the
    world raises JAX's ValueError before any image loads); the sweeps
    take no ``--set``."""
    assert port_main(["info"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["distributed"] == {"rank": 0, "local_rank": 0, "world": 1,
                                   "mesh": {"data": 1, "model": 1}}
    study = tmp_path / "study.csv"
    study.write_text("img_names,userStudyScores\n"
                     + "".join(f"x4_{i}.png,{i}\n" for i in range(8)))
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        port_main(["train-global", str(study), str(tmp_path), "--device",
                   "cpu", "--train-set", "mesh.data_axis=2",
                   "--train-set", "batch_size=4"])
    with pytest.raises(SystemExit):
        port_main(["sweep-clu", "pairs.csv", "--device", "cpu",
                   "--set", "mesh.data_axis=2"])


def test_unsharded_model_axis_is_refused(weights):
    """A model axis over which nothing is sharded would make its ranks
    compute the same replica: the train step, the scorers and the sweeps'
    tower refuse it; once ``param_shardings`` has sharded the tower the
    step takes it."""
    from srsem_torch.core.meshes import Mesh
    from srsem_torch.eval.scorer import PairScorer
    from srsem_torch.train import multisweep

    mesh = Mesh(1, 2, torch.device("cpu"))
    model = ranks.global_model(weights["global"])
    opt = torch.optim.Adam(model.aggregator.parameters(), lr=LR)
    match = "nothing is sharded"
    with pytest.raises(ValueError, match=match):
        build_step_fns(model, opt, False, None, mesh)
    with pytest.raises(ValueError, match=match):
        PairScorer(ranks.GCFG, model, mesh=mesh)
    with pytest.raises(ValueError, match=match):
        multisweep.sweep_tower(ranks.GCFG, None, torch.Generator(),
                               torch.device("cpu"), mesh=mesh)
    conv = next(m for m in model.backbone.modules()
                if isinstance(m, torch.nn.Conv2d))
    conv.model_mesh = mesh  # the mark param_shardings leaves
    build_step_fns(model, opt, False, None, mesh)


def _flat(batch):
    ((a, b), y), mask = batch
    return a, b, y, mask


# ---- the scorers at data = 2 ---------------------------------------------------


@pytest.fixture(scope="module")
def scored(weights):
    rng = np.random.default_rng(7)
    payload = {"global": weights["global"], "local": weights["local"],
               "a": rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8),
               "b": rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8),
               "gt": rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8),
               "sr": rng.integers(0, 256, (3, 2, SIZE, SIZE, 3),
                                  dtype=np.uint8)}
    return payload, ranks.spawn(2, "scoring", payload), ranks.run_local(
        "scoring", payload)


def test_scorers_at_data_2_match_one_rank(scored):
    """Odd batches (3 pairs, 3 groups) padded to the data axis: every rank
    holds the whole result, equal to the one-rank port's."""
    _, on_ranks, local = scored
    assert [r["batch_size"] for r in on_ranks] == [4, 4]
    assert local["batch_size"] == 3
    for got in on_ranks:
        for key in ("pair", "maps", "grouped", "grouped_maps"):
            assert got[key].shape == local[key].shape, key
            np.testing.assert_allclose(got[key], local[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        for key in ("dual", "dual_groups"):
            for g, w in zip(got[key], local[key]):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=key)
    assert (local["pair"] > 0).all()


class _NarrowCluUnet(JaxCluUnet):
    """The JAX CluUnet at the tests' decoder width (its scorers build the
    model themselves, at full width)."""

    width_mult: float = ranks.WIDTH


def _narrow_local_model(cfg, split_tower=False, width_mult=1.0):
    return jax_make_local(cfg, split_tower=split_tower,
                          width_mult=ranks.WIDTH)


def test_scorers_at_data_2_match_jax(scored, weights, monkeypatch):
    """The same inputs through the JAX scorers on a data = 2 mesh."""
    monkeypatch.setattr(jax_scorer_mod, "make_local_model",
                        _narrow_local_model)
    monkeypatch.setattr(jax_local_mod, "make_local_model",
                        _narrow_local_model)
    monkeypatch.setattr(jax_dual_mod, "CluUnet", _NarrowCluUnet)
    p, on_ranks, _ = scored
    mesh = jax_mesh(2)
    gv, lv = weights["jax_global"], weights["jax_local"]
    want = {
        "pair": JaxPairScorer(JAX_GCFG, gv, mesh=mesh, batch_size=3
                              ).score_arrays(p["a"], p["b"]),
        "maps": JaxPairScorer(JAX_LCFG, lv, mesh=mesh, batch_size=3,
                              model_kind="local").score_arrays(p["a"], p["b"]),
        "grouped": JaxGroupedPairScorer(JAX_GCFG, gv, k=2, mesh=mesh,
                                        batch_size=3
                                        ).score_arrays(p["gt"], p["sr"]),
        "grouped_maps": JaxGroupedMapScorer(JAX_LCFG, lv, k=2, mesh=mesh,
                                            batch_size=3
                                            ).score_arrays(p["gt"], p["sr"]),
    }
    want = {k: np.asarray(v) for k, v in want.items()}
    want["dual_groups"] = [np.asarray(x) for x in JaxDualScorer(
        JAX_GCFG, JAX_LCFG, gv, lv, mesh=mesh, batch_size=3
    ).score_group_arrays(p["gt"], p["sr"])]
    want["dual"] = [want["pair"], want["maps"]]
    assert (want["pair"] > 0).all()
    for got in on_ranks:
        for key in ("pair", "grouped"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                       atol=1e-3, err_msg=key)
        for key in ("maps", "grouped_maps"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                       atol=2e-3, err_msg=key)
        for key in ("dual", "dual_groups"):
            np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-3,
                                       atol=1e-3, err_msg=key)
            np.testing.assert_allclose(got[key][1], want[key][1], rtol=2e-3,
                                       atol=2e-3, err_msg=key)


# ---- training at data = 2 -------------------------------------------------------


@pytest.fixture(scope="module")
def trained(weights, tmp_path_factory):
    """The global stream (batch 4, two epochs): its second batch has 2
    real rows, both on rank 0, so rank 1 holds only padding.  The CLU's
    single batch of 8 has 7, so rank 0 holds four real rows and rank 1
    three and a padded one.  (At 64 px the deepest decoder level is 2x2:
    with a batch of 4 its first BN's bias gradient is so ill-conditioned
    that JAX's one-device and two-device runs already differ in Adam's
    moments past the tolerance; a batch of 8 is not.)"""
    root = tmp_path_factory.mktemp("mesh_training")
    rng = np.random.default_rng(6)
    chans = (64, 256, 512, 1024, 2048)
    diffs = [rng.uniform(0, 0.6, (4, SIZE >> (i + 1), SIZE >> (i + 1), c))
             .astype(np.float32) ** 2 for i, c in enumerate(chans)]
    payload = {
        "global": weights["global"], "clu_variables": clu_variables(),
        "diffs": diffs,
        "ckpt_root": str(root),
        "batch_size": {"global": 4, "clu": 8},
        "epochs": {"global": 2, "clu": 1},
        "batches": {
            "global": (_batches(8, [4, 2], (), 4), _batches(9, [4, 1], (), 4)),
            "clu": (_batches(10, [7], (SIZE, SIZE), 8),
                    _batches(11, [8, 5], (SIZE, SIZE), 8)),
        },
    }
    yield payload, ranks.spawn(2, "training", payload), ranks.run_local(
        "training", payload)
    shutil.rmtree(root, ignore_errors=True)


def _narrow_clu(split_tower=True):
    return _NarrowCluUnet(backbone_kind="resnet50_clip", image_size=SIZE,
                          compute_dtype=jnp.float32,
                          decoder_dtype=jnp.float32, split_tower=split_tower)


def clu_variables():
    """The CLU of tests/test_torch_port_train.py's parity test: JAX's
    seeded init (jitted), random tower BN statistics.  (The port's own
    seeded CLU trains here too, but its deepest taps differ so little
    between images that float32 rounding moves its BN statistics by 1e-3
    of their size: no test of agreement to 1e-5.)"""
    z = jnp.zeros((1, SIZE, SIZE, 3))
    model = _narrow_clu()
    variables = jax.device_get(jax.jit(
        lambda key: model.init(key, z, z, train=False))(
        jax.random.PRNGKey(3)))
    variables = jax.tree.map(np.asarray, dict(variables))
    params = dict(variables["params"])
    params["backbone"] = _random_bn(params["backbone"],
                                    np.random.default_rng(3))
    return {**variables, "params": params}


def _jax_trained(weights, payload, kind):
    if kind == "global":
        model, variables = jax_make_global(JAX_GCFG), weights["jax_global"]
    else:
        model, variables = _narrow_clu(), payload["clu_variables"]
    writer = Capture()
    res = jax_run_training(
        model, kind == "clu", *payload["batches"][kind],
        JaxTrainConfig(lr=LR, epochs=payload["epochs"][kind],
                       batch_size=payload["batch_size"][kind]),
        jax_predicate(), writer=writer, mesh=jax_mesh(2),
        variables=variables)
    return res, writer


@pytest.mark.parametrize("kind", ["global", "clu"])
def test_training_at_data_2_matches_jax(trained, weights, kind):
    """``run_training`` at data = 2 against JAX's on a data = 2 mesh, with
    unequal valid rows on the two ranks: the per-step losses, the
    validation metrics, the trained head or decoder, Adam's state and the
    CLU's BatchNorm statistics (taken over both ranks)."""
    payload, on_ranks, _ = trained
    jres, jw = _jax_trained(weights, payload, kind)
    got = on_ranks[0][kind]
    n_steps = jres.step
    assert got["step"] == n_steps == len(got["losses"])
    np.testing.assert_allclose(got["losses"], jw.batch_losses(), rtol=3e-3,
                               atol=1e-5)
    for key, value in jres.val_metrics.items():
        np.testing.assert_allclose(got["val_metrics"][key], value,
                                   rtol=3e-3, atol=1e-5, err_msg=key)
    assert set(got["val_metrics"]) == set(jres.val_metrics)
    _close(got["trainable"], jax.device_get(jres.trainable), 1e-3,
           2 * n_steps * LR, kind)
    _moments_close(got["opt_state"], jres.opt_state)
    if kind == "clu":
        _close(got["batch_stats"], jax.device_get(jres.batch_stats), 1e-3,
               1e-4, "batch_stats")


def test_cross_rank_batch_norm_matches_batch_norm_in_float64(trained):
    """The decoder's cross-rank BN on two ranks (and on one) against
    ``F.batch_norm`` over the whole batch in float64: output, input
    gradient and the weight and bias gradients summed over the ranks
    within 1e-12 of their size.  (In float32 the two-pass statistics and
    ``F.batch_norm``'s differ by rounding that an ill-conditioned batch
    can grow to 1e-3 of a gradient; float64 leaves only the algorithm.)"""
    _, on_ranks, local = trained
    x, dy, weight, bias = ranks.bn64_inputs()
    for t in (x, weight, bias):
        t.requires_grad_(True)
    y = torch.nn.functional.batch_norm(x, None, None, weight, bias, True,
                                       0.1, 1e-5)
    (y * dy).sum().backward()
    want = {"y": y.detach(), "dx": x.grad, "dweight": weight.grad,
            "dbias": bias.grad}
    for got in [r["bn64"] for r in on_ranks] + [local["bn64"]]:
        for key, w in want.items():
            err = float((got[key] - w).abs().max() / w.abs().max())
            assert err <= 1e-12, (key, err)


@pytest.mark.parametrize("kind", ["global", "clu"])
def test_training_at_data_2_matches_one_rank(trained, kind):
    """Both ranks end with the one-rank run's losses and state (1e-5);
    only rank 0 writes checkpoints."""
    _, on_ranks, local = trained
    want = local[kind]
    assert [r[kind]["wrote"] for r in on_ranks] == [True, False]
    assert want["wrote"]
    assert on_ranks[1][kind]["losses"] == []  # rank 1 logs nothing
    got = on_ranks[0][kind]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"],
                               rtol=1e-5, atol=1e-7)
    n_steps = want["step"]
    for rank in on_ranks:
        # Adam turns a near-zero gradient's sign noise into a ±lr step.
        _close(rank[kind]["trainable"], want["trainable"], 1e-5,
               2 * n_steps * LR, "trainable")
        _close(rank[kind]["batch_stats"], want["batch_stats"], 1e-5, 1e-6,
               "batch_stats")
        for key, value in want["val_metrics"].items():
            np.testing.assert_allclose(rank[kind]["val_metrics"][key], value,
                                       rtol=1e-5, atol=1e-7, err_msg=key)


def test_batch_size_refusal_matches_jax(trained):
    """A batch that does not divide the data axis: JAX's ValueError."""
    _, on_ranks, local = trained
    with pytest.raises(ValueError) as jax_err:
        jax_run_training(None, False, [], [], JaxTrainConfig(batch_size=3),
                         jax_predicate(), mesh=jax_mesh(2))
    assert [r["refusal"] for r in on_ranks] == [str(jax_err.value)] * 2
    assert "refusal" not in local


def test_cross_rank_batchnorm_matches_jax(trained):
    """One train-mode decode of the same diff pyramids, two rows a rank:
    the maps and the running statistics the global batch moved equal
    JAX's (one apply over the whole batch) and the one-rank port's: the
    maps to tests/test_torch_port_train.py's tolerances for identical
    diffs, the statistics to rtol 1e-5 (the ranks' partial sums add in
    another order than one sum over the batch)."""
    payload, on_ranks, local = trained
    variables = payload["clu_variables"]
    want, upd = _narrow_clu().apply(
        variables, [jnp.asarray(d) for d in payload["diffs"]], None, True,
        method=JaxCluUnet.decode_from_diffs, mutable=["batch_stats"])
    for got in on_ranks:
        np.testing.assert_allclose(got["bn"]["maps"], np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["bn"]["maps"], local["bn"]["maps"],
                                   rtol=1e-6, atol=1e-6)
        _close(got["bn"]["batch_stats"], jax.device_get(upd["batch_stats"]),
               1e-5, 1e-7, "batch_stats")
        _close(got["bn"]["batch_stats"], local["bn"]["batch_stats"], 1e-5,
               1e-7, "batch_stats")
