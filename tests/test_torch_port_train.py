"""Port training (srsem_torch/train/{steps,loop}.py) vs the JAX package's
(srsem/train/{steps,loop}.py) from the same variables on the same batches.

The JAX model is initialised with a seeded ``PRNGKey``; its tower's
FrozenBatchNorms get random statistics (small gammas closing each residual
branch keep the activations O(1)) and its variables go into the port with
``load_jax_*_params``.  Both loops then train N steps on the same numpy
batches, the last one ragged (padded by repeating its last row, masked),
float32 at 64 px: the port through its fused tower (the kernels' plain
versions on the CPU), JAX through its module tower.

Tolerances are tests/test_train_parity.py's: losses rtol 3e-3 / atol 1e-5;
trained parameters rtol 1e-3 / atol 2·n_steps·lr (Adam turns a
near-zero gradient's sign noise into a full ±lr step); Adam's moments the
same, relative to each leaf's scale; BN running statistics after N steps
rtol 1e-3 / atol 1e-4 (the ±lr noise feeds later batches), and after one
train-mode decode of identical diff pyramids rtol 1e-6 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import TrainConfig as JaxTrainConfig
from srsem.core.meshes import create_mesh
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.train.loop import run_training as jax_run_training
from srsem.train.loop import train_global as jax_train_global
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem.train.steps import masked_mse as jax_masked_mse
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.config import LocalModelConfig, TrainConfig
from srsem_torch.data.loader import collate, pad_batch
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train.checkpoint import restore_checkpoint
from srsem_torch.train.loop import run_training, train_global
from srsem_torch.train.partition import flatten_dict, trainable_predicate
from srsem_torch.train.steps import masked_mse
from srsem_torch.utils.convert import jax_trainable_params, load_jax_local_params
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE, LR = 64, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a process: test workers share the host's
    cores, and torch's default of one thread a core then oversubscribes
    them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_cpu_convs():
    """The CPU's reference float32 convolutions, not oneDNN's: oneDNN's
    conv backward in float32 lands ~5e-3 (relative to each gradient's
    scale) from a float64 reference on the decoder's 3x3 convs, where
    JAX's and the reference convolutions land within 5e-6 (the CPU's
    counterpart of turning TF32 off on the card)."""
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


class Capture:
    """A metric writer keeping every record."""

    def __init__(self):
        self.records = []

    def write(self, step, metrics):
        self.records.append((step, dict(metrics)))

    def close(self):
        pass

    def batch_losses(self):
        return [m["train_loss_batch"] for _, m in self.records
                if "train_loss_batch" in m]


def _mesh1():
    return create_mesh(data=1, model=1, devices=jax.devices("cpu")[:1])


def _random_bn(tree, rng, path=()):
    """Random statistics in every FrozenBatchNorm of a JAX tower tree."""
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape[0]
        closing = path[-1] == "bn3"
        return {"scale": rng.uniform(*((0.1, 0.3) if closing else (0.5, 1.5)),
                                     c).astype(np.float32),
                "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                "mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return {k: _random_bn(v, rng, path + (k,)) if isinstance(v, dict)
            else np.asarray(v) for k, v in tree.items()}


def _variables(jmodel, seed, n_extra=()):
    z = jnp.zeros((1, SIZE, SIZE, 3))
    vs = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), z, z,
                                    *n_extra))
    vs = jax.tree.map(np.asarray, dict(vs))
    params = dict(vs["params"])
    params["backbone"] = _random_bn(params["backbone"],
                                    np.random.default_rng(seed))
    return {**vs, "params": params}


def _batches(seed, sizes, label_shape=(), batch_size=None):
    """Masked batches of the given real sizes, padded to ``batch_size``
    (default the first size) by repeating the last row (the loader's ragged
    final batch).  ``b`` is drawn apart from ``a``: for near-identical
    pairs the deep taps' squared differences cancel, and the float32
    rounding in which the two towers differ (about 1e-6) then reaches the
    decoder's gradients magnified by |tap| / |tap difference|."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        samples = []
        for _ in range(n):
            a = rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
            b = rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
            samples.append(((a, b), rng.uniform(0, 1, label_shape)
                            .astype(np.float32)))
        out.append(pad_batch(collate(samples), batch_size or sizes[0]))
    return out


def _close(got, want, rtol, atol, what):
    flat_g, flat_w = flatten_dict(got), flatten_dict(want)
    assert set(flat_g) == set(flat_w), what
    for key, w in flat_w.items():
        np.testing.assert_allclose(np.asarray(flat_g[key]), np.asarray(w),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(key)}")


def _moments_close(got, want, moments=True):
    """Adam's step count, and its first and second moments leaf by leaf,
    relative to each leaf's own scale, floored by the tree's: a conv bias
    feeding a BatchNorm has a zero gradient whose float32 noise is no scale
    (tests/test_train_parity.py)."""
    assert int(got["0"]["count"]) == int(want[0].count)
    for key in ("mu", "nu") if moments else ():
        flat_g = flatten_dict(got["0"][key])
        flat_w = {k: np.asarray(v) for k, v in flatten_dict(
            jax.device_get(getattr(want[0], key))).items()}
        assert set(flat_g) == set(flat_w)
        tree_scale = max(float(np.abs(w).max()) for w in flat_w.values())
        for path, w in flat_w.items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(
                flat_g[path], w, rtol=1e-3,
                atol=max(1e-2 * scale, 1e-4 * tree_scale),
                err_msg=f"{key} {'/'.join(path)}")


def _train_both(jmodel, pmodel, variables, is_map, train, val, tmp_path,
                **port_kw):
    jw, pw = Capture(), Capture()
    jres = jax_run_training(
        jmodel, is_map, train, val, JaxTrainConfig(lr=LR, epochs=1),
        jax_predicate(), writer=jw, mesh=_mesh1(), variables=variables)
    pres = run_training(
        pmodel, is_map, train, val,
        TrainConfig(lr=LR, epochs=1, checkpoint_dir=str(tmp_path / "ckpt")),
        trainable_predicate(), writer=pw, variables=variables, device="cpu",
        **port_kw)
    return jres, jw, pres, pw


@pytest.mark.parametrize("fused_tower", [True, False])
def test_global_training_matches_jax(tmp_path, fused_tower):
    """stages_cnn (depth 2, CLIP tower): per-step losses, the epoch's
    validation MSE and SRCC, the trained head, Adam's state and the
    checkpoint the port writes (its opt_state in optax's layout)."""
    jcfg = JaxGlobalConfig(backbone=JaxBackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"),
        head="stages_cnn", depth=2)
    jmodel = jax_make_global(jcfg)
    variables = _variables(jmodel, 0)
    agg = variables["params"]["aggregator"]
    for head in agg.values():  # a live head: the ReLU passes every score
        head["kernel"] = np.abs(head["kernel"]) * 0.05
        head["bias"] = head["bias"] + 0.1
    pcfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"),
        head="stages_cnn", depth=2)
    pmodel = make_global_model(pcfg)
    n_steps = 3
    train = _batches(1, [4, 4, 3])
    val = _batches(2, [4, 2])
    jres, jw, pres, pw = _train_both(jmodel, pmodel, variables, False,
                                     train, val, tmp_path,
                                     fused_tower=fused_tower)
    assert pres.step == jres.step == n_steps
    np.testing.assert_allclose(pw.batch_losses(), jw.batch_losses(),
                               rtol=3e-3, atol=1e-5)
    assert len(pw.batch_losses()) == n_steps
    for key in ("loss", "mse", "srcc"):
        np.testing.assert_allclose(pres.val_metrics[key],
                                   jres.val_metrics[key], rtol=3e-3,
                                   atol=1e-5, err_msg=key)
    _close(pres.trainable, jax.device_get(jres.trainable), 1e-3,
           2 * n_steps * LR, "head")
    _moments_close(pres.opt_state, jres.opt_state)
    saved = restore_checkpoint(str(tmp_path / "ckpt"))
    assert set(saved) == {"trainable", "opt_state", "batch_stats"}
    assert saved["batch_stats"] == {} and saved["opt_state"]["1"] == {}
    assert saved["opt_state"]["0"]["count"].dtype == np.int32
    _close(saved["trainable"], pres.trainable, 0, 0, "checkpoint")
    _moments_close(saved["opt_state"], jres.opt_state)
    # The tower stayed frozen and untouched.
    assert not any(p.requires_grad for p in pmodel.backbone.parameters())


@pytest.mark.parametrize("sizes", [[3], [3, 3, 2]], ids=["one", "three"])
def test_clu_training_matches_jax(tmp_path, sizes):
    """The CLU decoder (width 1/8, CLIP tower), batch 3 of which the last
    is ragged: per-step losses, the validation MSE, the trained decoder
    (BN scale and bias too), Adam's state, and the BatchNorm running
    statistics (the padded row included, as in JAX).  The statistics and
    Adam's moments are compared after one step, where they differ by the
    towers' rounding only; after three they also carry the ±lr sign noise
    of the earlier updates (a conv bias feeding a BatchNorm has a zero
    gradient), which moves a running mean by up to 2·n_steps·lr times the
    conv's summed input, and are only checked to have moved."""
    wm = 0.125
    jmodel = JaxCluUnet(backbone_kind="resnet50_clip", image_size=SIZE,
                        compute_dtype=jnp.float32,
                        decoder_dtype=jnp.float32, width_mult=wm)
    variables = _variables(jmodel, 3)
    pmodel = make_local_model(LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")),
        width_mult=wm)
    n_steps = len(sizes)
    train = _batches(4, sizes[:-1] + [sizes[-1] - 1], (SIZE, SIZE), 3)
    val = _batches(5, [3, 1], (SIZE, SIZE))
    jres, jw, pres, pw = _train_both(jmodel, pmodel, variables, True,
                                     train, val, tmp_path)
    np.testing.assert_allclose(pw.batch_losses(), jw.batch_losses(),
                               rtol=3e-3, atol=1e-5)
    for key in ("loss", "mse"):
        np.testing.assert_allclose(pres.val_metrics[key],
                                   jres.val_metrics[key], rtol=3e-3,
                                   atol=1e-5, err_msg=key)
    assert "srcc" not in pres.val_metrics
    _close(pres.trainable, jax.device_get(jres.trainable), 1e-3,
           2 * n_steps * LR, "decoder")
    _moments_close(pres.opt_state, jres.opt_state, moments=n_steps == 1)
    start = flatten_dict(variables["batch_stats"])
    moved = flatten_dict(pres.batch_stats)
    assert all(not np.allclose(moved[k], start[k]) for k in start)
    if n_steps == 1:
        _close(pres.batch_stats, jax.device_get(jres.batch_stats), 1e-3,
               1e-4, "batch_stats")
    saved = restore_checkpoint(str(tmp_path / "ckpt"))
    _close(saved["batch_stats"], pres.batch_stats, 0, 0, "saved stats")


def test_train_mode_batchnorm_matches_jax_on_identical_diffs():
    """One train-mode decode of the same diff pyramids through the same
    decoder: the maps, and the running statistics that the batch moved
    (momentum 0.1, the Bessel-corrected variance: JAX's TorchBatchNorm)."""
    wm = 0.125
    jmodel = JaxCluUnet(backbone_kind="resnet50_clip", image_size=SIZE,
                        compute_dtype=jnp.float32,
                        decoder_dtype=jnp.float32, width_mult=wm)
    variables = _variables(jmodel, 5)
    rng = np.random.default_rng(6)
    stats0 = flatten_dict(variables["batch_stats"])
    for key in stats0:  # start away from the init's zeros and ones
        stats0[key] = rng.uniform(0.5, 1.5, stats0[key].shape).astype(np.float32)
    from srsem_torch.train.partition import unflatten_dict
    variables["batch_stats"] = unflatten_dict(stats0)
    pmodel = load_jax_local_params(make_local_model(
        LocalModelConfig(backbone=BackboneConfig(
            kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")),
        width_mult=wm), variables)
    chans = (64, 256, 512, 1024, 2048)
    diffs = [rng.uniform(0, 0.6, (3, SIZE >> (i + 1), SIZE >> (i + 1), c))
             .astype(np.float32) ** 2 for i, c in enumerate(chans)]
    want, upd = jmodel.apply(variables, [jnp.asarray(d) for d in diffs],
                             None, True, method=JaxCluUnet.decode_from_diffs,
                             mutable=["batch_stats"])
    got = pmodel.decode_from_diffs([torch.from_numpy(d) for d in diffs],
                                   train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    _, stats = jax_trainable_params(pmodel)
    _close(stats, jax.device_get(upd["batch_stats"]), 1e-6, 1e-7,
           "one-step batch_stats")


def test_masked_mse_matches_jax():
    """Scalars, maps with the row mask broadcast, a ragged mask, and a map
    against scalar labels: numpy broadcasting where it applies (W == N),
    JAX's ValueError where it does not."""
    rng = np.random.default_rng(7)
    mask = np.array([1, 1, 0, 1], np.float32)
    cases = [(rng.random(4), rng.random(4)),
             (rng.random((4, 5, 6)), rng.random((4, 5, 6))),
             (rng.random((4, 3, 4)), rng.random(4))]
    for pred, y in cases:
        pred, y = pred.astype(np.float32), y.astype(np.float32)
        want = float(jax_masked_mse(jnp.asarray(pred), jnp.asarray(y),
                                    jnp.asarray(mask)))
        got = float(masked_mse(torch.from_numpy(pred), torch.from_numpy(y),
                               torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    pred, y = np.zeros((4, 3, 5), np.float32), np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax_masked_mse(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(mask))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        masked_mse(torch.from_numpy(pred), torch.from_numpy(y),
                   torch.from_numpy(mask))


def test_unet_global_training_raises_as_jax():
    """JAX's train_global applies the unet_global CluUnet as a scalar
    model: its raw (N, H, W) map meets (N,) labels in masked_mse, which
    raises at the first step.  The port raises the same error there."""
    bb = dict(kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")
    train = _batches(8, [2])
    message = (r"Incompatible shapes for broadcasting: "
               rf"shapes=\[\(2, {SIZE}, {SIZE}\), \(2,\)\]")
    with pytest.raises(ValueError, match=message):
        jax_train_global(
            JaxGlobalConfig(backbone=JaxBackboneConfig(**bb),
                            head="unet_global"),
            JaxTrainConfig(batch_size=2, epochs=1), train, train,
            mesh=_mesh1(), writer=Capture())
    with pytest.raises(ValueError, match=message):
        train_global(GlobalModelConfig(backbone=BackboneConfig(**bb),
                                       head="unet_global"),
                     TrainConfig(batch_size=2, epochs=1), train, train,
                     device="cpu", writer=Capture())
