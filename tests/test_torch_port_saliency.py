"""The port's TranSalNet-Dense, saliency losses, pad/crop geometry and
folder job (srsem_torch/explain/saliency.py) against the JAX package's
(srsem/explain/saliency.py) on the same weights.

The weights are the reference-layout torch mirror of
tests/test_saliency.py (random BN statistics, LayerNorms and positional
tables), built for a 64x64 input (taps at 8x8 / 4x4 / 2x2) and carried
through both packages' ``convert_transalnet``: the trees must be equal,
then JAX's tree goes into both models.  JAX's full model compiles once (a
module-scoped jitted apply).  Tolerances: the model, its taps, one
encoder and the train-mode forward with its running statistics rtol =
atol = 1e-4 (float32 through 78 dense layers, sums in another order);
losses rtol = atol = 1e-5 (sums of 320 terms of order 1; NSS sums to near
zero); the pad geometry byte-equal; the crop and the folder
job's maps within 1e-4.
"""

import copy
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.explain import saliency as js
from srsem.utils.convert import convert_transalnet as jax_convert_transalnet
from srsem_torch.explain import saliency as ts
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import (
    convert_transalnet,
    jax_module_state_dict,
    load_transalnet,
)
from test_saliency import _TorchMirror
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE = (64, 64)
TOL = dict(rtol=1e-4, atol=1e-4)


def mirror_state_dict(seed: int = 7):
    """The reference-layout TranSalNet at SIZE with random BN statistics,
    LayerNorms and positional tables (tests/test_saliency.py's draw)."""
    from torch import nn

    torch.manual_seed(seed)
    grid5 = ts.feature_grids(SIZE)[2]
    model = _TorchMirror.build()(grid5).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.7, 1.3)
                m.bias.normal_(0, 0.2)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.7, 1.4)
            elif isinstance(m, nn.LayerNorm):
                m.weight.uniform_(0.8, 1.2)
                m.bias.normal_(0, 0.05)
        for k in (1, 2, 3):
            getattr(model.decoder,
                    f"TransEncoder{k}").position_embeddings.normal_(0, 0.02)
    return model.state_dict()


@pytest.fixture(scope="module")
def weights():
    sd = mirror_state_dict()
    return sd, jax_convert_transalnet(sd)


@pytest.fixture(scope="module")
def jax_apply():
    model = js.TranSalNetDense()
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


@pytest.fixture(scope="module")
def port_model(weights):
    return load_transalnet(ts.TranSalNetDense(SIZE), weights[1]).eval()


def images(seed: int, n: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (n, *SIZE, 3)).astype(np.float32)


def assert_trees_equal(got, want) -> None:
    """The same paths, float32 leaves, equal bits."""
    flat_got, flat_want = flatten_dict(got), flatten_dict(want)
    assert set(flat_got) == set(flat_want)
    for path, value in flat_want.items():
        assert flat_got[path].dtype == np.float32, path
        np.testing.assert_array_equal(flat_got[path], np.asarray(value),
                                      err_msg=str(path))


def test_convert_transalnet_tree_equals_jax(weights):
    sd, want = weights
    got = convert_transalnet(sd)
    assert list(got) == ["params", "batch_stats"]
    assert_trees_equal(got, want)


def test_densenet_taps_match_jax(weights, port_model):
    tree = weights[1]
    x = images(1)
    want = jax.jit(js.DenseNet161Features().apply)(
        {"params": tree["params"]["encoder"],
         "batch_stats": tree["batch_stats"]["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port_model.encoder(torch.from_numpy(x))
    for g, w, ch, grid in zip(got, want, (768, 2112, 2208),
                              ts.feature_grids(SIZE)):
        assert tuple(g.shape) == (1, *grid, ch)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_trans_encoder_matches_jax(weights, port_model):
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 2112)).astype(
        np.float32)
    want = js.TransEncoder(768, 12).apply(
        {"params": weights[1]["params"]["TransEncoder2"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port_model.TransEncoder2(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 4, 4, 768)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transalnet_matches_jax(weights, jax_apply, port_model):
    x = images(3, 2)
    want = np.asarray(jax_apply(weights[1], jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, *SIZE)
    # A map that is neither saturated nor flat.
    assert 0.05 < want.min() and want.max() < 0.95 and want.std() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


def test_train_mode_forward_and_bn_update_match_jax(weights, port_model):
    """One train-mode forward: batch statistics in every BN, the running
    statistics updated as TorchBatchNorm updates them (torch momentum
    0.1, the unbiased variance)."""
    x = images(4, 2)
    out, updates = jax.jit(lambda v, x: js.TranSalNetDense().apply(
        v, x, train=True, mutable=["batch_stats"]))(weights[1], jnp.asarray(x))
    model = copy.deepcopy(port_model)
    got = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    want_stats = jax_module_state_dict({}, jax.device_get(
        updates["batch_stats"]))
    own = model.state_dict()
    before = port_model.state_dict()
    assert len(want_stats) == 2 * (1 + 2 * (6 + 12 + 36 + 24) + 3 + 6)
    for key, want in want_stats.items():
        assert not torch.equal(own[key], before[key]), key
        np.testing.assert_allclose(own[key].numpy(), want.numpy(), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["cc", "kldiv", "sim", "nss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.05, 1.0, (3, 16, 20)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (3, 16, 20)).astype(np.float32)
    if name == "nss":
        target = (target > 0.7).astype(np.float32)
    fn = {"cc": "loss_cc", "kldiv": "loss_kldiv", "sim": "loss_similarity",
          "nss": "loss_nss"}[name]
    got = getattr(ts, fn)(torch.from_numpy(pred), torch.from_numpy(target))
    want = getattr(js, fn)(jnp.asarray(pred), jnp.asarray(target))
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(ts.saliency_loss(pred, target, name)),
        float(js.saliency_loss(pred, target, name)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(500, 200), (200, 500), (768, 1024),
                                (100, 1000), (289, 384), (120, 500, 0),
                                (120, 500, 1)],
                         ids=lambda hw: "x".join(map(str, hw)))
def test_preprocess_pad_bytes_equal_jax(hw):
    """The pad geometry, byte for byte: 3-channel images (pad value 1),
    a 2-D grayscale one (pad 0) and an (H, W, 1) one (squeezed)."""
    rng = np.random.default_rng(6)
    shape = hw[:2] + ((3,) if len(hw) == 2 else (1,) * hw[2])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = ts.preprocess_pad(img)
    want = js.preprocess_pad(img)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(500, 200), (200, 500), (768, 1024)])
def test_postprocess_crop_matches_jax(hw):
    yy, xx = np.mgrid[0:288, 0:384].astype(np.float32)
    pred = np.sin(yy / 31.0) * np.cos(xx / 47.0) * 0.5 + 0.5
    got = ts.postprocess_crop(pred, hw)
    assert got.shape == hw and got.dtype == np.float32
    np.testing.assert_allclose(got, js.postprocess_crop(pred, hw),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="expected a"):
        ts.postprocess_crop(pred[None], hw)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three images of mixed aspect, one with a dotted stem, and a file
    the job skips."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(8)
    for name, hw in (("wide.png", (40, 90)), ("tall.jpg", (90, 40)),
                     ("a.v1.png", (64, 64))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            root / name)
    (root / "notes.txt").write_text("not an image")
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("geometry", ["pad", "resize"])
@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_generate_saliency_maps_matches_jax(weights, jax_apply, port_model,
                                            image_dir, tmp_path, geometry,
                                            order):
    """The same files (dotted stems kept), the same meta marker and maps
    within 1e-4 of JAX's job on the same weights."""
    kw = dict(image_size=SIZE, geometry=geometry, channel_order=order)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    n_jax = js.generate_saliency_maps(jax_apply, weights[1], str(image_dir),
                                      str(jax_out), **kw)
    n_port = ts.generate_saliency_maps(port_model, str(image_dir),
                                       str(port_out), device="cpu", **kw)
    assert n_port == n_jax == 3
    names = sorted(p.name for p in jax_out.iterdir())
    assert sorted(p.name for p in port_out.iterdir()) == names == [
        ".srsem_saliency_meta.json", "a.v1.npy", "tall.npy", "wide.npy"]
    meta = ".srsem_saliency_meta.json"
    assert (json.loads((port_out / meta).read_text())
            == json.loads((jax_out / meta).read_text()))
    for name in names[1:]:
        got, want = np.load(port_out / name), np.load(jax_out / name)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    if geometry == "pad":
        assert np.load(port_out / "wide.npy").shape == (40, 90)


def test_generate_saliency_maps_resume_guard(image_dir, tmp_path, capsys):
    """Same flags resume and skip existing maps; other flags raise; an
    unmarked tree with maps in it resumes with a warning on stderr."""
    def fake(x):
        return torch.full(x.shape[:3], 0.5)

    out = tmp_path / "SaliencyMaps"
    assert ts.generate_saliency_maps(fake, str(image_dir), str(out),
                                     image_size=SIZE, device="cpu") == 3
    (out / "tall.npy").unlink()
    assert ts.generate_saliency_maps(fake, str(image_dir), str(out),
                                     image_size=SIZE, device="cpu") == 1
    for flags in ({"geometry": "resize"}, {"channel_order": "rgb"},
                  {"image_size": (32, 32)}):
        kw = {"image_size": SIZE, **flags}
        with pytest.raises(ValueError, match="mix"):
            ts.generate_saliency_maps(fake, str(image_dir), str(out),
                                      device="cpu", **kw)
    for bad, match in (({"geometry": "stretch"}, "geometry"),
                       ({"channel_order": "bgra"}, "channel_order")):
        with pytest.raises(ValueError, match=match):
            ts.generate_saliency_maps(fake, str(image_dir),
                                      str(tmp_path / "x"), device="cpu",
                                      **bad)
    (out / ".srsem_saliency_meta.json").unlink()
    (out / "wide.npy").unlink()
    capsys.readouterr()
    assert ts.generate_saliency_maps(fake, str(image_dir), str(out),
                                     image_size=SIZE, device="cpu") == 1
    assert "unmarked tree with 2 existing maps" in capsys.readouterr().err
