"""Port native decoder (srsem_torch/native) vs the JAX package's
(srsem/native): the same C++ source, built by the port into its own
``build/srsem_torch/``, gives the same bytes on JPEG (full and DCT-scaled)
and PNG (RGB and grayscale); failed files give zero rows with ok False;
``Preprocess`` and ``PairScorer(decode_backend="native")`` keep the JAX
package's contracts.

The reference library is built here, into a temp dir, with the JAX
package's own ``_build`` and flags, then renamed into place: several test
workers importing srsem.native at once may race on its first build
straight onto ``srsem/native/libsrsem_decode.so`` and load a half-written
file.  The module skips only where g++, jpeglib.h or png.h is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from srsem import native as jax_native
from srsem_torch import native
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.data.preprocess import Preprocess, decode_image
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import make_global_model
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=32, compute_dtype="float32"), depth=1)


def _missing_toolchain():
    """What the decoder's build lacks here (g++, jpeglib.h, png.h), or
    None."""
    if shutil.which("g++") is None:
        return "g++ not found"
    for header in ("jpeglib.h", "png.h"):
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input=f"#include <{header}>\n",
                              capture_output=True, text=True, timeout=60)
        if proc.returncode != 0:
            return f"{header} not found"
    return None


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both libraries: the port's, and the JAX package's built into a temp
    dir and pointed at for this module; a skip only without the
    toolchain."""
    missing = _missing_toolchain()
    if missing:
        pytest.skip(f"native decoder cannot be built here: {missing}")
    so = tmp_path_factory.mktemp("jax_native") / "libsrsem_decode.so"
    tmp = so.with_name(so.name + ".tmp")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(tmp))
        error = jax_native._build()  # the JAX package's flags
        if error is not None:
            pytest.fail(f"JAX native decoder build failed: {error}")
        os.replace(tmp, so)
        mp.setattr(jax_native, "_SO", str(so))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_error", None)
        assert jax_native.available(), jax_native.build_error()
        assert native.available(), native.build_error()
        yield native


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    y, x = np.mgrid[0:600, 0:720]
    smooth = np.stack([128 + 100 * np.sin(x / 97.0) * np.cos(y / 71.0),
                       128 + 100 * np.cos(x / 53.0),
                       128 + 100 * np.sin((x + y) / 129.0)], axis=-1)
    out = {"jpg": d / "a.jpg", "png": d / "a.png", "gray": d / "gray.png",
           "big": d / "big.jpg", "bad": d / "bad.jpg",
           "missing": d / "missing.jpg"}
    Image.fromarray(arr).save(out["jpg"], quality=95)
    Image.fromarray(arr).save(out["png"])
    Image.fromarray(arr[..., 0], mode="L").save(out["gray"])
    Image.fromarray(smooth.clip(0, 255).astype(np.uint8)).save(out["big"],
                                                              quality=92)
    out["bad"].write_bytes(b"\xff\xd8 junk, not a JPEG")
    yield {k: str(v) for k, v in out.items()}
    shutil.rmtree(d, ignore_errors=True)


def test_builds_into_the_ports_build_dir(built):
    """The port compiles its own copy of the source into build/srsem_torch
    under a hashed name, never the JAX package's srsem/native output."""
    target = native._target()
    assert target.exists() and target.parent == native.BUILD_DIR
    assert target.parent.parts[-2:] == ("build", "srsem_torch")
    assert target.name.startswith("decoder-") and target.suffix == ".so"
    assert "srsem/native" not in str(target)
    assert native.SRC.read_bytes() == open(
        jax_native._SRC, "rb").read()  # a byte-for-byte copy
    assert native.build_error() is None


@pytest.mark.parametrize("name,size,crop,fast", [
    ("jpg", 224, 1.0, False), ("jpg", 64, 0.875, False),
    ("png", 224, 1.0, False), ("gray", 64, 1.0, False),
    ("big", 224, 1.0, True), ("big", 128, 0.875, True),
    ("jpg", 224, 224 / 300, True)])
def test_decode_equals_jax_bytes(built, files, name, size, crop, fast):
    got = native.decode(files[name], size, crop, fast_jpeg=fast)
    want = jax_native.decode(files[name], size, crop, fast_jpeg=fast)
    assert got is not None and got.shape == (size, size, 3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name == "gray":
        np.testing.assert_array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("fast", [False, True])
def test_decode_batch_equals_jax_and_failure_contract(built, files, fast):
    paths = [files["jpg"], files["bad"], files["png"], files["missing"],
             files["big"], files["gray"]]
    imgs, ok = native.decode_batch(paths, 64, 0.875, n_threads=3,
                                   fast_jpeg=fast)
    want, want_ok = jax_native.decode_batch(paths, 64, 0.875, n_threads=3,
                                            fast_jpeg=fast)
    assert imgs.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(ok, [True, False, True, False, True, True])
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(imgs, want)
    assert imgs[1].sum() == 0 and imgs[3].sum() == 0  # zero rows
    assert native.decode(files["bad"], 64) is None
    assert native.decode(files["missing"], 64) is None


def test_preprocess_native_contract(built, files, monkeypatch):
    """decode_uint8_native: the library's bytes, None for a failed file and
    (as in the JAX package) None when the library is unavailable; the
    resample stays within the JAX test's limits of PIL; decode_image is
    the PIL path."""
    pre = Preprocess.for_backbone("resnet50_clip", 224)
    got = pre.decode_uint8_native(files["png"])
    np.testing.assert_array_equal(got, native.decode(files["png"], 224, 1.0))
    diff = np.abs(got.astype(np.int32)
                  - pre.decode_uint8(files["png"]).astype(np.int32))
    assert diff.mean() < 0.5 and np.quantile(diff, 0.999) <= 6
    assert diff.max() <= 16
    assert pre.decode_uint8_native(files["bad"]) is None
    imgs, ok = pre.decode_batch_native([files["jpg"], files["bad"]])
    assert imgs.shape == (2, 224, 224, 3) and ok.tolist() == [True, False]
    np.testing.assert_array_equal(
        decode_image(files["jpg"], 64, "resnet50"),
        Preprocess.for_backbone("resnet50", 64).decode_uint8(files["jpg"]))
    monkeypatch.setattr(native, "available", lambda: False)
    assert pre.decode_uint8_native(files["png"]) is None


def test_pair_scorer_native_backend(built, files, monkeypatch):
    """decode_backend='native' scores through the library, with a NaN row
    on exactly the corrupt file; without the library it fails at
    construction, never falling back to PIL quietly."""
    model = make_global_model(CFG, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.aggregator.w_layers:
            layer.weight.abs_()
            layer.bias.fill_(1.0)  # a live ReLU: finite scores are >= 1
    scorer = PairScorer(CFG, model, batch_size=2, decode_backend="native",
                        num_workers=2, device="cpu")
    pairs = [(files["jpg"], files["png"]), (files["jpg"], files["bad"]),
             (files["gray"], files["big"])]
    scores = scorer.score_paths(pairs)
    assert np.isnan(scores).tolist() == [False, True, False]
    assert (scores[[0, 2]] >= 1).all()
    with pytest.raises(IOError, match="native decode failed"):
        scorer._decode_one(files["missing"])
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native decoder is unavailable"):
        PairScorer(CFG, model, batch_size=2, decode_backend="native",
                   device="cpu")
