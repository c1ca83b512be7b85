"""The NR-IQA head and its training (srsem_torch/eval/nr_iqa.py,
srsem_torch/train/nr_iqa.py) against the JAX package's on the same
weights and inputs, 64 px, float32: ``degrade`` at 1e-6 (severities 0 and
1 among them, a size the 8-pixel blocks do not divide), the head's scores
at 1e-5, and a three-step ``train_nr_iqa`` from JAX's own init on the
same host RNG: its losses and validation MSE at 1e-5.  The port's
checkpoint carries its tower marker and reloads to the same scores; a
JAX-written checkpoint raises ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.eval.nr_iqa import NrIqaHead as JaxNrIqaHead
from srsem.eval.nr_iqa import NrIqaScorer as JaxNrIqaScorer
from srsem.train.nr_iqa import degrade as jax_degrade
from srsem.train.nr_iqa import train_nr_iqa as jax_train_nr_iqa
from srsem_torch.eval.nr_iqa import (
    OUTPUT_NAMES,
    NrIqaHead,
    NrIqaScorer,
    load_jax_nr_iqa,
)
from srsem_torch.train.nr_iqa import degrade, load_nr_iqa_head, train_nr_iqa
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

SIZE, SEED = 64, 3


def _images(n, size=SIZE, seed=0):
    """Smooth images (bicubic upsampling of 8x8 noise), so blur and
    contrast change their statistics."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(n, 8, 8, 3))
    return np.stack([np.asarray(Image.fromarray(
        (b * 255).astype(np.uint8)).resize((size, size), Image.BICUBIC),
        np.float32) / 255.0 for b in base])


@pytest.fixture(scope="module")
def jax_variables():
    """JAX's init of the head at ``SEED`` (what its train_nr_iqa draws)."""
    vs = JaxNrIqaHead(compute_dtype=jnp.float32).init(
        jax.random.PRNGKey(SEED), jnp.zeros((1, SIZE, SIZE, 3)))
    return jax.tree.map(np.asarray, jax.device_get(vs))


@pytest.mark.parametrize("shape", [(4, SIZE, SIZE), (3, 60, 52)])
def test_degrade_matches_jax(shape):
    n, h, w = shape
    imgs = np.random.default_rng(1).uniform(0, 1, (n, h, w, 3)).astype(
        np.float32)
    sev = np.random.default_rng(2).uniform(0, 1, (n, 4)).astype(np.float32)
    sev[0] = 0.0
    sev[1] = 1.0
    sev[2, :2] = (0.0, 1.0)
    got_x, got_y = degrade(imgs, sev)
    want_x, want_y = jax_degrade(jnp.asarray(imgs), jnp.asarray(sev))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6,
                               atol=1e-6)


def test_head_and_scorer_match_jax(jax_variables, tmp_path):
    """The head's scores on a normalized batch, through the port's fused
    tower (its plain version on the CPU) against JAX's module tower; a
    live output layer (JAX zero-initializes it); and the scorer on a path
    (the copied ImageNet preprocess)."""
    params = dict(jax_variables["params"])
    rng = np.random.default_rng(4)
    params["head.out"] = {
        "kernel": rng.normal(0, 0.05, (256, 5)).astype(np.float32),
        "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    model = load_jax_nr_iqa(NrIqaHead(torch.float32), params)
    x = rng.normal(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    jhead = JaxNrIqaHead(compute_dtype=jnp.float32)
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    path = tmp_path / "img.png"
    Image.fromarray((_images(1)[0] * 255).astype(np.uint8)).save(path)
    want = JaxNrIqaScorer({"params": params}, image_size=SIZE,
                          compute_dtype="float32")(str(path))
    got = NrIqaScorer(model, image_size=SIZE, device="cpu")(str(path))
    assert list(got) == list(OUTPUT_NAMES)
    np.testing.assert_allclose([got[k] for k in OUTPUT_NAMES],
                               [want[k] for k in OUTPUT_NAMES],
                               rtol=1e-5, atol=1e-5)


def test_train_three_steps_match_jax(jax_variables, tmp_path):
    """16 images: 12 train (three batches of 4, one epoch) and 4 for
    validation; the same host RNG draws the same batches and severities."""
    imgs = _images(16, seed=5)
    want = jax_train_nr_iqa(imgs, epochs=1, batch_size=4, lr=1e-3, seed=SEED)
    got = train_nr_iqa(imgs, epochs=1, batch_size=4, lr=1e-3, seed=SEED,
                       device="cpu", variables=jax_variables,
                       checkpoint_dir=str(tmp_path / "ckpt"))
    assert len(got.losses) == len(want.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.val_mse, want.val_mse, rtol=1e-5,
                               atol=1e-5)

    # The port's checkpoint reloads to the same head; its tower is the
    # port's own random init from the seed (JAX's load rebuilds another).
    from srsem_torch.train.checkpoint import restore_checkpoint

    raw = restore_checkpoint(str(tmp_path / "ckpt"))
    assert raw["tower_init"] == "torch" and int(raw["tower_seed"]) == SEED
    loaded = load_nr_iqa_head(str(tmp_path / "ckpt"), torch.float32)
    for k, v in loaded.head.state_dict().items():
        assert torch.equal(v, got.model.head.state_dict()[k]), k


def test_jax_checkpoint_refused(tmp_path):
    """A JAX-written NR-IQA checkpoint (no tower marker) raises instead of
    scoring its head against a different random tower."""
    from srsem.train.checkpoint import save_checkpoint as jax_save

    jax_save(str(tmp_path / "jax"), 1, {"trainable": {"head.out": {
        "kernel": np.zeros((256, 5), np.float32),
        "bias": np.zeros(5, np.float32)}}, "tower_seed": np.int32(0)})
    with pytest.raises(ValueError, match="PRNGKey"):
        load_nr_iqa_head(str(tmp_path / "jax"))
