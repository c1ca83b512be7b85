"""srsem_torch/eval/lpips.py against srsem/eval/lpips.py on the same
weights and seeded numpy images, at JAX's own tolerances (rtol 2e-4,
atol 2e-5; tests/test_lpips.py): AlexNet and VGG16, the pair distance and
the ``spatial`` maps (the bilinear upsampling from each tap's size,
edge rows included), the official ``.pth`` layouts loaded straight into
the port's module, and ``convert_lpips``'s tree leaf for leaf."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.eval.lpips import convert_lpips as jax_convert_lpips
from srsem.eval.lpips import make_lpips as jax_make_lpips
from srsem_torch.eval.lpips import (
    LPIPS,
    convert_lpips,
    load_lpips,
    make_lpips,
)
from srsem_torch.train.partition import flatten_dict
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

SIZE = 64


def _official(net, seed):
    """A torchvision ``features`` state dict (with a classifier key, as the
    whole-model file has) and an lpips lin file of non-negative weights."""
    g = torch.Generator().manual_seed(seed)
    model = LPIPS(net).reset_parameters(g)
    tower = {k: v + 0.05 * torch.randn(v.shape, generator=g)
             for k, v in model.state_dict().items() if k.startswith("features.")}
    tower["classifier.1.weight"] = torch.zeros(4, 4)
    lins = {k: v.abs() for k, v in model.state_dict().items()
            if k.startswith("lin")}
    return lins, tower


def _images(seed, n=3):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    x1 = np.clip(x0 + 0.2 * rng.standard_normal(x0.shape), 0, 1)
    return x0, x1.astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "vgg"])
@pytest.mark.parametrize("spatial", [False, True])
def test_lpips_matches_jax(net, spatial):
    lins, tower = _official(net, 0)
    params = jax_convert_lpips(lins, tower, net=net)
    want = np.asarray(jax_make_lpips(net=net, params=params, image_size=SIZE,
                                     spatial=spatial)(*map(jnp.asarray,
                                                           _images(1))))
    x0, x1 = _images(1)
    for port in (make_lpips(net, params=params, spatial=spatial, device="cpu"),
                 make_lpips(net, lin_sd=lins, tower_sd=tower, spatial=spatial,
                            device="cpu")):
        got = port(x0, x1).numpy()
        assert got.shape == ((3, SIZE, SIZE) if spatial else (3,))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert np.all(make_lpips(net, params=params, device="cpu")(x0, x0)
                  .numpy() == 0.0)


def test_official_files_load_straight_in():
    """The torchvision and lpips files' keys are the module's own: a plain
    ``load_state_dict`` takes them, and lpips' other key spellings load
    through ``load_lpips`` to the same weights."""
    lins, tower = _official("alex", 2)
    model = LPIPS("alex")
    missing, unexpected = model.load_state_dict({**lins, **tower},
                                                strict=False)
    assert not missing and unexpected == ["classifier.1.weight"]
    other = load_lpips(LPIPS("alex"), {k.replace("lin", "lins.", 1): v
                                       for k, v in lins.items()},
                       {f"net.{k}": v for k, v in tower.items()})
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_convert_lpips_matches_jax(net):
    lins, tower = _official(net, 3)
    want = flatten_dict(jax_convert_lpips(lins, tower, net=net))
    got = flatten_dict(convert_lpips(lins, tower, net=net))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
