"""The port's sweeps and service on a mesh of two spawned gloo ranks
(tests/torch_mesh_ranks.py) against the same code on one rank.

* The shared-tower sweeps (global depth points, CLU thresholds), the diff
  caches (global, CLU decoder), the stat cache and its closed form, one
  cached batch an epoch as tests/test_torch_port_amortized_{global,clu}.py
  run them against JAX: each rank runs the tower on its slice of every
  batch and trains replicated heads and decoders; the results equal the
  one-rank run's (losses and metrics rtol 1e-5, trained leaves within
  2·epochs·lr, BN statistics rtol 1e-5 / atol 1e-6).
* ``ScoreService`` at data = 2: JAX's ``group_batch`` refusal and ladder,
  and a scripted stdio session (scores, a scalar request, maps, a file
  that fails to decode, warmup) whose responses equal the one-rank
  service's (1e-6): rank 0 serves, rank 1 follows.

The tower is the JAX-seeded CLIP tower of tests/test_torch_port_train.py's
CLU test, the heads and decoders the port's seeded ones; float32 at 64 px.
"""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

import torch_mesh_ranks as ranks
from srsem.cli.serve import ScoreService as JaxScoreService
from srsem_torch.train.partition import flatten_dict
from test_torch_port_mesh import (
    JAX_GCFG,
    clu_variables,
    jax_mesh,
    weights,  # noqa: F401 — fixture
)
from test_torch_port_train import (  # noqa: F401 — fixtures
    _batches,
    _reference_cpu_convs,
    _two_threads,
)
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE, LR, EPOCHS = ranks.SIZE, ranks.LR, 2
THRESHOLDS = [None, 0.5]


def _clu_batches(seed, sizes, batch_size):
    """Per-threshold label maps (N, T, H, W), binarized from one map."""
    out = []
    for ((a, b), y), mask in _batches(seed, sizes, (SIZE, SIZE), batch_size):
        y = np.stack([y if t is None else (y > t).astype(np.float32)
                      for t in THRESHOLDS], axis=1)
        out.append((((a, b), y), mask))
    return out


@pytest.fixture(scope="module")
def swept():
    payload = {
        "tower": clu_variables()["params"]["backbone"],
        "epochs": EPOCHS, "batch_size": 4, "seed": 0,
        "global": (_batches(20, [3], (), 4), _batches(21, [4, 2], (), 4)),
        "local": (_clu_batches(22, [3], 4), _clu_batches(23, [4, 3], 4)),
    }
    return ranks.spawn(2, "sweeps", payload), ranks.run_local("sweeps",
                                                              payload)


def _leaves(result):
    """{path: array} of a sweep's results, trees flattened."""
    out = {}
    for i, r in enumerate(result if isinstance(result, list) else [result]):
        for key, value in r.items():
            if isinstance(value, dict):
                for path, leaf in flatten_dict(value).items():
                    out[(i, key) + path] = np.asarray(leaf)
            elif not isinstance(value, str):
                out[(i, key)] = np.asarray(value)
    return out


@pytest.mark.parametrize("mode", ["shared", "cached_diffs", "cached_stats",
                                  "closed_form", "thresholds",
                                  "local_cached"])
def test_sweep_at_data_2_matches_one_rank(swept, mode):
    on_ranks, local = swept
    want = _leaves(local[mode])
    for rank in on_ranks:
        got = _leaves(rank[mode])
        assert set(got) == set(want)
        for key, w in want.items():
            trained = any(k in ("head_params", "trainable") for k in key)
            atol = (2 * EPOCHS * LR if trained
                    else 1e-6 if "batch_stats" in key else 1e-7)
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=atol,
                                       err_msg=str(key))


# ---- the service ----------------------------------------------------------------


def _png(path, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                    ).save(path)
    return str(path)


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):  # noqa: F811 — the fixture
    root = tmp_path_factory.mktemp("mesh_serve")
    img = [_png(root / f"{i}.png", i) for i in range(5)]
    requests = [
        {"id": 1, "gt": img[0], "sr": [img[1], img[2]]},
        {"id": 2, "gt": img[3], "sr": img[4]},
        {"id": 3, "gt": img[1], "sr": [img[2], str(root / "missing.png")]},
        {"id": 4, "gt": img[0], "sr": [img[3], img[4]], "maps": True},
        {"cmd": "ping"},
        {"id": 5, "gt": img[2], "sr": [img[0], img[1]]},
    ]
    payload = {"global": weights["global"], "local": weights["local"],
               "requests": requests}
    yield ranks.spawn(2, "serve", payload), ranks.run_local("serve", payload)
    shutil.rmtree(root, ignore_errors=True)


def test_service_at_data_2_refusal_and_ladder_match_jax(served, weights):
    on_ranks, local = served
    mesh = jax_mesh(2)
    with pytest.raises(ValueError) as jax_err:
        JaxScoreService(JAX_GCFG, weights["jax_global"], group_batch=3,
                        mesh=mesh)
    jax_ladder = JaxScoreService(JAX_GCFG, weights["jax_global"],
                                 group_batch=4, mesh=mesh)._ladder()
    assert jax_ladder == [2, 4]
    for rank in on_ranks:
        assert rank["refusal"] == str(jax_err.value)
        assert rank["ladder"] == jax_ladder
    assert local["ladder"] == JaxScoreService(
        JAX_GCFG, weights["jax_global"], group_batch=4,
        mesh=jax_mesh(1))._ladder()


def test_service_at_data_2_answers_as_one_rank(served):
    on_ranks, local = served
    got, want = on_ranks[0]["responses"], local["responses"]
    assert "responses" not in on_ranks[1]
    assert len(got) == len(want) == 6
    assert got[4] == want[4] == {"ok": True}
    assert got[2]["scores"][1] is None and got[3]["map_means"][0] > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, list):
                np.testing.assert_allclose(
                    np.array(g[key], dtype=float),
                    np.array(value, dtype=float), rtol=1e-6, atol=1e-6,
                    err_msg=json.dumps(w))
            elif isinstance(value, float):
                np.testing.assert_allclose(g[key], value, rtol=1e-6,
                                           atol=1e-6)
            else:
                assert g[key] == value
