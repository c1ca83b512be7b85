"""The port's decomposition (srsem_torch/decompose/) against the JAX
package's (srsem/decompose/) on the same seeded dictionary and
embeddings: ADMM against ``admm_lasso`` (1e-4, and its step count under
the same stopping rule) and sklearn's positive Lasso, the greedy span
(the same indices; every mode within 1e-5), and SpLiCE: the rank search
(the same weights' support, rank and hint keys), ``recompose``,
``weights2words``, ``force_compute_basis``, ``project_to_basis``,
``find_all_basis_rank_range``, the ``skl`` solver, and a hint file written
byte-equal to JAX's.  float32 on the CPU."""

import json

import numpy as np
import pytest
import torch

from srsem.decompose.admm import admm_lasso as jax_admm
from srsem.decompose.greedy import GreedyDecomposer as JaxGreedy
from srsem.decompose.splice import SpliceDecomposer as JaxSplice
from srsem_torch.decompose import admm
from srsem_torch.decompose.admm import admm_lasso, precompute_factors
from srsem_torch.decompose.greedy import MODES, GreedyDecomposer
from srsem_torch.decompose.splice import SpliceDecomposer
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

VOCAB = [f"w{i}" for i in range(50)]


@pytest.fixture(scope="module")
def dictionary():
    r = np.random.default_rng(42)
    concepts = r.standard_normal((50, 16)).astype(np.float32)
    return concepts / np.linalg.norm(concepts, axis=1, keepdims=True)


def _emb(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 16)).astype(
        np.float32)


@pytest.mark.parametrize("l1,max_iter", [(0.02, 2000), (0.1, 2000),
                                         (0.5, 2000), (0.1, 7)])
def test_admm_matches_jax(dictionary, l1, max_iter):
    v = _emb(0, 3)
    got = admm_lasso(dictionary, v, l1, max_iter=max_iter, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 50)
    want = np.asarray(jax_admm(dictionary, v, l1, max_iter=max_iter))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert (got.numpy() >= 0).all()
    assert np.array_equal(got.numpy() > 0, want > 0) or max_iter < 10


def test_admm_stopping_rule(dictionary):
    """At least one step; stop once both residual maxima are below tol, or
    at max_iter (``_solve`` returns the steps taken)."""
    factors = precompute_factors(dictionary, device="cpu")

    def steps(tol=1e-6, max_iter=2000):
        return admm._solve(factors, torch.from_numpy(_emb(1)), 0.1, tol,
                           max_iter)

    assert steps(max_iter=1)[1] == 1
    assert steps(tol=1e3)[1] == 1  # converged after the first
    w, n = steps(tol=1e-5)
    assert torch.equal(w, admm_lasso(None, _emb(1), 0.1, factors=factors,
                                     tol=1e-5))
    assert 2 < n < 2000
    # A cap at n steps reaches the same iterate; one fewer does not.
    assert torch.equal(w, steps(tol=0.0, max_iter=n)[0])
    assert not torch.equal(w, steps(tol=0.0, max_iter=n - 1)[0])
    assert admm.ADMMFactors._fields == ("concepts", "chol", "rho")


def test_admm_matches_sklearn_positive_lasso(dictionary):
    sklearn = pytest.importorskip("sklearn.linear_model")
    v = _emb(1)
    l1 = 0.1
    ours = admm_lasso(dictionary, v, l1, tol=1e-8, max_iter=20000,
                      device="cpu").numpy()[0]
    clf = sklearn.Lasso(alpha=l1 / (2 * 16), fit_intercept=False,
                        positive=True, max_iter=100000, tol=1e-10)
    clf.fit(dictionary.T, v[0])
    np.testing.assert_allclose(ours, clf.coef_, atol=5e-3)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_matches_jax(dictionary, mode):
    target = (dictionary[7] * 2.0 + _emb(2)[0] * 0.3).astype(np.float32)
    got = GreedyDecomposer(dictionary, VOCAB, rank=6, mode=mode,
                           device="cpu")(target)
    want = JaxGreedy(dictionary, VOCAB, rank=6, mode=mode)(target)
    if mode == "debug":
        assert got[2] == want[2] and got[2][0] == "w7"
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    else:
        assert got.shape == (16,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_greedy_ties_and_zero_sum_guard():
    """Equal dots pick the first index (argmax's rule, both packages); a
    basis whose cosines sum to zero keeps finite weights."""
    concepts = np.array([[1, 0], [1, 0], [0, 1], [-1, 0]], np.float32)
    target = np.array([1, 1], np.float32)
    got = GreedyDecomposer(concepts, rank=2, device="cpu")(target)[2]
    assert [int(i) for i in got] == [int(i) for i in JaxGreedy(
        concepts, rank=2)(target)[2]] == [0, 2]
    basis = np.array([[1, 0], [-1, 0]], np.float32)
    for mode in ("w_rec", "w_filt_rec"):
        out = GreedyDecomposer(basis, rank=2, mode=mode, device="cpu")(
            np.array([1, 0], np.float32))
        want = JaxGreedy(basis, rank=2, mode=mode)(np.array([1, 0], np.float32))
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def _pair(dictionary, mean=None, **kw):
    mean = np.zeros(16, np.float32) if mean is None else mean
    return (SpliceDecomposer(dictionary, mean, vocab=VOCAB, device="cpu", **kw),
            JaxSplice(dictionary, mean, vocab=VOCAB, **kw))


@pytest.mark.parametrize("rank,seed", [(3, 5), (5, 4)])
def test_splice_rank_search_matches_jax(dictionary, rank, seed):
    mean = _emb(3)[0] * 0.1
    port, ref = _pair(dictionary, mean)
    emb = _emb(seed, 2)
    got = port.decompose(emb, rank=rank)
    want = ref.decompose(emb, rank=rank)
    assert got is not None and want is not None
    np.testing.assert_array_equal(np.count_nonzero(got, axis=1), [rank, rank])
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert port.l1p_hint["admm"].keys() == ref.l1p_hint["admm"].keys()
    np.testing.assert_allclose(
        [port.l1p_hint["admm"][k] for k in ref.l1p_hint["admm"]],
        list(ref.l1p_hint["admm"].values()), rtol=1e-12)
    np.testing.assert_allclose(port.recompose(got), ref.recompose(want),
                               atol=1e-4)
    l0, words, scores = port.weights2words(got)
    jl0, jwords, jscores = ref.weights2words(want)
    np.testing.assert_array_equal(l0, jl0)
    for a, b in zip(words, jwords):
        assert list(a) == list(b)
    for a, b in zip(scores, jscores):
        np.testing.assert_allclose(a, b, atol=1e-4)
    attempts = port.decompose(emb[:1], rank=rank, return_attempts=True)
    assert rank in attempts[0]


def test_splice_l1_and_errors(dictionary):
    port, ref = _pair(dictionary)
    emb = _emb(5, 2)
    np.testing.assert_allclose(port.decompose(emb, l1=0.2),
                               ref.decompose(emb, l1=0.2), atol=1e-4)
    with pytest.raises(ValueError):
        port.decompose(emb)
    with pytest.raises(ValueError):
        port.decompose(emb, l1=0.1, rank=2)
    with pytest.raises(ValueError):
        port.decompose(emb, solver="nope", l1=0.1)
    # The search gives up as JAX's does: None after its max iterations,
    # here where the second row's bracket, made of the first row's hints,
    # holds no l1 of rank 3 for it; the hints agree.
    port, ref = _pair(dictionary, _emb(3)[0] * 0.1, rank_search_max_iter=60)
    assert port.decompose(_emb(4, 2), rank=3) is None
    assert ref.decompose(_emb(4, 2), rank=3) is None
    assert port.l1p_hint == ref.l1p_hint


def test_splice_skl_solver_matches_jax(dictionary):
    pytest.importorskip("sklearn")
    port, ref = _pair(dictionary)
    emb = _emb(6)
    np.testing.assert_array_equal(port.decompose(emb, "skl", l1=0.2),
                                  ref.decompose(emb, "skl", l1=0.2))


def test_force_compute_basis_matches_jax(dictionary):
    port, ref = _pair(dictionary)
    emb = _emb(5)
    got = port.force_compute_basis(emb, rank=4)
    want = ref.force_compute_basis(emb, rank=4)
    assert got["l1p"] == want["l1p"]
    assert list(got["words"]) == list(want["words"])
    np.testing.assert_allclose(got["weights"], want["weights"], atol=1e-4)
    np.testing.assert_allclose(got["trunc_scores"], want["trunc_scores"],
                               atol=1e-4)
    every = port.force_compute_basis(emb, rank=4, return_attempts=True)
    assert every.keys() == ref.force_compute_basis(
        emb, rank=4, return_attempts=True).keys()


def test_project_to_basis_matches_jax(dictionary):
    port, ref = _pair(dictionary)
    w = np.zeros((2, 50), np.float32)
    w[0, [2, 7, 11]] = [1.0, 0.4, 0.2]
    w[1, [5, 9]] = [0.3, 0.6]
    target = _emb(6, 2)
    got = port.project_to_basis(w, target)
    # Row 1's support takes no positive weight: its projection is zero.
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), [1.0, 0.0],
                               atol=1e-4)
    np.testing.assert_allclose(got, ref.project_to_basis(w, target),
                               atol=1e-4)


def test_find_all_basis_rank_range_matches_jax(dictionary):
    port, ref = _pair(dictionary)
    emb = _emb(7)
    got = port.find_all_basis_rank_range(emb, 3, 5)
    want = ref.find_all_basis_rank_range(emb, 3, 5)
    assert got.keys() == want.keys()
    for rank in got:
        np.testing.assert_array_equal(got[rank] > 0, want[rank] > 0)
        np.testing.assert_allclose(got[rank], want[rank], atol=1e-4)
    assert port.l1p_hint["admm"].keys() == ref.l1p_hint["admm"].keys()


def test_hint_file_round_trip_matches_jax(tmp_path, dictionary):
    """save_l1p_hint writes JAX's bytes; with_hints_file reads the nested
    and the flat (reference) forms."""
    port, ref = _pair(dictionary)
    for sp in (port, ref):
        assert sp.decompose(_emb(8), rank=4) is not None  # a search's hints
        sp.l1p_hint["admm"].update({50: 0.25, 0: 1.4375})
        sp.l1p_hint["skl"][7] = 0.125
    port.save_l1p_hint(str(tmp_path / "port.json"))
    ref.save_l1p_hint(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    back = SpliceDecomposer.with_hints_file(
        dictionary, np.zeros(16, np.float32), str(tmp_path / "jax.json"),
        device="cpu")
    assert back.l1p_hint == ref.l1p_hint
    flat = tmp_path / "flat.json"
    flat.write_text(json.dumps({"5": 0.5}))
    back = SpliceDecomposer.with_hints_file(
        dictionary, np.zeros(16, np.float32), str(flat), device="cpu")
    assert back.l1p_hint == {"skl": {}, "admm": {5: 0.5}}


def test_entry_points_default_to_the_card(dictionary):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        precompute_factors(dictionary)
    with pytest.raises(RuntimeError, match="cuda"):
        GreedyDecomposer(dictionary)
    with pytest.raises(RuntimeError, match="cuda"):
        SpliceDecomposer(dictionary, np.zeros(16, np.float32))
