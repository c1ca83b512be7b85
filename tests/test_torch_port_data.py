"""The port's training data layer vs the JAX package's: datasets
(srsem_torch/data/datasets.py vs srsem/data/datasets.py), the loader
(srsem_torch/data/loader.py vs srsem/data/loader.py), the host resize
(srsem_torch/ops/npimage.py vs the JAX kernel, as
tests/test_ops_image.py::test_numpy_resize_matches_jax_kernel holds
srsem/ops/npimage.py) and the metrics (srsem_torch/train/metrics.py).

Arrays must be equal (the same host code on the same files); the resize
within the JAX test's rtol 1e-5 / atol 1e-6.
"""

import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from srsem.data import datasets as jds
from srsem.data import loader as jld
from srsem.data.preprocess import Preprocess as JaxPreprocess
from srsem.ops.image import resize_bilinear
from srsem.train import metrics as jmetrics
from srsem_torch.data import datasets as pds
from srsem_torch.data import loader as pld
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.ops.npimage import resize_bilinear_np
from srsem_torch.train import metrics as pmetrics
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """SR/ and HQ/ images and both CSV conventions."""
    root = tmp_path_factory.mktemp("study")
    (root / "SR").mkdir()
    (root / "HQ").mkdir()
    rng = np.random.default_rng(0)
    scores, answers = [], []
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(
            root / "HQ" / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
            root / "SR" / f"esrgan_x4_{i}.png")
        scores.append(f"esrgan_x4_{i}.png,{0.125 * i!r}")
        answers.append(f"esrgan_x4_{i}.png,{['Yes', 'No', 'maybe'][i % 3]}")
    (root / "scores.csv").write_text(
        "img_names,userStudyScores\n" + "\n".join(scores) + "\n")
    (root / "answers.csv").write_text(
        "Super Resolution Image,Answer\n" + "\n".join(answers) + "\n")
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def pairs_csv(study):
    """KonIQ-style rows: HQ and non-HQ firsts, captions 1-8, 13x11 maps."""
    rng = np.random.default_rng(1)
    rows = ["img_a_pth,img_b_pth,out_paths,ima_ncaps"]
    for i in range(6):
        m = study / f"map{i}.pkl"
        with open(m, "wb") as f:
            pickle.dump(rng.uniform(0, 1, (13, 11)).astype(np.float64), f)
        first = study / ("HQ" if i % 2 else "SR") / (
            f"{i}.jpg" if i % 2 else f"esrgan_x4_{i}.png")
        rows.append(f"{first},{study / 'SR' / f'esrgan_x4_{i}.png'},{m},"
                    f"{[1, 2, 4, 8, 2, 3][i]}")
    path = study / "pairs.csv"
    path.write_text("\n".join(rows) + "\n")
    return path


def _same_sample(got, want):
    (ga, gb), gy = got
    (wa, wb), wy = want
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gy, wy)
    assert np.asarray(gy).dtype == np.asarray(wy).dtype


@pytest.mark.parametrize("csv_name", ["scores.csv", "answers.csv"])
def test_user_study_scores_matches_jax(study, csv_name):
    """Both column conventions: paths (the SR→HQ name rule), labels (the
    raw score, or "Yes" → 1.0 and anything else 0.0) and samples."""
    kw = dict(csv_path=str(study / csv_name), root=str(study))
    got = pds.UserStudyScores(preprocess=Preprocess(size=32), **kw)
    want = jds.UserStudyScores(preprocess=JaxPreprocess(size=32), **kw)
    assert len(got) == len(want) == 6
    for i in range(6):
        assert got.paths(i) == want.paths(i)
        assert got.label(i) == want.label(i)
        _same_sample(got[i], want[i])
    assert got.paths(2)[1].endswith("HQ/2.jpg")


@pytest.mark.parametrize("only_hq,mincaps", [(False, 2), (True, 2),
                                             (False, 4)])
@pytest.mark.parametrize("threshold", [None, 0.4, "list"])
def test_koniq_pairs_maps_matches_jax(pairs_csv, threshold, only_hq, mincaps):
    """The caption and HQ filters, and the maps binarized then resized
    (one threshold, none, or a list stacked (T, H, W))."""
    kw = dict(csv_path=str(pairs_csv), only_hq=only_hq, imgamincaps=mincaps)
    if threshold == "list":
        kw["thresholds"] = [None, 0.4, 0.9]
    else:
        kw["threshold"] = threshold
    got = pds.KoniqPairsMapsDataset(preprocess=Preprocess(size=24), **kw)
    want = jds.KoniqPairsMapsDataset(preprocess=JaxPreprocess(size=24), **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _same_sample(got[i], want[i])
    label = got[0][1]
    assert label.shape == ((3, 24, 24) if threshold == "list" else (24, 24))


@pytest.mark.parametrize("n,frac,seed", [(10, 0.2, 42), (7, 0.2, 42),
                                         (33, 0.3, 0)])
def test_seeded_split_matches_jax(n, frac, seed):
    for got, want in zip(pds.seeded_split(n, frac, seed),
                         jds.seeded_split(n, frac, seed)):
        np.testing.assert_array_equal(got, want)
    sub_g = pds.Subset(list(range(100, 100 + n)), [2, 0])
    sub_w = jds.Subset(list(range(100, 100 + n)), [2, 0])
    assert [sub_g[i] for i in range(2)] == [sub_w[i] for i in range(2)]


class _Items:
    """((a, b), y) samples; item ``fail_at`` raises."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"bad item {i}")
        a = np.full((2, 2, 3), i, np.float32)
        return (a, -a), np.float32(i)


def _drain(loader):
    return [(((a.copy(), b.copy()), y.copy()), m.copy())
            for ((a, b), y), m in loader]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_loader_matches_jax(shuffle, drop_last):
    """Batches of two epochs: the order (epoch e shuffled with seed + e),
    the last batch padded by repeating its last row with a mask, or
    dropped; the peek before them consumes no epoch."""
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, num_workers=2,
              prefetch=1, drop_last=drop_last)
    got, want = pld.Loader(_Items(10), **kw), jld.Loader(_Items(10), **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    peek_g = pld.peek_first_batch(got)
    _same_batch(peek_g, jld.peek_first_batch(want))
    for _ in range(2):
        bg, bw = _drain(got), _drain(want)
        assert len(bg) == len(bw) == len(got)
        for x, y in zip(bg, bw):
            _same_batch(x, y)
    if not drop_last:
        ((a, _), y), mask = bg[-1]
        np.testing.assert_array_equal(mask, [1, 1, 0, 0])
        np.testing.assert_array_equal(y[2:], [y[1], y[1]])
    if shuffle:  # the peek did not burn seed + 0
        first = np.arange(10)
        np.random.default_rng(3).shuffle(first)
        ((_, _), y0), _ = _drain(pld.Loader(_Items(10), **kw))[0]
        np.testing.assert_array_equal(y0, first[:4])


def _same_batch(got, want):
    (((ga, gb), gy), gm), (((wa, wb), wy), wm) = got, want
    for g, w in ((ga, wa), (gb, wb), (gy, wy), (gm, wm)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_collate_and_pad_match_jax():
    samples = [_Items(5)[i] for i in range(3)]
    _same_batch(pld.pad_batch(pld.collate(samples), 5),
                jld.pad_batch(jld.collate(samples), 5))
    _same_batch(pld.pad_batch(pld.collate(samples), 3),
                jld.pad_batch(jld.collate(samples), 3))


def test_loader_error_reaches_the_consumer():
    """A dataset error is raised in the consuming thread, in both, after
    the batches before it."""
    for mod in (pld, jld):
        loader = mod.Loader(_Items(9, fail_at=5), batch_size=2, num_workers=2)
        seen = []
        with pytest.raises(KeyError, match="bad item 5"):
            for batch in loader:
                seen.append(batch)
        assert len(seen) == 2


def test_resize_bilinear_np_matches_jax_kernel(np_rng):
    """Ranks 2 and 4, both align_corners conventions, up and down."""
    cases = (((8, 12), (32, 48)), ((13, 9), (7, 5)), ((4, 4), (9, 9)))
    for ac in (False, True):
        for in_hw, out_hw in cases:
            for shape in (in_hw, (2,) + in_hw + (3,)):
                x = np_rng.standard_normal(shape).astype(np.float32)
                got = resize_bilinear_np(x, out_hw, align_corners=ac)
                np.testing.assert_allclose(
                    got, np.asarray(resize_bilinear(x, out_hw,
                                                    align_corners=ac)),
                    rtol=1e-5, atol=1e-6)
                assert got.dtype == np.float32
    same = np_rng.standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_array_equal(resize_bilinear_np(same, (5, 6)), same)


@pytest.mark.parametrize("pred,target", [
    ([0.1, 0.5, 0.3, 0.9], [0.2, 0.4, 0.4, 1.0]),
    ([1.0, 1.0, 2.0, 3.0, 3.0], [5.0, 4.0, 4.0, 1.0, 2.0]),
    ([1.0, 1.0], [2.0, 2.0]),
    ([0.3], [0.1]),
], ids=["plain", "ties", "constant", "single"])
def test_metrics_match_jax(pred, target):
    assert pmetrics.mse(pred, target) == jmetrics.mse(pred, target)
    got, want = pmetrics.srcc(pred, target), jmetrics.srcc(pred, target)
    assert (np.isnan(got) and np.isnan(want)) or got == want
