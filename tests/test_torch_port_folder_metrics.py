"""srsem_torch/eval/folder_metrics.py and the port's ``folder-metrics`` /
``train-nr-iqa`` commands against the JAX package's on the same folders:
SSIM/PSNR at 1e-5 and LPIPS at rtol 2e-4 on the same LPIPS weights, a
batched no-reference backend riding the decoded eval batch (normalized on
the device), native-resolution buckets with a GT/eval shape mismatch (only
the FR columns NaN) and a corrupt file (a NaN row), decode windows that
change no row, the resume check on a CSV the JAX package wrote, and the
numeric-stem difference: pandas reads ``0001`` as 1, so the JAX package
recomputes where the port resumes; the pyramid LPIPS on JAX's tower at
bf16's tolerance."""

import csv
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.backbones.resnet import ImageNetResNet50 as JaxImageNet
from srsem.cli.main import main as jax_main
from srsem.eval.folder_metrics import ImageQualityMetrics as JaxMetrics
from srsem.eval.folder_metrics import make_pyramid_lpips as jax_pyramid
from srsem.eval.folder_metrics import process_image_folders as jax_process
from srsem.eval.lpips import convert_lpips as jax_convert_lpips
from srsem_torch.cli.main import main as port_main
from srsem_torch.eval.folder_metrics import (
    CSV_COLUMNS,
    KONIQPP_COLUMNS,
    ImageQualityMetrics,
    make_pyramid_lpips,
    process_image_folders,
    read_metrics_csv,
)
from srsem_torch.backbones.resnet import ImageNetResNet50
from srsem_torch.eval.lpips import LPIPS
from srsem_torch.utils.convert import load_backbone_params
from test_torch_port_train import _two_threads  # noqa: F401 — fixture


def _save(path, arr):
    Image.fromarray(arr).save(path)


def _folders(tmp_path, sizes, seed=0, names=None):
    """GT and eval folders of noisy pairs, one (h, w) or ((h, w), (h2,
    w2)) a pair; returns (gt_dir, ev_dir, stems)."""
    rng = np.random.default_rng(seed)
    gt, ev = tmp_path / "gt", tmp_path / "ev"
    gt.mkdir(exist_ok=True)
    ev.mkdir(exist_ok=True)
    names = names or [f"img{i}" for i in range(len(sizes))]
    for name, size in zip(names, sizes):
        g_hw, e_hw = size if isinstance(size[0], tuple) else (size, size)
        g = rng.integers(0, 255, g_hw + (3,), dtype=np.uint8)
        e = (np.clip(g.astype(int) + rng.integers(-25, 25, g.shape), 0, 255)
             .astype(np.uint8) if g_hw == e_hw
             else rng.integers(0, 255, e_hw + (3,), dtype=np.uint8))
        _save(gt / f"{name}.png", g)
        _save(ev / f"{name}.png", e)
    return gt, ev, names


class MeanNR:
    """A batched NR backend: per-channel means of the normalized batch and
    their sum (the same on either package's arrays)."""

    def batch(self, x):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        m = x.mean(axis=(1, 2))
        return np.concatenate([m, m.sum(-1, keepdims=True),
                               m[:, :1] * 2], axis=-1)


@pytest.fixture(scope="module")
def lpips_params():
    model = LPIPS("alex").reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    return jax_convert_lpips({k: v.abs() for k, v in sd.items()
                              if k.startswith("lin")}, sd)


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for col, tol in (("SSIM", 1e-5), ("PSNR", 1e-5), ("LPIPS", 2e-4),
                         *((c, 1e-5) for c in KONIQPP_COLUMNS)):
            np.testing.assert_allclose(g[col], w[col], rtol=tol, atol=tol,
                                       equal_nan=True, err_msg=col)


def test_batch_matches_jax_native_resolution(tmp_path, lpips_params):
    """Two sizes of pairs (two shape buckets), a GT/eval mismatch (FR NaN,
    NR scored), a corrupt eval file (all NaN), at native resolution."""
    gt, ev, names = _folders(tmp_path, [(48, 40), (48, 40), (32, 32),
                                        ((32, 32), (48, 40)), (32, 32)])
    (ev / "img4.png").write_bytes(b"not a png")
    gps = [str(gt / f"{n}.png") for n in names]
    eps = [str(ev / f"{n}.png") for n in names]
    want = JaxMetrics(image_size=None, batch_size=2, koniqpp=MeanNR(),
                      lpips_params=lpips_params).batch(gps, eps)
    calc = ImageQualityMetrics(image_size=None, batch_size=2, koniqpp=MeanNR(),
                               lpips_params=lpips_params, device="cpu")
    got = calc.batch(gps, eps)
    _assert_rows(got, want)
    assert math.isnan(got[3]["SSIM"]) and np.isfinite(got[3]["Koniq++IQA"])
    assert all(math.isnan(v) for v in got[4].values())
    _assert_rows(calc.batch(gps, eps, decode_chunk=2), got)


def test_pyramid_lpips_shapes_and_zero():
    """The pyramid distance: zero on identical pairs, positive otherwise,
    one value a pair (the seeded random tower is the port's own)."""
    fn = make_pyramid_lpips(device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fn(x, x), torch.zeros(2))
    d = fn(x, x.flip(1))
    assert d.shape == (2,) and bool((d > 0).all())


def test_pyramid_lpips_matches_jax():
    """The pyramid distance on JAX's own tower: the port's tower loaded
    from ``ImageNetResNet50(bfloat16).init(PRNGKey(0), ...)`` (the init
    the JAX package's ``make_pyramid_lpips`` draws), four 64 px pairs from
    identical to heavy noise, against the JAX package's function.  Both
    compute in bf16 and round at different points (the port folds BN into
    the convs), so the tolerance is a few bf16 ulps (2^-8) of each
    value."""
    variables = jax.jit(JaxImageNet(dtype=jnp.bfloat16).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tower = load_backbone_params(ImageNetResNet50(torch.bfloat16), "resnet50",
                                 jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    sigma = np.array([0.0, 0.02, 0.1, 0.3], np.float32)[:, None, None, None]
    ev = np.clip(gt + sigma * rng.normal(size=gt.shape), 0, 1).astype(
        np.float32)
    want = np.asarray(jax_pyramid(image_size=64)(jnp.asarray(gt),
                                                 jnp.asarray(ev)))
    got = make_pyramid_lpips(tower, device="cpu")(torch.from_numpy(gt),
                                                  torch.from_numpy(ev))
    assert want[0] == 0 and (want[1:] > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-9)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_resume_jax_csv_and_numeric_stems(tmp_path, lpips_params,
                                          monkeypatch):
    """A metrics.csv the JAX package wrote resumes in the port untouched;
    with stems ``0001``/``0002`` JAX's pandas reads the names as integers
    and recomputes, while the port resumes."""
    for names, jax_resumes in ((["a", "b"], True), (["0001", "0002"], False)):
        root = tmp_path / names[0]
        root.mkdir()
        gt, ev, _ = _folders(root, [(32, 32)] * 2, names=names)
        out = str(root / "metrics.csv")
        jcalc = JaxMetrics(image_size=32, batch_size=2,
                           lpips_params=lpips_params)
        jax_process(jcalc, str(gt), str(ev), out)
        written = (root / "metrics.csv").read_text()
        assert _read(out)[0].keys() == set(CSV_COLUMNS)

        calls = []
        monkeypatch.setattr(JaxMetrics, "batch",
                            lambda self, *a, **k: calls.append(1) or [
                                {c: 0.0 for c in ("SSIM", "PSNR", "LPIPS")}
                                for _ in a[0]])
        jax_process(jcalc, str(gt), str(ev), out)
        assert (not calls) == jax_resumes
        (root / "metrics.csv").write_text(written)

        calc = ImageQualityMetrics(image_size=32, batch_size=2,
                                   lpips_params=lpips_params, device="cpu")
        monkeypatch.setattr(calc, "batch", lambda *a, **k: pytest.fail(
            "the port recomputed a complete metrics.csv"))
        rows = process_image_folders(calc, str(gt), str(ev), out)
        assert [r["image_name"] for r in rows] == names
        assert rows == read_metrics_csv(out)
        assert (root / "metrics.csv").read_text() == written
        monkeypatch.undo()


def test_cli_folder_metrics_and_nr_training(tmp_path, capsys):
    """``train-nr-iqa`` (64 px) then ``folder-metrics
    --koniqpp-checkpoint`` on a folder pair with a size mismatch (resized
    to 224 like every image) and a corrupt eval file, with the official
    lpips and torchvision ``.pth`` files; SSIM, PSNR and LPIPS against
    ``srsem folder-metrics`` on the same folders and files; a JAX-written
    NR-IQA checkpoint raises."""
    gt, ev, names = _folders(tmp_path, [(40, 40), ((48, 40), (40, 48)),
                                        (40, 40)], seed=1)
    (ev / "img2.png").write_bytes(b"corrupt")
    sd = LPIPS("alex").reset_parameters(
        torch.Generator().manual_seed(1)).state_dict()
    torch.save({k: v.abs() for k, v in sd.items() if k.startswith("lin")},
               tmp_path / "lin.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")},
               tmp_path / "alexnet.pth")
    lpips = ["--lpips-checkpoint", str(tmp_path / "lin.pth"),
             "--lpips-tower", str(tmp_path / "alexnet.pth")]
    ck = tmp_path / "nr"
    assert port_main(["train-nr-iqa", str(gt), "--checkpoint-dir", str(ck),
                      "--epochs", "1", "--batch-size", "2", "--image-size",
                      "64", "--device", "cpu"]) == 0
    trained = json.loads(capsys.readouterr().out)
    assert trained["steps"] == 1 and np.isfinite(trained["val_mse"])

    assert port_main(["folder-metrics", str(gt), str(ev), "--batch-size", "2",
                      "--koniqpp-checkpoint", str(ck), "--device", "cpu",
                      *lpips]) == 0
    port_rows = read_metrics_csv(str(ev / "metrics.csv"))
    assert [r["image_name"] for r in port_rows] == names
    assert all(np.isfinite(r[c]) for r in port_rows[:2]
               for c in ("SSIM", "PSNR", "LPIPS", *KONIQPP_COLUMNS))
    assert all(math.isnan(v) for k, v in port_rows[2].items()
               if k in ("SSIM", *KONIQPP_COLUMNS))

    (ev / "metrics.csv").rename(tmp_path / "port.csv")
    assert jax_main(["folder-metrics", str(gt), str(ev), "--batch-size",
                     "2", *lpips]) == 0
    jax_rows = read_metrics_csv(str(ev / "metrics.csv"))
    for g, w in zip(port_rows, jax_rows):
        for col, tol in (("SSIM", 1e-5), ("PSNR", 1e-5), ("LPIPS", 2e-4)):
            np.testing.assert_allclose(g[col], w[col], rtol=tol, atol=tol,
                                       equal_nan=True)

    from srsem.train.checkpoint import save_checkpoint as jax_save

    jax_save(str(tmp_path / "jax_nr"), 1, {"trainable": {},
                                           "tower_seed": np.int32(0)})
    with pytest.raises(ValueError, match="JAX package"):
        port_main(["folder-metrics", str(gt), str(ev), "--koniqpp-checkpoint",
                   str(tmp_path / "jax_nr"), "--device", "cpu"])
