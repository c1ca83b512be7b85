"""``python -m srsem_torch visualize`` against the JAX CLI's ``visualize``
(srsem/cli/main.py:839-903) on the same inputs: the overlay's pixels equal
(a .npy map in [0, 1], an out-of-range .pkl cosine map rescaled, and
``--normalize``), the grid, heatmap and SpLiCE bar images of the same
size; the errors for a missing flag, a non-2-D map and a bad extension;
and after the command neither ``jax`` in ``sys.modules`` nor CUDA
initialized."""

import json
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from srsem.cli.main import main as jax_main
from srsem_torch.cli.main import main as port_main
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]


def _port(*args):
    return subprocess.run([sys.executable, "-m", "srsem_torch", "visualize",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)).save(
        root / "sr.png")
    np.save(root / "map.npy", rng.random((8, 12), dtype=np.float32))
    with open(root / "cos.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(1, 8, 12)).astype(np.float32), f)
    np.save(root / "sim.npy", rng.random((3, 3), dtype=np.float32))
    (root / "w.json").write_text(json.dumps({"dog": 0.5, "cat": -0.2,
                                             "sky": 0.9}))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _kinds(r, out):
    img = str(r / "sr.png")
    return {
        "overlay": ["overlay", "--image", img, "--map", str(r / "map.npy"),
                    "--out", out],
        "overlay_pkl": ["overlay", "--image", img, "--map",
                        str(r / "cos.pkl"), "--alpha", "0.3", "--out", out],
        "overlay_normalize": ["overlay", "--image", img, "--map",
                              str(r / "map.npy"), "--normalize", "--out",
                              out],
        "grid": ["grid", "--images", img, img, img, "--titles", "GT", "SR-a",
                 "SR-b", "--cols", "3", "--out", out],
        "heatmap": ["heatmap", "--matrix", str(r / "sim.npy"), "--labels",
                    "a", "b", "c", "--title", "sim", "--out", out],
        "splice": ["splice", "--json", str(r / "w.json"), "--top", "2",
                   "--out", out],
    }


@pytest.mark.parametrize("kind", ["overlay", "overlay_pkl",
                                  "overlay_normalize", "grid", "heatmap",
                                  "splice"])
def test_visualize_matches_jax(inputs, kind):
    port_out = str(inputs / f"port_{kind}.png")
    jax_out = str(inputs / f"jax_{kind}.png")
    res = _port(*_kinds(inputs, port_out)[kind])
    assert res.returncode == 0, res.stderr
    argv = _kinds(inputs, jax_out)[kind]
    assert json.loads(res.stdout) == {"kind": argv[0], "out": port_out}
    assert jax_main(["visualize", *argv]) == 0
    got, want = (np.asarray(Image.open(p)) for p in (port_out, jax_out))
    if kind.startswith("overlay"):
        assert got.shape == (32, 48, 3)
        np.testing.assert_array_equal(got, want)
    else:
        assert got.shape == want.shape
    if kind == "overlay_pkl":  # the rescale is announced
        assert "min-max rescaling" in res.stderr


def test_visualize_errors(inputs, tmp_path):
    img = str(inputs / "sr.png")
    with pytest.raises(SystemExit, match="--map is required"):
        port_main(["visualize", "overlay", "--image", img, "--out",
                   str(tmp_path / "x.png")])
    np.save(tmp_path / "cube.npy", np.zeros((2, 3, 4), np.float32))
    with pytest.raises(SystemExit, match="expected a 2-D map"):
        port_main(["visualize", "overlay", "--image", img, "--map",
                   str(tmp_path / "cube.npy"), "--out",
                   str(tmp_path / "x.png")])
    (tmp_path / "m.txt").write_text("0")
    with pytest.raises(SystemExit, match="unsupported extension"):
        port_main(["visualize", "heatmap", "--matrix",
                   str(tmp_path / "m.txt"), "--out", str(tmp_path / "x.png")])
    res = _port("grid", "--out", str(tmp_path / "x.png"))
    assert res.returncode != 0 and "--images is required" in res.stderr


def test_visualize_touches_no_device(inputs, tmp_path):
    """After a visualize run in a fresh interpreter: no jax module loaded,
    CUDA not initialized (a plotting command never claims a card)."""
    code = (
        "import json, sys\n"
        "from srsem_torch.cli.main import main\n"
        f"main(['visualize', 'overlay', '--image', {str(inputs / 'sr.png')!r},"
        f" '--map', {str(inputs / 'map.npy')!r}, '--out',"
        f" {str(tmp_path / 'o.png')!r}])\n"
        "torch = sys.modules.get('torch')\n"
        "print(json.dumps({'jax': 'jax' in sys.modules, 'cuda':"
        " bool(torch and torch.cuda.is_initialized())}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "jax": False, "cuda": False}
