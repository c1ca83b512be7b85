"""The port's main path (srsem_torch/eval/scorer.py::PairScorer) vs the
JAX kernel path, plus decode, NaN rows, the CLI and import hygiene.

Slice parity: the JAX main path composed from its own functions —
Preprocess.device_normalize → fused_apply("resnet50", fuse_stages=(0,1,2,3),
interpret=True) → fused_global_score(interpret=True) — against the port's
``PairScorer(device="cpu").score_arrays`` on the same weights and uint8
inputs.  f32, 64 px, batch 2, depth 3; tolerance 1e-3, the JAX package's
own tolerance over the 16-block tower (tests/test_fused_bottleneck.py).
"""

import ast
import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.backbones.fused_resnet import fused_apply as jax_fused_apply
from srsem.data.preprocess import Preprocess as JaxPreprocess
from srsem.ops.fused_head import fused_global_score as jax_fused_global_score
from srsem.utils.convert import convert_global_head, convert_torch_resnet50
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import make_global_model, stage_taps_for
from srsem_torch.utils.convert import load_jax_global_params
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]
CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=64, compute_dtype="float32"), depth=3)


def _jax_variables(seed):
    """JAX GlobalPairScorer variables (numpy) from a seeded port model:
    random frozen BN (small gammas closing each residual branch keep the
    activations O(1)), nonnegative head weights scaled so the squared-diff
    term (not the bias) carries each score, and biases pushed +1 so the
    final ReLU passes every score."""
    model = make_global_model(CFG, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name, m in model.backbone.named_modules():
        if isinstance(m, FrozenBatchNorm):
            c = m.weight.shape[0]
            closing = name.endswith(("bn3", "downsample.1"))
            m.weight.copy_(torch.tensor(rng.uniform(0.1, 0.3, c) if closing
                                        else rng.uniform(0.5, 1.5, c)))
            m.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    head = convert_global_head(model.aggregator.state_dict())["aggregator"]
    head = {k: {"kernel": np.abs(v["kernel"]) * 100.0, "bias": v["bias"] + 1.0}
            for k, v in head.items()}
    return {"params": {
        "backbone": convert_torch_resnet50(model.backbone.state_dict()),
        "aggregator": head}}


@pytest.fixture(scope="module")
def port_model():
    return load_jax_global_params(make_global_model(CFG), _jax_variables(0))


def test_slice_matches_jax_kernel_path():
    variables = _jax_variables(0)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)

    pre = JaxPreprocess.for_backbone("resnet50", 64)
    bp = jax.tree.map(jnp.asarray, variables["params"]["backbone"])
    _, taps_a = jax_fused_apply("resnet50", bp, pre.device_normalize(jnp.asarray(a)),
                                jnp.float32, interpret=True,
                                fuse_stages=(0, 1, 2, 3))
    _, taps_b = jax_fused_apply("resnet50", bp, pre.device_normalize(jnp.asarray(b)),
                                jnp.float32, interpret=True,
                                fuse_stages=(0, 1, 2, 3))
    want = np.asarray(jax_fused_global_score(
        taps_a, taps_b, variables["params"]["aggregator"],
        stage_taps_for("resnet50", 3), interpret=True))
    assert (want > 0).all()

    port = load_jax_global_params(make_global_model(CFG), variables)
    got = PairScorer(CFG, port, batch_size=2, device="cpu").score_arrays(a, b)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_plain_tower_scorer_matches_fused(port_model):
    """fused_tower=False (the module's F.conv2d chain) == the kernel path."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    fused = PairScorer(CFG, port_model, device="cpu").score_arrays(a, b)
    plain = PairScorer(CFG, port_model, device="cpu",
                       fused_tower=False).score_arrays(a, b)
    with torch.inference_mode():
        module = port_model(Preprocess.for_backbone("resnet50", 64)
                            .device_normalize(torch.tensor(a)),
                            Preprocess.for_backbone("resnet50", 64)
                            .device_normalize(torch.tensor(b)))
    torch.testing.assert_close(fused, plain, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(plain, module, rtol=1e-5, atol=1e-5)


def _image_bytes(rng, size, fmt):
    img = Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("size", [(80, 120), (150, 96), (64, 64)])
def test_decode_uint8_bit_equal(tmp_path, fmt, size):
    path = tmp_path / f"img.{fmt.lower()}"
    path.write_bytes(_image_bytes(np.random.default_rng(1), size, fmt))
    for kind in ("resnet50", "resnet50_clip"):
        want = JaxPreprocess.for_backbone(kind, 64).decode_uint8(str(path))
        port = Preprocess.for_backbone(kind, 64)
        got = port.decode_uint8(str(path))
        assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)
        normalized = port.device_normalize(torch.tensor(got[None]))[0]
        np.testing.assert_allclose(normalized.numpy(), port(str(path)),
                                   rtol=1e-6, atol=1e-6)


def _write_pairs(root: Path, n: int):
    rng = np.random.default_rng(2)
    pairs = []
    for i in range(n):
        pa, pb = root / f"gt{i}.png", root / f"sr{i}.jpg"
        pa.write_bytes(_image_bytes(rng, (72, 90), "PNG"))
        pb.write_bytes(_image_bytes(rng, (90, 72), "JPEG"))
        pairs.append((str(pa), str(pb)))
    bad = root / "corrupt.png"
    bad.write_bytes(b"not an image")
    pairs[1] = (pairs[1][0], str(bad))
    return pairs


def test_score_paths_nan_row_for_corrupt_file(tmp_path, port_model):
    pairs = _write_pairs(tmp_path, 5)
    scorer = PairScorer(CFG, port_model, batch_size=2, num_workers=2,
                        device="cpu")
    scores = scorer.score_paths(pairs)
    assert scores.shape == (5,) and scores.dtype == np.float32
    assert np.isnan(scores[1])
    assert np.isfinite(np.delete(scores, 1)).all()
    assert (np.delete(scores, 1) > 0).all()
    assert scorer.score_paths([]).shape == (0,)


def test_cli_score_writes_csv(tmp_path):
    pairs = _write_pairs(tmp_path, 3)
    csv_path = tmp_path / "pairs.csv"
    csv_path.write_text("img_a_pth,img_b_pth\n"
                        + "".join(f"{a},{b}\n" for a, b in pairs))
    out = tmp_path / "scores.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "score", str(csv_path),
         "--device", "cpu", "--batch-size", "2", "--out", str(out),
         "--set", "backbone.image_size=64",
         "--set", "backbone.compute_dtype=float32"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"nan": 1' in proc.stdout and '"device": "cpu"' in proc.stdout
    lines = out.read_text().splitlines()
    assert lines[0] == "img_a_pth,img_b_pth,score" and len(lines) == 4
    assert lines[2].endswith(",nan")


def test_entry_points_refuse_cpu_fallback(port_model):
    """Without a card, asking for CUDA raises instead of running on CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PairScorer(CFG, port_model)
    with pytest.raises(ValueError, match="decode_backend"):
        PairScorer(CFG, port_model, decode_backend="opencv", device="cpu")


_FORBIDDEN = ("jax", "flax", "msgpack", "srsem")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield str(node.args[0].value).split(".")[0]


def test_import_hygiene():
    """srsem_torch and chip_smoke.py never import jax, flax, msgpack or
    srsem."""
    sources = sorted((REPO / "srsem_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        bad = set(_imported_roots(path)) & set(_FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in sources[:-1] if p.name != "__main__.py"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
