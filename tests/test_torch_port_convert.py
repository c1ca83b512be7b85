"""The port's ``convert`` command (srsem_torch/cli/main.py, the producers in
srsem_torch/utils/convert.py) against the JAX CLI's ``srsem convert`` on
the same torch files: the same bytes (a msgpack tree file, or a checkpoint
directory for the head and decoder kinds), the four kinds of the saliency
and dual-encoder slice among them.  ``saliency`` against the JAX CLI's on
a converted TranSalNet checkpoint (the same files and meta marker, maps
within 1e-4, the same JSON line), and with ``--random-init``.  And
``serve --backbone vit_clip --head stages_vit`` over stdio on the CPU, its
scores against the grouped scorer's in process on the same seeded model.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from srsem.cli.main import main as jax_main
from srsem_torch.backbones.resnet import make_backbone
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.eval.grouped import GroupedPairScorer
from srsem_torch.models.global_models import TokenHeadAggregator, make_global_model
from srsem_torch.models.local_models import make_local_model
from srsem_torch.pseudo.clip_text import ClipTextEncoder
from test_albef_convert import TorchDeit, _albef_checkpoint
from test_fusion import TorchFusionBert
from test_fusion import _state_dict as fusion_state_dict
from test_torch_port_saliency import mirror_state_dict as transalnet_state_dict
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_vit import _hf_state_dict, _timm_state_dict
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]


def _randomized(module: torch.nn.Module, seed: int):
    """``module``'s state dict with every floating tensor redrawn (so BN
    statistics, biases and LayerNorms are not their init values)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) * 0.1 if v.is_floating_point()
                else v) for k, v in module.state_dict().items()}


def _inputs(kind: str):
    """A torch state dict of the layout ``kind`` reads, and extra flags."""
    if kind == "resnet50":
        sd = _randomized(make_backbone(BackboneConfig(kind="resnet50")), 0)
        sd["fc.weight"] = torch.zeros(10, 2048)
        return sd, []
    if kind == "resnet50_clip":
        tower = make_backbone(BackboneConfig(kind="resnet50_clip"))
        return {f"visual.{k}": v for k, v in _randomized(tower, 1).items()}, []
    if kind == "clip_vit":
        return _timm_state_dict(2), []
    if kind == "hf_clip_vit":
        return _hf_state_dict(3), []
    if kind == "slip":
        g = torch.Generator().manual_seed(8)
        sd = {f"visual.{k}": v for k, v in _timm_state_dict(7).items()}
        sd.update(ClipTextEncoder(vocab_size=100, width=64, layers=2,
                                  heads=4, context=16, embed_dim=24)
                  .reset_parameters(g).state_dict())
        sd["image_projection"] = torch.randn(96, 24, generator=g)
        return sd, []
    if kind == "albef":  # grid 4 at patch 8 → 6: the bicubic table
        torch.manual_seed(9)
        return (_albef_checkpoint(None, TorchDeit(grid=4).eval())[0],
                ["--image-size", "48", "--patch", "8"])
    if kind == "albef_fusion":  # a retrieval checkpoint: the ITM head too
        torch.manual_seed(10)
        sd, itm = fusion_state_dict(TorchFusionBert())
        return {**{f"text_encoder.bert.{k}": v for k, v in sd.items()},
                **{f"itm_head.{k}": v for k, v in itm.items()},
                "visual_encoder.cls_token": torch.zeros(1, 1, 8)}, []
    if kind == "transalnet":
        return transalnet_state_dict(), []
    if kind in ("global_head", "global_head_shared"):
        head = TokenHeadAggregator(96, 3, shared=kind.endswith("shared"))
        head.reset_parameters(torch.Generator().manual_seed(4))
        return head.state_dict(), (["--shared-head"]
                                   if kind.endswith("shared") else [])
    model = make_local_model(LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=64)), width_mult=0.125)
    return _randomized(model.decoder, 5), []


@pytest.mark.parametrize("kind", ["resnet50", "resnet50_clip", "clip_vit",
                                  "hf_clip_vit", "global_head",
                                  "global_head_shared", "clu_decoder",
                                  "slip", "albef", "albef_fusion",
                                  "transalnet"])
def test_convert_writes_jax_bytes(kind, capsys):
    """The files go to a directory removed at the end: a full ResNet-50's
    input and outputs are about 0.45 GB."""
    sd, flags = _inputs(kind)
    cli_kind = kind.replace("_shared", "")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "in.pt"
        torch.save(sd, src)
        out = {}
        for name, main in (("jax", jax_main), ("port", port_main)):
            dst = Path(tmp) / name
            assert main(["convert", str(src), "--kind", cli_kind, "--out",
                         str(dst), *flags]) == 0
            line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            # The tower kinds write a file, the head and decoder kinds a
            # checkpoint directory.
            assert dst.is_dir() == (cli_kind in ("global_head", "clu_decoder"))
            out[name] = (line["n_arrays"], (
                dst / "step_0.msgpack" if dst.is_dir() else dst).read_bytes())
    assert out["port"] == out["jax"]


def test_convert_rejects_nonpositive_image_size(tmp_path):
    src = tmp_path / "in.pt"
    torch.save({"w": torch.zeros(1)}, src)
    for kind in ("resnet50", "albef"):
        with pytest.raises(SystemExit):
            port_main(["convert", str(src), "--kind", kind,
                       "--image-size", "0"])


def test_cli_saliency_matches_jax(tmp_path, capsys):
    """``convert --kind transalnet`` then ``saliency --checkpoint`` at 64 x
    64 over two images of mixed aspect (one a dotted stem), in the JAX CLI
    and in the port's: the same JSON line, file names and meta marker,
    maps within 1e-4.  ``--random-init`` (the port's seeded draw) writes
    source-shaped maps in [0, 1]; neither flag exits."""
    src, ckpt = tmp_path / "t.pt", tmp_path / "t.msgpack"
    torch.save(transalnet_state_dict(), src)
    assert port_main(["convert", str(src), "--kind", "transalnet", "--out",
                      str(ckpt)]) == 0
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(3)
    for name, hw in (("wide.png", (30, 70)), ("b.v2.jpg", (70, 30))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            imgs / name)
    out = tmp_path / "SaliencyMaps"
    argv = ["saliency", "--images", str(imgs), "--out", str(out),
            "--height", "64", "--width", "64"]
    capsys.readouterr()
    runs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        assert main(argv + ["--checkpoint", str(ckpt)] + extra) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[name] = (line, {p.name: p.read_bytes() if p.suffix == ".json"
                             else np.load(p) for p in out.iterdir()})
        shutil.rmtree(out)
    assert runs["port"][0] == runs["jax"][0] == {
        "images_dir": str(imgs), "out": str(out), "written": 2}
    got, want = runs["port"][1], runs["jax"][1]
    assert sorted(got) == sorted(want) == [
        ".srsem_saliency_meta.json", "b.v2.npy", "wide.npy"]
    meta = ".srsem_saliency_meta.json"
    assert got[meta] == want[meta]
    for name in ("b.v2.npy", "wide.npy"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert got["wide.npy"].shape == (30, 70)

    assert port_main(argv + ["--random-init", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["written"] == 2
    for name, hw in (("wide.npy", (30, 70)), ("b.v2.npy", (70, 30))):
        sal = np.load(out / name)
        assert sal.shape == hw and 0 <= sal.min() and sal.max() <= 1
    with pytest.raises(SystemExit, match="--random-init"):
        port_main(argv + ["--device", "cpu"])


def test_converted_vit_scores_through_backbone_checkpoint(tmp_path, capsys):
    """``convert --kind clip_vit`` then ``score --backbone vit_clip
    --backbone-checkpoint``: the converted tower loads into the port's
    ViT with the timm file's weights, bit for bit."""
    from srsem_torch.cli.main import _load_backbone

    sd = _timm_state_dict(6)
    src, dst = tmp_path / "vit.pt", tmp_path / "vit.msgpack"
    torch.save(sd, src)
    assert port_main(["convert", str(src), "--kind", "clip_vit", "--out",
                      str(dst)]) == 0
    capsys.readouterr()
    vit = make_backbone(BackboneConfig(kind="vit_clip", vit_width=96,
                                       vit_depth=4, vit_heads=4))
    _load_backbone(vit, "vit_clip", dst)
    for k, v in vit.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_cli_serve_vit_stdio(tmp_path):
    """``serve --backbone vit_clip --head stages_vit --device cpu`` over
    stdio (full-width ViT-B/16 at 32 px, float32, seeded weights): a K = 2
    request's scores equal GroupedPairScorer's on the same seeded model."""
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    paths = {"gt": tmp_path / "gt.png"}
    Image.fromarray(gt).save(paths["gt"])
    for i, name in enumerate(("a", "b")):
        noise = rng.integers(-30 * (i + 1), 30 * (i + 1) + 1, gt.shape)
        paths[name] = tmp_path / f"sr_{name}.png"
        Image.fromarray(np.clip(gt + noise, 0, 255).astype(np.uint8)).save(
            paths[name])
    script = "".join(json.dumps(r) + "\n" for r in (
        {"id": 1, "gt": str(paths["gt"]), "sr": [str(paths["a"]),
                                                 str(paths["b"])]},
        {"cmd": "shutdown"}))
    proc = subprocess.run(
        [sys.executable, "-m", "srsem_torch", "serve", "--device", "cpu",
         "--backbone", "vit_clip", "--head", "stages_vit", "--image-size",
         "32", "--dtype", "float32", "--warmup-k", "2", "--group-batch", "1"],
        input=script, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    resps = [json.loads(line) for line in proc.stdout.splitlines()]
    assert resps[0]["id"] == 1 and len(resps[0]["scores"]) == 2
    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="vit_clip", image_size=32, compute_dtype="float32"),
        head="stages_vit", depth=3)
    scorer = GroupedPairScorer(cfg, make_global_model(
        cfg, torch.Generator().manual_seed(0)), k=2, batch_size=1,
        device="cpu")
    dec = scorer.preprocess.decode_uint8
    want = scorer.score_arrays(
        dec(str(paths["gt"]))[None],
        np.stack([dec(str(paths["a"])), dec(str(paths["b"]))])[None])
    np.testing.assert_allclose(resps[0]["scores"], want[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert resps[1] == {"ok": True, "shutdown": True}
