"""The port's ``convert`` command (srsem_torch/cli/main.py, the producers in
srsem_torch/utils/convert.py) against the JAX CLI's ``srsem convert`` on
the same torch files: for every ported kind the same bytes (a msgpack tower
file, or a checkpoint directory for the head and decoder kinds); every
kind not ported yet raises, naming its ROADMAP item.  And ``serve
--backbone vit_clip --head stages_vit`` over stdio on the CPU, its scores
against the grouped scorer's in process on the same seeded model.
"""

import json
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
from srsem_torch.cli.main import UNPORTED_CONVERT_KINDS
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.eval.grouped import GroupedPairScorer
from srsem_torch.models.global_models import TokenHeadAggregator, make_global_model
from srsem_torch.models.local_models import make_local_model
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_vit import _hf_state_dict, _timm_state_dict

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
                                  "global_head_shared", "clu_decoder"])
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


def test_unported_kinds_name_their_item(tmp_path):
    src = tmp_path / "in.pt"
    torch.save({"w": torch.zeros(1)}, src)
    assert UNPORTED_CONVERT_KINDS == {
        "slip": "A12", "albef": "A12", "albef_fusion": "A12",
        "transalnet": "A12"}
    for kind, item in UNPORTED_CONVERT_KINDS.items():
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            port_main(["convert", str(src), "--kind", kind, "--out",
                       str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        port_main(["convert", str(src), "--kind", "resnet50",
                   "--image-size", "0"])


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
