"""The port's text stack against the JAX package's on the same weights and
tokens, a 2-layer, width-64 tower on tiny vocabulary files: the copied
tokenizers (WordPiece, CLIP byte-BPE) token for token, MiniLM (both pools,
and the embedder's static padded batches) and the CLIP text tower at
1e-4 (tests/test_text_parity.py's tolerances), and ``convert`` for the
four kinds this slice ports (``lpips``, ``hf_clip_text``, ``clip_text``,
``minilm``): the bytes ``srsem convert`` writes."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.cli.main import main as jax_main
from srsem.pseudo.clip_text import ClipTextEncoder as JaxClipText
from srsem.pseudo.text_embed import MiniLMEncoder as JaxMiniLM
from srsem.pseudo.text_embed import convert_hf_minilm as jax_convert_minilm
from srsem.pseudo.tokenizer import ClipBpeTokenizer as JaxBpe
from srsem.pseudo.tokenizer import WordPieceTokenizer as JaxWordPiece
from srsem_torch.cli.main import main as port_main
from srsem_torch.eval.lpips import LPIPS
from srsem_torch.pseudo.clip_text import ClipTextEncoder, load_jax_clip_text
from srsem_torch.pseudo.text_embed import (
    MiniLMEmbedder,
    MiniLMEncoder,
    convert_hf_minilm,
    load_hf_minilm,
)
from srsem_torch.pseudo.tokenizer import ClipBpeTokenizer, WordPieceTokenizer
from srsem_torch.utils.convert import convert_clip_text
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

WORDS = ["a", "photo", "of", "dog", "##s", "cat", "un", "##related", "red",
         "blue", "car", "on", "the", "road", "cafe", "sky", "tree", ".", ","]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + WORDS
TEXTS = ["a photo of dogs", "the red car on the road.", "unrelated zzz",
         "Café sky, blue tree", "", "a cat"]
MINILM = dict(vocab_size=len(VOCAB), hidden=64, layers=2, heads=4,
              intermediate=128, max_position=32)
CLIP = dict(vocab_size=100, width=64, layers=2, heads=4, context=16,
            embed_dim=24)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


def _minilm(seed=0, **kw):
    model = MiniLMEncoder(**MINILM, **kw).reset_parameters(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-trivial LayerNorms
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    return model.eval()


def test_tokenizers_match_jax(vocab_file, tmp_path):
    got = WordPieceTokenizer(vocab_file, max_length=12)(TEXTS)
    want = JaxWordPiece(vocab_file, max_length=12)(TEXTS)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: toy\nh e\nhe l\nhel l\nhell o</w>\nl o</w>\n"
                      "c a\nca t</w>\n")
    texts = ["hello cat", "don’t stop the cafÃ©", "a &amp;amp; b ﬁre！"]
    np.testing.assert_array_equal(ClipBpeTokenizer(str(merges), 16)(texts),
                                  JaxBpe(str(merges), 16)(texts))


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_minilm_matches_jax(vocab_file, pool):
    """HF-layout weights → the JAX tree (JAX's convert_hf_minilm) → JAX's
    encoder, against the port's encoder with the HF weights loaded
    straight in."""
    model = _minilm(pool=pool)
    sd = model.state_dict()
    params = jax_convert_minilm(sd)
    tok = JaxWordPiece(vocab_file, max_length=12)(TEXTS)
    want = np.asarray(JaxMiniLM(**MINILM, pool=pool).apply(
        {"params": params}, tok["input_ids"], tok["attention_mask"]))
    ids = torch.from_numpy(tok["input_ids"]).long()
    mask = torch.from_numpy(tok["attention_mask"]).long()
    port = load_hf_minilm(MiniLMEncoder(**MINILM, pool=pool), sd)
    got = port.eval()(ids, mask).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_minilm_embedder_static_batches(vocab_file):
    """Six texts in batches of four: the last batch padded with empty
    strings to four, as the JAX embedder pads to its static batch."""
    model = _minilm(1)
    params = jax_convert_minilm(model.state_dict())
    jtok = JaxWordPiece(vocab_file, max_length=12)
    chunks = [TEXTS[:4], TEXTS[4:] + ["", ""]]
    want = np.concatenate([np.asarray(JaxMiniLM(**MINILM).apply(
        {"params": params}, *(jtok(c)[k] for k in ("input_ids",
                                                   "attention_mask"))))
        for c in chunks])[:6]
    emb = MiniLMEmbedder(model, WordPieceTokenizer(vocab_file), max_length=12,
                         batch_size=4, device="cpu")
    got = emb.encode(TEXTS)
    assert got.dtype == np.float32 and got.shape == (6, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_clip_text_matches_jax():
    model = ClipTextEncoder(**CLIP).reset_parameters(
        torch.Generator().manual_seed(2)).eval()
    params = convert_clip_text(model.state_dict())
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 90, (3, 16)).astype(np.int32)
    ids[:, 0] = 98
    ids[0, 7], ids[1, 15], ids[2, 3] = 99, 99, 99  # EOT: the highest id
    ids[0, 8:], ids[2, 4:] = 0, 0
    want = np.asarray(JaxClipText(**CLIP).apply({"params": params},
                                                jnp.asarray(ids)))
    for port in (model, load_jax_clip_text(ClipTextEncoder(**CLIP), params)):
        got = port(torch.from_numpy(ids).long()).detach().numpy()
        assert got.shape == (3, 24)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _hf_clip_text(model: ClipTextEncoder):
    """An HF ``CLIPTextModelWithProjection`` state dict of ``model``'s
    weights (q/k/v split out of ``in_proj``)."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    hf = {"text_model.embeddings.token_embedding.weight":
          sd["token_embedding.weight"],
          "text_model.embeddings.position_embedding.weight":
          sd["positional_embedding"],
          "text_model.final_layer_norm.weight": sd["ln_final.weight"],
          "text_model.final_layer_norm.bias": sd["ln_final.bias"],
          "text_projection.weight": sd["text_projection"].t().contiguous()}
    for i in range(CLIP["layers"]):
        tp, hp = f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}"
        for p, w, b in zip("qkv", sd[f"{tp}.attn.in_proj_weight"].chunk(3),
                           sd[f"{tp}.attn.in_proj_bias"].chunk(3)):
            hf[f"{hp}.self_attn.{p}_proj.weight"] = w.contiguous()
            hf[f"{hp}.self_attn.{p}_proj.bias"] = b.contiguous()
        for leaf in ("weight", "bias"):
            hf[f"{hp}.self_attn.out_proj.{leaf}"] = sd[f"{tp}.attn.out_proj.{leaf}"]
            hf[f"{hp}.layer_norm1.{leaf}"] = sd[f"{tp}.ln_1.{leaf}"]
            hf[f"{hp}.layer_norm2.{leaf}"] = sd[f"{tp}.ln_2.{leaf}"]
            hf[f"{hp}.mlp.fc1.{leaf}"] = sd[f"{tp}.mlp.c_fc.{leaf}"]
            hf[f"{hp}.mlp.fc2.{leaf}"] = sd[f"{tp}.mlp.c_proj.{leaf}"]
    return hf


def _convert_inputs(kind, tmp_path):
    """The torch file ``kind`` reads, and extra flags."""
    if kind == "minilm":
        sd = dict(_minilm(4).state_dict())
        sd["embeddings.position_ids"] = torch.arange(32)[None]
        sd["pooler.dense.weight"] = torch.zeros(64, 64)
        return {f"bert.{k}": v for k, v in sd.items()}, []
    text = ClipTextEncoder(**CLIP).reset_parameters(
        torch.Generator().manual_seed(5))
    if kind == "clip_text":
        return text.state_dict(), []
    if kind == "hf_clip_text":
        return _hf_clip_text(text), []
    model = LPIPS("vgg").reset_parameters(torch.Generator().manual_seed(6))
    sd = model.state_dict()
    tower = tmp_path / "vgg16.pth"
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")},
               tower)
    return ({k: v.abs() for k, v in sd.items() if k.startswith("lin")},
            ["--tower", str(tower), "--lpips-net", "vgg"])


@pytest.mark.parametrize("kind", ["lpips", "hf_clip_text", "clip_text",
                                  "minilm"])
def test_convert_writes_jax_bytes(kind, tmp_path, capsys):
    sd, flags = _convert_inputs(kind, tmp_path)
    src = tmp_path / "in.pt"
    torch.save(sd, src)
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        dst = tmp_path / f"{name}.msgpack"
        assert main(["convert", str(src), "--kind", kind, "--out", str(dst),
                     *flags]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[name] = (line["n_arrays"], dst.read_bytes())
    assert out["port"] == out["jax"]
    if kind == "hf_clip_text":  # the converted tree scores as the module
        from srsem_torch.train.checkpoint import msgpack_restore

        model = ClipTextEncoder(**CLIP).reset_parameters(
            torch.Generator().manual_seed(5))
        loaded = load_jax_clip_text(ClipTextEncoder(**CLIP),
                                    msgpack_restore(out["port"][1]))
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
    if kind == "minilm":
        assert set(convert_hf_minilm(sd)) == set(jax_convert_minilm(sd))
