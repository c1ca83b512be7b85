"""The port's pseudo-label stack against the JAX package's: the copied
caption, panoptic and cosine-map modules give the same files and maps;
C2C cosines (the hashing embedder, and a tiny MiniLM on both packages'
weights) and C2I (``embed_image_folder`` through ``ClipDualEncoder``'s
CLIP ResNet-50 at 64 px, float32, a corrupt file a NaN row; then
``score_c2i``) at 1e-4; and ``pseudo-c2c``, ``pseudo-captions`` and
``maps-build`` in process against ``srsem``'s on the same trees."""

import csv
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.backbones.resnet import ClipResNet50 as JaxClipResNet50
from srsem.cli.main import main as jax_main
from srsem.data.preprocess import Preprocess as JaxPreprocess
from srsem.maps import cosmap as jcosmap
from srsem.maps import panoptic as jpanoptic
from srsem.pseudo import captions as jcaptions
from srsem.pseudo import scoring as jscoring
from srsem.pseudo.clip_text import ClipDualEncoder as JaxDualEncoder
from srsem.pseudo.text_embed import HashingTextEmbedder as JaxHashing
from srsem.pseudo.text_embed import MiniLMEncoder as JaxMiniLM
from srsem.pseudo.text_embed import convert_hf_minilm as jax_convert_minilm
from srsem_torch.backbones.resnet import make_backbone, reset_tower
from srsem_torch.cli.main import main as port_main
from srsem_torch.config import BackboneConfig
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.maps import cosmap, panoptic
from srsem_torch.pseudo import captions, scoring
from srsem_torch.pseudo.clip_text import ClipDualEncoder
from srsem_torch.pseudo.text_embed import HashingTextEmbedder, MiniLMEncoder
from srsem_torch.utils.convert import jax_tower_params, load_backbone_params
from test_torch_port_train import _random_bn, _two_threads  # noqa: F401
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE = 64
CAPS = {"0": "a red car on the road", "1": "a photo of a dog",
        "2": "two dogs on the grass", "3": "the sky above the trees"}


def _panoptic(seed):
    rng = np.random.default_rng(seed)
    pan = np.zeros((24, 24), np.int32)
    pan[:12] = 1
    pan[12:, :10] = 2
    pan[12:, 10:] = 3
    pan[3:5, 3:5] = 3  # a small island: merged into its neighbor
    pan[rng.integers(0, 24, 6), rng.integers(0, 24, 6)] = 4
    return pan


def test_copied_modules_match_jax(tmp_path):
    """Caption files, folder layout, pairs, panoptic post-processing and
    cosine maps: the copies' outputs equal the JAX package's."""
    for mod, name in ((captions, "port.txt"), (jcaptions, "jax.txt")):
        mod.write_caption_file(str(tmp_path / name), {f"{k}.jpg": " " + v
                                                      for k, v in CAPS.items()})
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert captions.parse_caption_file(str(tmp_path / "port.txt")) == \
        jcaptions.parse_caption_file(str(tmp_path / "jax.txt"))
    folders = captions.default_folders("root")
    assert folders == jcaptions.default_folders("root")
    listings = {folders[0]: ["1.jpg", "2.png"], folders[3]: ["1.png", "2.png"],
                folders[7]: ["2.png", "x.txt"]}
    assert captions.enumerate_pairs(folders, listings) == \
        jcaptions.enumerate_pairs(folders, listings)

    for seed in range(3):
        pan = _panoptic(seed)
        got = panoptic.postprocess_panoptic(pan.copy(), 2.0)
        want = jpanoptic.postprocess_panoptic(pan.copy(), 2.0)
        np.testing.assert_array_equal(got, want)
        caps_a = {i: CAPS[str(i % 4)] for i in np.unique(got)}
        caps_b = {i: CAPS[str((i + 1) % 4)] for i in np.unique(got)}
        m_got, n_got = cosmap.assemble_cosine_map(got, caps_a, caps_b,
                                                  HashingTextEmbedder())
        m_want, n_want = jcosmap.assemble_cosine_map(got, caps_a, caps_b,
                                                     JaxHashing())
        assert n_got == n_want
        np.testing.assert_allclose(m_got, m_want, rtol=1e-6, atol=1e-6)


class _JaxMiniLMEmbedder:
    """The JAX package's MiniLM encoder behind the embedder interface, at
    the port test's tiny width (JAX's MiniLMEmbedder builds the full one)."""

    def __init__(self, params, vocab):
        from srsem.pseudo.tokenizer import WordPieceTokenizer

        self.params, self.tok = params, WordPieceTokenizer(vocab, 16)
        self.model = JaxMiniLM(vocab_size=40, hidden=64, layers=2, heads=4,
                               intermediate=128, max_position=32)

    def encode(self, texts):
        t = self.tok(list(texts))
        return np.asarray(self.model.apply({"params": self.params},
                                           t["input_ids"], t["attention_mask"]))


def test_c2c_cosines_match_jax(tmp_path):
    from srsem_torch.pseudo.text_embed import MiniLMEmbedder
    from srsem_torch.pseudo.tokenizer import WordPieceTokenizer

    words = sorted({w for c in CAPS.values() for w in c.split()})
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words
                               + [f"w{i}" for i in range(36 - len(words))]))
    pairs = [("0", "1"), ("1", "2"), ("0", "3"), ("2", "2"), ("3", "1")]
    got = scoring.score_caption_pairs(CAPS, pairs, HashingTextEmbedder())
    want = jscoring.score_caption_pairs(CAPS, pairs, JaxHashing())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    model = MiniLMEncoder(vocab_size=40, hidden=64, layers=2, heads=4,
                          intermediate=128, max_position=32).reset_parameters(
        torch.Generator().manual_seed(0))
    emb = MiniLMEmbedder(model, WordPieceTokenizer(str(vocab), 16),
                         max_length=16, batch_size=4, device="cpu")
    got = scoring.score_caption_pairs(CAPS, pairs, emb)
    want = jscoring.score_caption_pairs(
        CAPS, pairs, _JaxMiniLMEmbedder(jax_convert_minilm(model.state_dict()),
                                        str(vocab)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _clip_tower():
    """A seeded 64 px CLIP tower (float32) with random BN statistics, and
    its weights as the JAX package's tree."""
    tower = make_backbone(BackboneConfig(kind="resnet50_clip", image_size=SIZE,
                                         compute_dtype="float32"))
    reset_tower(tower, torch.Generator().manual_seed(0))
    params = _random_bn(jax_tower_params(tower, tower.state_dict(),
                                         lambda t: t),
                        np.random.default_rng(0))
    return load_backbone_params(tower, "resnet50_clip", params), params


def test_c2i_matches_jax(tmp_path):
    """Five images, one corrupt, in static batches of 4 through both
    packages' CLIP towers (the port's folded fused tower, its plain
    version on the CPU), then caption-to-image cosines."""
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
                        ).save(folder / f"{i}.png")
    (folder / "bad.jpg").write_bytes(b"junk")

    tower, params = _clip_tower()
    got = scoring.embed_image_folder(
        ClipDualEncoder(tower, device="cpu"), str(folder),
        Preprocess.for_backbone("resnet50_clip", SIZE), batch_size=4)
    want = jscoring.embed_image_folder(
        JaxDualEncoder(JaxClipResNet50(dtype=jnp.float32, image_size=SIZE),
                       {"params": params}),
        str(folder), JaxPreprocess.for_backbone("resnet50_clip", SIZE),
        batch_size=4)
    assert set(got) == set(want) == {"0", "1", "2", "3", "bad"}
    assert np.isnan(got["bad"]).all() and got["0"].shape == (1024,)
    scale = max(float(np.abs(want[k]).max()) for k in CAPS)
    for k in CAPS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale)
    caps = {**CAPS, "bad": "junk", "missing": "no image"}
    c_got = scoring.score_c2i(caps, got, HashingTextEmbedder(1024))
    c_want = jscoring.score_c2i(caps, want, JaxHashing(1024))
    assert list(c_got) == list(c_want)
    np.testing.assert_allclose([c_got[k] for k in CAPS],
                               [c_want[k] for k in CAPS], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        scoring.score_image_caption_pairs(np.stack([got[k] for k in CAPS]),
                                          np.stack([want[k] for k in CAPS])),
        1.0, atol=1e-4)


def _koniq_tree(root):
    """HQ and two SR folders of three images each, with caption files."""
    folders = captions.default_folders(str(root))
    rng = np.random.default_rng(2)
    for f, ext in ((folders[0], "jpg"), (folders[1], "png"),
                   (folders[6], "png")):
        os.makedirs(f)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
                            ).save(os.path.join(f, f"{i}.{ext}"))
        captions.write_caption_file(
            os.path.join(f, "wholeim_captions_batch.txt"),
            {f"{i}.{ext}": " " + CAPS[str((i + len(f)) % 4)]
             for i in range(3)})


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cli_pseudo_and_maps(tmp_path, capsys):
    root = tmp_path / "koniq"
    _koniq_tree(root)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"c2c_{name}.csv"
        assert main(["pseudo-c2c", str(root), "--out", str(out),
                     *(["--device", "cpu"] if name == "port" else [])]) == 0
        outs[name] = _read(out)
        assert json.loads(capsys.readouterr().out)["pairs"] == len(outs[name])
    assert [(r["img_a_pth"], r["img_b_pth"]) for r in outs["port"]] == \
        [(r["img_a_pth"], r["img_b_pth"]) for r in outs["jax"]]
    np.testing.assert_allclose([float(r["cosine"]) for r in outs["port"]],
                               [float(r["cosine"]) for r in outs["jax"]],
                               rtol=1e-4, atol=1e-4)

    # pseudo-captions (static backend): both append to the caption files,
    # so each runs on its own copy of a captionless tree.
    for name, main in (("jax", jax_main), ("port", port_main)):
        hq = tmp_path / f"cap_{name}" / "HQ"
        hq.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
                hq / f"{i}.jpg")
        assert main(["pseudo-captions", str(hq.parent), "--batch-size",
                     "2"]) == 0
        assert json.loads(capsys.readouterr().out) == {str(hq): 3}
    assert (tmp_path / "cap_port/HQ/wholeim_captions_batch.txt").read_bytes() \
        == (tmp_path / "cap_jax/HQ/wholeim_captions_batch.txt").read_bytes()

    # maps-build: panoptic pickles and region captions beside the images.
    folders = captions.default_folders(str(root))
    pairs_csv = tmp_path / "pairs.csv"
    rows = []
    for i in range(2):
        a = os.path.join(folders[0], f"{i}.jpg")
        b = os.path.join(folders[1], f"{i}.png")
        rows.append((a, b))
        pan = panoptic.postprocess_panoptic(_panoptic(i), area_threshold_percent=2.0)
        for img, k in ((a, 0), (b, 1)):
            d = os.path.join(os.path.dirname(img), "general_panoptic")
            os.makedirs(d, exist_ok=True)
            stem = str(i)
            with open(os.path.join(d, stem + ".pkl"), "wb") as f:
                pickle.dump(pan, f)
            with open(os.path.join(d, stem + ".txt"), "w") as f:
                f.write("\n".join(CAPS[str((j + k) % 4)]
                                  for j in range(len(np.unique(pan)))))
    with open(pairs_csv, "w") as f:
        f.write("img_a_pth,img_b_pth\n" + "".join(f"{a},{b}\n" for a, b in rows))
    maps = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_dir, out_csv = tmp_path / f"maps_{name}", tmp_path / f"{name}.csv"
        assert main(["maps-build", str(pairs_csv), "--out-dir", str(out_dir),
                     "--out-csv", str(out_csv),
                     *(["--device", "cpu"] if name == "port" else [])]) == 0
        capsys.readouterr()
        listed = _read(out_csv)
        maps[name] = [(r["img_a_pth"], r["img_b_pth"], r["ima_ncaps"],
                       os.path.basename(r["out_paths"]),
                       pickle.load(open(r["out_paths"], "rb")))
                      for r in listed]
    for got, want in zip(maps["port"], maps["jax"]):
        assert got[:4] == want[:4]
        np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=1e-6)
