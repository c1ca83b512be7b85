"""The port's SLIP and ALBEF dual encoders (srsem_torch/explain/
dual_encoders.py) and their converters and loaders (srsem_torch/utils/
convert.py: ``convert_slip`` / ``convert_albef``, ``load_slip`` /
``load_albef``) against the JAX package's on the same checkpoints.

SLIP: a SLIP-layout checkpoint of the tiny ViT of
tests/test_torch_port_vit.py (width 96, depth 4, patch 16, its 14x14 table
interpolated at 64 px) under ``visual.``, a 2-layer CLIP text tower and an
``image_projection`` (tests/test_text_parity.py:175's layout).  ALBEF: the
small DeiT and 2-layer HF BERT checkpoint of tests/test_albef_convert.py
(momentum copies, a cross-attention entry), converted at its own grid
and at a 6x6 one (the bicubic positional table).  The converted trees
must equal JAX's; the embeddings, and the suite's focus and unfocus
embeddings over each backend, match JAX's at rtol = atol = 1e-4 (float32,
tests/test_albef_convert.py's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.vit import ClipViT as JaxClipViT
from srsem.explain.dual_encoders import AlbefDualEncoder as JaxAlbef
from srsem.explain.dual_encoders import SlipDualEncoder as JaxSlip
from srsem.explain.embedders import EmbedderSuite as JaxSuite
from srsem.pseudo.clip_text import ClipTextEncoder as JaxClipText
from srsem.pseudo.text_embed import MiniLMEncoder as JaxMiniLM
from srsem.utils.convert import convert_albef as jax_convert_albef
from srsem.utils.convert import convert_slip as jax_convert_slip
from srsem_torch.backbones.vit import ClipViT
from srsem_torch.explain.dual_encoders import (
    AlbefDualEncoder,
    SlipDualEncoder,
    albef_bert,
    albef_vit,
)
from srsem_torch.explain.embedders import EmbedderSuite
from srsem_torch.pseudo.clip_text import ClipTextEncoder
from srsem_torch.pseudo.text_embed import MiniLMEncoder
from srsem_torch.utils.convert import (
    convert_albef,
    convert_slip,
    load_albef,
    load_slip,
)
from test_albef_convert import TorchDeit, _albef_checkpoint
from test_torch_port_saliency import assert_trees_equal
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_vit import TINY, _timm_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
CLIP = dict(vocab_size=100, width=64, layers=2, heads=4, context=16,
            embed_dim=24)
DEIT = dict(patch=8, width=96, depth=3, heads=4, use_norm_pre=False,
            ln_eps=1e-6)
BERT = dict(vocab_size=200, hidden=48, layers=2, heads=4, intermediate=96,
            max_position=64, pool="cls")


def pixels(seed: int, size: int, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


# ---- SLIP -----------------------------------------------------------------

def slip_ids(texts):
    """Token ids of up to three texts: start 98, end 99 (the highest id,
    where the tower reads its embedding), zero padding."""
    ids = np.zeros((3, 16), np.int32)
    ids[:, 0] = 98
    ids[0, 1:5], ids[0, 5] = (5, 17, 42, 3), 99
    ids[1, 1:12], ids[1, 12] = np.arange(20, 31), 99
    ids[2, 1], ids[2, 2] = 64, 99
    return ids[:len(texts)]


@pytest.fixture(scope="module")
def slip():
    g = torch.Generator().manual_seed(12)
    sd = {f"visual.{k}": v for k, v in _timm_state_dict(11).items()}
    sd.update(ClipTextEncoder(**CLIP).reset_parameters(g).state_dict())
    sd["image_projection"] = torch.randn(96, 24, generator=g) * 0.05
    return sd, jax_convert_slip(sd)


@pytest.mark.parametrize("text_proj", [False, True], ids=["no_text_proj",
                                                          "text_proj"])
def test_slip_matches_jax(slip, text_proj):
    sd, tree = slip
    ptree = convert_slip(sd)
    assert_trees_equal(ptree, tree)
    tp = (np.random.default_rng(13).normal(0, 0.2, (24, 24)).astype(np.float32)
          if text_proj else None)
    want = JaxSlip({"params": tree["vit"]}, tree["image_projection"],
                   text_encoder=JaxClipText(**CLIP),
                   text_variables={"params": tree["text"]}, text_proj=tp,
                   tokenizer=slip_ids,
                   vit=JaxClipViT(dtype=jnp.float32, **TINY))
    got = load_slip(SlipDualEncoder(
        ClipViT(dtype=torch.float32, **TINY), np.zeros((96, 24)),
        text_encoder=ClipTextEncoder(**CLIP), text_proj=tp,
        tokenizer=slip_ids, device="cpu"), ptree)
    x = pixels(14, 64)
    img = got.encode_image(x)
    assert img.dtype == torch.float32 and tuple(img.shape) == (2, 24)
    np.testing.assert_allclose(img.numpy(), np.asarray(want.encode_image(x)),
                               **TOL)
    texts = ["a", "b", "c"]
    np.testing.assert_allclose(got.encode_text(texts).numpy(),
                               np.asarray(want.encode_text(texts)), **TOL)
    with pytest.raises(RuntimeError, match="SLIP text tower"):
        SlipDualEncoder(got.vit, ptree["image_projection"],
                        device="cpu").encode_text(texts)


# ---- ALBEF ----------------------------------------------------------------

@pytest.fixture(scope="module")
def albef():
    torch.manual_seed(3)
    return _albef_checkpoint(None, TorchDeit(grid=4).eval())[0]


def albef_tokens(texts):
    ids = np.random.default_rng(15).integers(0, 200, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 5:] = 0
    return {"input_ids": ids[:len(texts)], "attention_mask": mask[:len(texts)]}


def albef_pair(tree, grid: int, layout: str = "dict"):
    """JAX's and the port's AlbefDualEncoder on ``tree`` (projections in
    ``layout``: convert_albef's dict, a (kernel, bias) pair, or the bare
    kernel, whose bias is zero)."""
    def proj(p):
        return {"dict": p, "pair": (p["kernel"], p["bias"]),
                "matrix": p["kernel"]}[layout]

    want = JaxAlbef({"params": tree["vit"]}, proj(tree["vision_proj"]),
                    bert_variables=tree["text"],
                    text_proj=proj(tree["text_proj"]),
                    tokenizer=albef_tokens,
                    vit=JaxClipViT(dtype=jnp.float32, pos_grid=grid, **DEIT),
                    bert=JaxMiniLM(**BERT))
    got = AlbefDualEncoder(
        ClipViT(dtype=torch.float32, pos_grid=grid, **DEIT),
        proj(tree["vision_proj"]), bert=MiniLMEncoder(**BERT),
        text_proj=proj(tree["text_proj"]), tokenizer=albef_tokens,
        device="cpu")
    if layout == "dict":
        load_albef(got, tree)
    else:  # the towers only: the projections stay the constructor's
        load_albef(AlbefDualEncoder(got.vit, tree["vision_proj"],
                                    bert=got.bert, device="cpu"), tree)
    return want, got


@pytest.mark.parametrize("layout", ["dict", "pair", "matrix"])
def test_albef_matches_jax(albef, layout):
    tree = jax_convert_albef(albef, image_size=32, patch=8)
    ptree = convert_albef(albef, image_size=32, patch=8)
    assert set(ptree) == {"vit", "vision_proj", "text", "text_proj"}
    assert_trees_equal(ptree, tree)
    want, got = albef_pair(ptree, 4, layout)
    x = pixels(16, 32)
    img = got.encode_image(x)
    np.testing.assert_allclose(img.numpy(), np.asarray(want.encode_image(x)),
                               **TOL)
    txt = got.encode_text(["a", "b"])
    np.testing.assert_allclose(txt.numpy(),
                               np.asarray(want.encode_text(["a", "b"])), **TOL)
    for emb in (img, txt):
        np.testing.assert_allclose(emb.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_albef_interpolated_pos_embed_matches_jax(albef):
    """Grid 4 → 6 (48 px at patch 8): the bicubic table equals JAX's, and
    the image embeddings at 48 px match; an image-only encoder raises on
    text."""
    tree = jax_convert_albef(albef, image_size=48, patch=8)
    ptree = convert_albef(albef, image_size=48, patch=8)
    assert ptree["vit"]["pos_embed"].shape == (1, 37, 96)
    assert_trees_equal(ptree, tree)
    want, got = albef_pair(ptree, 6)
    x = pixels(17, 48)
    np.testing.assert_allclose(got.encode_image(x).numpy(),
                               np.asarray(want.encode_image(x)), **TOL)
    with pytest.raises(RuntimeError, match="ALBEF text tower"):
        AlbefDualEncoder(got.vit, ptree["vision_proj"],
                         device="cpu").encode_text(["a"])


def test_albef_default_towers_are_jax_defaults():
    """``albef_vit()`` / ``albef_bert()`` have the shapes of JAX's
    defaults: ViT-B/16, no pre-norm, eps 1e-6, a 24x24 table, float32;
    BERT-base with CLS pooling."""
    vit, bert = albef_vit(), albef_bert()
    assert vit.norm_pre is None and vit.dtype == torch.float32
    assert vit.pos_embed.shape == (1, 577, 768) and len(vit.blocks) == 12
    assert vit.norm.eps == 1e-6 and vit.patch == 16
    assert bert.pool == "cls" and len(bert.encoder.layer) == 12
    assert bert.encoder.layer[0].intermediate.dense.out_features == 3072
    assert AlbefDualEncoder(None, np.zeros((768, 256)),
                            device="cpu").vit.pos_embed.shape == (1, 577, 768)


# ---- the embedder suite on each backend ----------------------------------

@pytest.mark.parametrize("backend", ["slip", "albef"])
def test_suite_focus_embeddings_match_jax(slip, albef, backend):
    if backend == "slip":
        sd, tree = slip
        want = JaxSlip({"params": tree["vit"]}, tree["image_projection"],
                       text_encoder=JaxClipText(**CLIP),
                       text_variables={"params": tree["text"]},
                       tokenizer=slip_ids,
                       vit=JaxClipViT(dtype=jnp.float32, **TINY))
        got = load_slip(SlipDualEncoder(
            ClipViT(dtype=torch.float32, **TINY), tree["image_projection"],
            text_encoder=ClipTextEncoder(**CLIP), tokenizer=slip_ids,
            device="cpu"), convert_slip(sd))
        x = pixels(18, 64, 1)
    else:
        want, got = albef_pair(convert_albef(albef, image_size=32, patch=8), 4)
        x = pixels(18, 32, 1)
    jsuite, psuite = JaxSuite(want), EmbedderSuite(got)
    np.testing.assert_allclose(psuite.img_embedder(x).numpy(),
                               np.asarray(jsuite.img_embedder(x)), **TOL)
    for name in ("focus_img_embedder", "unfocus_img_embedder"):
        j, p = getattr(jsuite, name), getattr(psuite, name)
        j.focus_emb = np.asarray(jsuite.txt_embedder(["a"]))[0]
        p.focus_emb = psuite.txt_embedder(["a"])[0]
        np.testing.assert_allclose(p(x).numpy(), np.asarray(j(x)), **TOL,
                                   err_msg=name)
