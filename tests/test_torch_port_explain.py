"""The port's explain stack (srsem_torch/explain/) against the JAX package's
(srsem/explain/) on the same seeded inputs and weights: the targets,
``similarity_matrix`` and the overlap metrics (1e-6; overlap percentages
within two pixels' share, since a tie at the quantile threshold may flip),
the towers' tap offsets (absent or zero: bit-equal outputs; a nonzero
offset at each tap as JAX places it, 1e-4), ``grad_cam`` on the ImageNet
and CLIP ResNet-50s and a tiny ViT, ``grad_cam_matrix`` at n = 2 on the
tiny ViT (float32 CAMs within 1e-3), the embedder suite and the RAM
projector (a negative dot sum too), and ``ClipTagger`` over the JAX
tests' stub encoder and over the port's ``ClipDualEncoder`` against JAX's
on the same tiny weights.  64 px towers, float32, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.resnet import ClipResNet50 as JaxClip
from srsem.backbones.resnet import ImageNetResNet50 as JaxImageNet
from srsem.backbones.vit import ClipViT as JaxClipViT
from srsem.decompose.splice import SpliceDecomposer as JaxSplice
from srsem.explain import embedders as jemb
from srsem.explain import gradcam as jgc
from srsem.explain import overlap as jov
from srsem.explain import targets as jtg
from srsem.explain.tagger import ClipTagger as JaxTagger
from srsem.pseudo.clip_text import ClipDualEncoder as JaxDualEncoder
from srsem.pseudo.clip_text import ClipTextEncoder as JaxClipText
from srsem.utils.convert import convert_clip_resnet50, convert_torch_resnet50
from srsem_torch.backbones.resnet import ClipResNet50, ImageNetResNet50
from srsem_torch.config import BackboneConfig
from srsem_torch.decompose.splice import SpliceDecomposer
from srsem_torch.explain import embedders, gradcam, overlap, targets
from srsem_torch.explain.tagger import DEFAULT_TAG_VOCABULARY, ClipTagger
from srsem_torch.pseudo.clip_text import ClipDualEncoder, ClipTextEncoder
from srsem_torch.utils.convert import convert_clip_text
from test_tagger import StubDualEncoder
from test_torch_port_clip import seeded_clip_tower
from test_torch_port_text import CLIP
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from test_torch_port_vit import TINY, images, jax_vit_params, port_vit

SIZE = 64
FACTORIES = {"mse": (jtg.mse_target, targets.mse_target),
             "cosine": (jtg.cosine_similarity_target,
                        targets.cosine_similarity_target),
             "sum": (jtg.vector_sum_target, targets.vector_sum_target)}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(FACTORIES))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_targets_match_jax(name, reduction):
    rng = np.random.default_rng(0)
    t, out = (rng.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    jax_f, port_f = FACTORIES[name]
    want = np.asarray(jax_f(t, reduction)(jnp.asarray(out)))
    for arg in (out, torch.from_numpy(out)):  # arrays and tensors
        np.testing.assert_allclose(_np(port_f(t, reduction)(arg)), want,
                                   rtol=1e-6, atol=1e-6)


def test_similarity_matrix_matches_jax():
    """Per-row targets, as JAX's vmap: a ``reduction="mean"`` target is
    not averaged across rows."""
    v = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    for name in ("mse", "cosine"):
        jax_f, port_f = FACTORIES[name]
        got = overlap.similarity_matrix(v, port_f, device="cpu")
        assert got.shape == (4, 4)
        np.testing.assert_allclose(got, jov.similarity_matrix(v, jax_f),
                                   rtol=1e-6, atol=1e-6)
    got = overlap.similarity_matrix(
        v, lambda t: targets.mse_target(t, "none"), dim_mean=True,
        device="cpu")
    want = jov.similarity_matrix(
        v, lambda t: jtg.mse_target(t, "none"), dim_mean=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_overlap_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.random((24, 32)).astype(np.float32)
    b = rng.random((12, 16)).astype(np.float32)  # resized to a's shape
    for top in (0.9, 0.5, 0.1):
        np.testing.assert_array_equal(
            _np(overlap.binarize_top_percent(a, top, device="cpu")),
            np.asarray(jov.binarize_top_percent(a, top)))
        got = overlap.overlap_metrics(a, b, top, device="cpu")
        want = jov.overlap_metrics(a, b, top)
        # Two pixels' share of the map: a tie at the threshold may flip.
        np.testing.assert_allclose(got, want, atol=2 * 100 / a.size)
    full = overlap.overlap_metrics(a, a, device="cpu")
    assert full[0] == full[1] == 100.0
    # Tensors stay on their device; arrays go to the card by default.
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert overlap.overlap_metrics(ta, tb) == overlap.overlap_metrics(
        a, b, device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: overlap.overlap_metrics(a, b),
                     lambda: overlap.binarize_top_percent(a),
                     lambda: overlap.similarity_matrix(
                         a[:2], targets.mse_target)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def _resnet(kind):
    """A seeded 64 px float32 port tower with random BN statistics, its
    JAX module and params (srsem/utils/convert.py from its state dict)."""
    port = seeded_clip_tower(BackboneConfig(kind=kind, image_size=SIZE,
                                            compute_dtype="float32"), 0)
    if kind == "resnet50":
        return (port, JaxImageNet(dtype=jnp.float32),
                convert_torch_resnet50(port.state_dict()))
    return (port, JaxClip(dtype=jnp.float32, image_size=SIZE),
            convert_clip_resnet50(port.state_dict()))


def _vit():
    params = jax_vit_params(0)
    return port_vit(params), JaxClipViT(dtype=jnp.float32, **TINY), params


TOWERS = {"resnet50": lambda: _resnet("resnet50"),
          "resnet50_clip": lambda: _resnet("resnet50_clip"), "vit": _vit}
PROBE_TAPS = {"resnet50": ("conv1", "layer2.2.act3", "layer4.2.act3"),
              "resnet50_clip": ("stem.conv3", "stages.1.0.act",
                                "stages.3.2.act"),
              "vit": ("blocks.0.ls2", "blocks.3.ls2")}


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_tap_offsets(kind):
    """No offsets and zero offsets at every tap leave the embedding and the
    taps bit-equal; an entry of None makes that zero offset, in the tap's
    shape and dtype and taking a gradient; nonzero offsets go where JAX's
    ``_tap`` puts them (the taps record the offset activation) and move the
    output as JAX's do."""
    port, jax_model, params = TOWERS[kind]()
    x = torch.from_numpy(images(3, 1, SIZE))
    with torch.no_grad():
        base_emb, base_taps = port(x)
        made = dict.fromkeys(base_taps)
        for offsets in (None, {k: torch.zeros_like(v)
                               for k, v in base_taps.items()}, made):
            emb, taps = port(x, tap_offsets=offsets)
            assert torch.equal(emb, base_emb)
            assert all(torch.equal(taps[k], v) for k, v in base_taps.items())
    for k, v in base_taps.items():
        assert made[k].requires_grad and not made[k].any()
        assert made[k].shape == v.shape and made[k].dtype == v.dtype
    with torch.no_grad():
        rng = np.random.default_rng(4)
        offs = {k: rng.normal(0, 0.1, base_taps[k].shape).astype(np.float32)
                for k in PROBE_TAPS[kind]}
        emb, taps = port(x, tap_offsets={k: torch.from_numpy(v)
                                         for k, v in offs.items()})
    want_emb, want_taps = jax_model.apply(
        {"params": params}, jnp.asarray(x.numpy()),
        tap_offsets={k: jnp.asarray(v) for k, v in offs.items()})
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=1e-4,
                               atol=1e-4)
    for k in PROBE_TAPS[kind]:
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(want_taps[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind,tap,grid", [
    ("resnet50", "layer3.2.act3", None),
    ("resnet50", "conv1", None),          # the raw pre-BN stem conv
    ("resnet50_clip", "stages.3.2.act", None),
    ("vit", "blocks.2.ls2", (4, 4)),
])
def test_grad_cam_matches_jax(kind, tap, grid):
    port, jax_model, params = TOWERS[kind]()
    x = images(5, 1, SIZE)
    target = np.random.default_rng(6).standard_normal(
        (1, 1024 if kind == "resnet50_clip" else 2048 if kind == "resnet50"
         else TINY["width"])).astype(np.float32)

    def jax_fn(img, offsets):
        return jax_model.apply({"params": params}, img, tap_offsets=offsets)

    want = jgc.grad_cam(jax_fn, x, tap, jtg.cosine_similarity_target(target),
                        (SIZE, SIZE), grid)
    got = gradcam.grad_cam(lambda img, offsets: port(img, tap_offsets=offsets),
                           x, tap, targets.cosine_similarity_target(target),
                           (SIZE, SIZE), grid)
    assert got.shape == (1, SIZE, SIZE) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6
    assert want.max() > 0.5  # a map, not a constant
    np.testing.assert_allclose(got, want, atol=1e-3)
    # Only the offset took a gradient.
    assert all(p.grad is None for p in port.parameters())


def test_grad_cam_matrix_matches_jax():
    port, jax_model, params = _vit()
    imgs = [images(7 + i, 1, SIZE) for i in range(2)]
    with torch.no_grad():
        embs = np.concatenate([port(torch.from_numpy(im))[0].numpy()
                               for im in imgs])

    def jax_fn(img, offsets):
        return jax_model.apply({"params": params}, img, tap_offsets=offsets)

    want = jgc.grad_cam_matrix(jax_fn, imgs, embs, "blocks.3.ls2",
                               jtg.cosine_similarity_target, (SIZE, SIZE),
                               (4, 4))
    got = gradcam.grad_cam_matrix(
        lambda img, offsets: port(img, tap_offsets=offsets), imgs, embs,
        "blocks.3.ls2", targets.cosine_similarity_target, (SIZE, SIZE), (4, 4))
    assert got.shape == (2, 2, SIZE, SIZE)
    np.testing.assert_allclose(got, want, atol=1e-3)


class StubDual:
    """A dual encoder of fixed linear maps (numpy out, as JAX tests' stubs):
    image pixels → (n, 16), texts → (n, 16) by a seeded table."""

    def __init__(self):
        rng = np.random.default_rng(8)
        self.w = rng.standard_normal((12, 16)).astype(np.float32)
        self.table = {}

    def encode_image(self, pixels):
        return np.asarray(pixels, np.float32).reshape(
            np.shape(pixels)[0], -1)[:, :12] @ self.w

    def encode_text(self, texts):
        for t in texts:
            self.table.setdefault(t, np.random.default_rng(
                len(self.table)).standard_normal(16).astype(np.float32))
        return np.stack([self.table[t] for t in texts])


def test_embedder_suite_matches_jax():
    dual = StubDual()
    pixels = np.random.default_rng(9).random((2, 4, 4, 3)).astype(np.float32)
    r = np.random.default_rng(10)
    concepts = r.standard_normal((50, 16)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    mean = r.standard_normal(16).astype(np.float32) * 0.1
    port = embedders.EmbedderSuite(dual, splice=SpliceDecomposer(
        concepts, mean, device="cpu"))
    ref = jemb.EmbedderSuite(dual, splice=JaxSplice(concepts, mean))
    focus = dual.encode_text(["sky"])[0]
    for name in ("focus_img_embedder", "unfocus_img_embedder"):
        getattr(port, name).focus_emb = focus
        getattr(ref, name).focus_emb = focus
        np.testing.assert_allclose(
            _np(getattr(port, name)(pixels)),
            np.asarray(getattr(ref, name)(pixels)), rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        embedders.FocusEmbedder(dual.encode_image)(pixels)
    for mode, kw in (("l1", {"l1": 0.3}), ("rank", {"rank": 3})):
        for suite in (port, ref):
            sf = suite.splice_focus_img_embedder
            sf.target_mode = mode
            for k, v in kw.items():
                setattr(sf, k, v)
        got = port.splice_focus_img_embedder(pixels[:1])
        want = ref.splice_focus_img_embedder(pixels[:1])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        if mode == "rank":
            port.splice_focus_img_embedder.weights_mode = True
            w = port.splice_focus_img_embedder(pixels[:1])
            assert np.count_nonzero(w) == 3


@pytest.mark.parametrize("negative", [False, True])
def test_ram_projector_matches_jax(negative):
    """Tag embeddings normalized along dim 0, dots over their sum; with a
    negative sum the weights divide by it (sign kept)."""
    dual = StubDual()
    pixels = np.random.default_rng(11).random((1, 4, 4, 3)).astype(np.float32)
    tags = ["sky", "tree", "water", "cloud"]
    image_fn = ((lambda p: -dual.encode_image(p)) if negative
                else dual.encode_image)
    got_rec, got_tags = embedders.RamProjector(
        lambda im: tags, image_fn, dual.encode_text, ret_concepts=True)(
        "img.png", pixels)
    want_rec, want_tags = jemb.RamProjector(
        lambda im: tags, image_fn, dual.encode_text, ret_concepts=True)(
        "img.png", pixels)
    emb = image_fn(pixels)[0]
    t = dual.encode_text(tags)
    dots = (t / np.linalg.norm(t, axis=0)) @ emb
    assert (dots.sum() < 0) == negative
    assert got_tags == want_tags == tags
    np.testing.assert_allclose(_np(got_rec), np.asarray(want_rec), rtol=1e-5,
                               atol=1e-6)


def test_clip_tagger_stub_matches_jax():
    """The JAX tests' one-hot stub encoder: ranking, threshold, top_k."""
    vocab = ["dog", "cat", "tree", "car"]
    for hot, threshold, top_k in ((1, 0.3, 3), (2, 0.0, 2), (0, 0.0, None)):
        kw = dict(load_img=lambda p: p, vocabulary=vocab,
                  threshold=threshold, top_k=top_k)
        enc = StubDualEncoder(vocab, hot=hot)
        port, ref = ClipTagger(enc, **kw), JaxTagger(enc, **kw)
        assert port(np.zeros((1,))) == ref(np.zeros((1,)))
        np.testing.assert_allclose(port.scores(np.zeros((1,))),
                                   ref.scores(np.zeros((1,))), rtol=1e-6)
    assert len(DEFAULT_TAG_VOCABULARY) == 50


def _ids(texts, context=CLIP["context"]):
    """Deterministic token ids inside the tiny vocabulary: 98 (start), a
    word's id, 99 (end, the highest id), zeros."""
    out = np.zeros((len(texts), context), np.int32)
    for i, t in enumerate(texts):
        words = [1 + sum(map(ord, w)) % 90 for w in t.split()]
        row = [98] + words[: context - 2] + [99]
        out[i, : len(row)] = row
    return out


def test_clip_tagger_dual_encoder_matches_jax():
    """The port's ClipDualEncoder (the CLIP ResNet-50 through the fused
    tower's plain version, the CLIP text tower) against JAX's on the same
    tiny weights: tags and scores over the default vocabulary."""
    tower = seeded_clip_tower(BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"), 1)
    image = ClipResNet50(torch.float32, SIZE, embed_dim=CLIP["embed_dim"])
    sd = tower.state_dict()
    rng = np.random.default_rng(12)
    for k in ("attnpool.c_proj.weight", "attnpool.c_proj.bias"):
        sd[k] = torch.from_numpy(rng.normal(0, 0.05, image.state_dict()[k].shape)
                                 .astype(np.float32))
    image.load_state_dict(sd)
    text = ClipTextEncoder(**CLIP).reset_parameters(
        torch.Generator().manual_seed(2)).eval()
    port = ClipDualEncoder(image, text, embed_dim=CLIP["embed_dim"],
                           tokenizer=_ids, context=CLIP["context"],
                           device="cpu")
    ref = JaxDualEncoder(
        JaxClip(dtype=jnp.float32, image_size=SIZE,
                embed_dim=CLIP["embed_dim"]),
        {"params": convert_clip_resnet50(image.state_dict())},
        {"params": convert_clip_text(text.state_dict())},
        embed_dim=CLIP["embed_dim"], tokenizer=_ids, context=CLIP["context"])
    ref.text_model = JaxClipText(**CLIP)
    x = images(13, 1, SIZE)
    kw = dict(load_img=lambda p: p, threshold=-1.0, top_k=5)
    got, want = ClipTagger(port, **kw), JaxTagger(ref, **kw)
    np.testing.assert_allclose(got.scores(x), want.scores(x), rtol=1e-4,
                               atol=1e-4)
    assert got(x) == want(x)
    assert len(got(x)) == 5
