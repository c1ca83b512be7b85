"""The port's approach drivers (srsem_torch/eval/approaches.py) against the
JAX package's (srsem/eval/approaches.py) on the same image pairs, weights
and saliency tree: ``compute_embedding_sim_metrics`` with Grad-CAM on the
CLIP ResNet-50's ``stages.2.2.act``, LPIPS alex and a saliency map, and
the three drivers (simple, focus through ``ClipTagger`` and
``cluster_concepts``, SpLiCE focus at rank 3) over the port's
``ClipDualEncoder`` and JAX's on the same tiny weights.  Rows carry the
same keys; the score, SSIM and PSNR agree within 1e-4, LPIPS within its
parity tolerance (2e-4), the CAM comparisons within the CAMs' 1e-3 (PSNR
1e-3 relative), overlaps within two pixels' share of the 64x64 map.  The
tap is stage 2 (a 4x4 map at 64 px): stage 3's 2x2 map, upsampled, is
flat near its zeros, and pixels within the CAMs' rounding of the 10%
quantile flip there (up to 0.16 points, 6 pixels, seen on the CPU).
Host-array images go to ``device``, tensors keep theirs.  64 px, float32,
the CPU."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srsem.backbones.resnet import ClipResNet50 as JaxClip
from srsem.decompose.splice import SpliceDecomposer as JaxSplice
from srsem.eval import approaches as japp
from srsem.eval.lpips import convert_lpips as jax_convert_lpips
from srsem.eval.lpips import make_lpips as jax_make_lpips
from srsem.explain import targets as jtg
from srsem.explain.embedders import EmbedderSuite as JaxSuite
from srsem.explain.tagger import ClipTagger as JaxTagger
from srsem.pseudo.clip_text import ClipDualEncoder as JaxDualEncoder
from srsem.pseudo.clip_text import ClipTextEncoder as JaxClipText
from srsem.pseudo.text_embed import HashingTextEmbedder as JaxHashing
from srsem.utils.convert import convert_clip_resnet50
from srsem_torch.backbones.resnet import ClipResNet50, reset_tower
from srsem_torch.decompose.splice import SpliceDecomposer
from srsem_torch.eval import approaches
from srsem_torch.eval.lpips import make_lpips
from srsem_torch.explain import targets
from srsem_torch.explain.embedders import EmbedderSuite
from srsem_torch.explain.tagger import ClipTagger
from srsem_torch.pseudo.clip_text import ClipDualEncoder, ClipTextEncoder
from srsem_torch.pseudo.text_embed import HashingTextEmbedder
from srsem_torch.utils.convert import convert_clip_text
from test_torch_port_explain import _ids
from test_torch_port_lpips import _official
from test_torch_port_text import CLIP
from test_torch_port_train import _two_threads  # noqa: F401 — fixture
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

SIZE = 64
TAP = "stages.2.2.act"  # a 4x4 map at 64 px
VOCAB = ["sky", "tree", "water", "cloud", "dog", "car", "road", "grass"]
FACTORIES = [(targets.cosine_similarity_target, jtg.cosine_similarity_target),
             (targets.mse_target, jtg.mse_target)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two (HQ, SR) pairs under relative paths (a saliency map beside the
    first HQ image in ``SaliencyMaps/``), both packages' dual encoders,
    CAM towers, LPIPS and SpLiCE decomposers on the same weights."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    os.makedirs(root / "HQ" / "SaliencyMaps")
    os.makedirs(root / "SR")
    for i in range(2):
        # SR images far from their HQ images: a random tower embeds near
        # images near one another, where a cosine's gradient is noise.
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
                        ).save(root / "HQ" / f"{i}.png")
        Image.fromarray(rng.integers(0, 255, (5, 6, 3), dtype=np.uint8)
                        ).resize((48, 40), Image.NEAREST).save(
            root / "SR" / f"{i}.png")
    np.save(root / "HQ" / "SaliencyMaps" / "0.npy",
            rng.random((24, 30)).astype(np.float32))

    # Identity BN but small gammas closing each residual branch: without
    # BN shifts the embedding moves with the image (cosines about 0.999
    # apart, not 1 - 1e-7), so the cosine CAMs are well posed.
    image = ClipResNet50(torch.float32, SIZE, embed_dim=CLIP["embed_dim"])
    reset_tower(image, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, m in image.named_modules():
            if name.startswith("layer") and name.endswith(("bn3",
                                                           "downsample.1")):
                m.weight.fill_(0.2)
    image.requires_grad_(False).eval()
    text = ClipTextEncoder(**CLIP).reset_parameters(
        torch.Generator().manual_seed(2)).eval()
    params = convert_clip_resnet50(image.state_dict())
    jax_image = JaxClip(dtype=jnp.float32, image_size=SIZE,
                        embed_dim=CLIP["embed_dim"])
    port = ClipDualEncoder(image, text, embed_dim=CLIP["embed_dim"],
                           tokenizer=_ids, context=CLIP["context"],
                           device="cpu")
    ref = JaxDualEncoder(jax_image, {"params": params},
                         {"params": convert_clip_text(text.state_dict())},
                         embed_dim=CLIP["embed_dim"], tokenizer=_ids,
                         context=CLIP["context"])
    ref.text_model = JaxClipText(**CLIP)

    def load_img(path):
        return np.asarray(Image.open(path).convert("RGB").resize(
            (SIZE, SIZE), Image.BICUBIC), np.float32)[None] / 255.0

    concepts = rng.standard_normal((40, CLIP["embed_dim"])).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    mean = rng.standard_normal(CLIP["embed_dim"]).astype(np.float32) * 0.1
    lins, alex = _official("alex", 0)
    lp_params = jax_convert_lpips(lins, alex, net="alex")
    jax_cam = jax.jit(lambda img, offsets: jax_image.apply(
        {"params": params}, img, tap_offsets=offsets))
    yield {
        "root": root, "load_img": load_img,
        "port": dict(
            suite=EmbedderSuite(port, load_img, splice=SpliceDecomposer(
                concepts, mean, device="cpu")),
            tagger=ClipTagger(port, load_img, VOCAB, threshold=-1.0, top_k=5),
            cam=lambda img, offsets: image(torch.as_tensor(img),
                                           tap_offsets=offsets),
            lpips=make_lpips("alex", params=lp_params, device="cpu"),
            factories=[f for f, _ in FACTORIES], mod=approaches,
            kw={"device": "cpu"}),
        "jax": dict(
            suite=JaxSuite(ref, load_img, splice=JaxSplice(concepts, mean)),
            tagger=JaxTagger(ref, load_img, VOCAB, threshold=-1.0, top_k=5),
            cam=jax_cam,
            lpips=jax_make_lpips("alex", params=lp_params, image_size=SIZE),
            factories=[f for _, f in FACTORIES], mod=japp, kw={}),
    }
    shutil.rmtree(root, ignore_errors=True)


CAM_KEYS = ("gcam_", "hqgcam_")


def _compare(got_rows, want_rows):
    assert len(got_rows) == len(want_rows) > 0
    for got, want in zip(got_rows, want_rows):
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k]
            if isinstance(w, str) or w is None:
                assert g == w, k
            elif "overlap" in k:  # percentages, two pixels' share
                assert abs(g - w) <= 2 * 100 / SIZE ** 2, (k, g, w)
            elif k == "lpips":
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                           err_msg=k)
            elif k.startswith(CAM_KEYS):
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                           err_msg=k)


def test_compute_embedding_sim_metrics_matches_jax(setup, monkeypatch):
    monkeypatch.chdir(setup["root"])
    rows = {}
    for side in ("port", "jax"):
        s = setup[side]
        rows[side] = [s["mod"].compute_embedding_sim_metrics(
            s["suite"].img_embedder, s["cam"], TAP, f"HQ/{i}.png",
            f"SR/{i}.png", s["factories"][0], setup["load_img"],
            lpips_fn=s["lpips"], **s["kw"]) for i in range(2)]
    assert "gcam_saliency_psnr" in rows["port"][0]
    assert "gcam_saliency_psnr" not in rows["port"][1]  # no map for it
    assert {"score", "ssim", "psnr", "lpips", "gcam_hqgcam_ssim",
            "hqgcam_overlap_gradcam"} <= set(rows["port"][1])
    _compare(rows["port"], rows["jax"])
    # Without Grad-CAM: the score and the classical metrics only.
    plain = approaches.compute_embedding_sim_metrics(
        setup["port"]["suite"].img_embedder, None, None, "HQ/0.png",
        "SR/0.png", targets.cosine_similarity_target, setup["load_img"],
        device="cpu")
    assert set(plain) == {"hq_pth", "rec_pth", "metric", "score", "ssim",
                          "psnr"}
    assert all(type(v) is float for k, v in plain.items() if k not in (
        "hq_pth", "rec_pth", "metric"))
    # Host-array images go to the card by default; tensors keep their device.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            approaches.compute_embedding_sim_metrics(
                setup["port"]["suite"].img_embedder, None, None, "HQ/0.png",
                "SR/0.png", targets.cosine_similarity_target,
                setup["load_img"])
    on_cpu = approaches.compute_embedding_sim_metrics(
        setup["port"]["suite"].img_embedder, None, None, "HQ/0.png",
        "SR/0.png", targets.cosine_similarity_target,
        lambda path: torch.from_numpy(setup["load_img"](path)))
    assert on_cpu == plain


def test_drivers_match_jax(setup, monkeypatch):
    """The three drivers over one pair: simple (two targets, Grad-CAM on),
    focus (the tagger's five tags clustered to three), SpLiCE focus at
    rank 3 (Grad-CAM on)."""
    pytest.importorskip("sklearn")
    monkeypatch.chdir(setup["root"])
    rows = {}
    for side in ("port", "jax"):
        s, data = setup[side], []
        m = s["mod"]
        m.simple_embedding_similarity(
            s["suite"], None, s["factories"], TAP, "HQ/0.png", "SR/0.png",
            data, embed_fn_for_cam=s["cam"], **s["kw"])
        m.focus_embedding_similarity(
            s["suite"], s["tagger"], s["factories"][:1], TAP, "HQ/0.png",
            "SR/0.png", data, do_gradcam=False, **s["kw"])
        m.splice_focus_embedding_similarity(
            s["suite"], s["factories"][:1], TAP, "HQ/0.png", "SR/0.png",
            data, rank=3, embed_fn_for_cam=s["cam"], **s["kw"])
        rows[side] = data
    methods = [r["embedding_method"] for r in rows["port"]]
    assert methods == ["simple"] * 2 + ["focus"] * 3 + ["splice_focus"]
    assert [r["img_element"] for r in rows["port"][2:5]] == \
        [r["img_element"] for r in rows["jax"][2:5]]
    assert rows["port"][-1]["rank"] == 3
    _compare(rows["port"], rows["jax"])
    # LPIPS rides along when a driver is given it (the JAX drivers lack it).
    data = []
    approaches.simple_embedding_similarity(
        setup["port"]["suite"], None, setup["port"]["factories"][:1], None,
        "HQ/1.png", "SR/1.png", data, do_gradcam=False,
        lpips_fn=setup["port"]["lpips"], device="cpu")
    assert np.isfinite(data[0]["lpips"])


def test_cluster_concepts_matches_jax():
    pytest.importorskip("sklearn")
    words = ["sky", "skies", "tree", "trees", "water", "ocean", "cloud"]
    for dim in (16, 64):
        got = approaches.cluster_concepts(HashingTextEmbedder(dim=dim).encode,
                                          words)
        want = japp.cluster_concepts(JaxHashing(dim=dim).encode, words)
        assert got == want and len(got) == 3
    assert approaches.cluster_concepts(None, ["a", "b"]) == ["a", "b"]


def test_saliency_paths_match_jax(tmp_path):
    for p in ("dataset/HQ/img.png", "/abs/data.v2/HQ/0001.jpg", "a.png",
              "root/x"):
        assert approaches.saliency_path_for(p) == japp.saliency_path_for(p)
    img = tmp_path / "HQ" / "0.png"
    assert approaches.load_saliency(str(img)) is None
