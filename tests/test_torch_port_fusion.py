"""The port's ALBEF fusion encoder and ITM scorer (srsem_torch/explain/
fusion.py) against the JAX package's (srsem/explain/fusion.py), through
``convert_albef_fusion`` of tests/test_fusion.py's torch mirror (hidden
32, 4 heads, 4 layers, cross-attention from layer 2) and JAX's sizes there:
a padded text mask, 5 image tokens.  The two converters' trees must be
equal (with the ITM head and without: then a zero head); the sequence and
ITM logits, and the scorer's P(match), match JAX's at rtol 2e-4, atol
2e-5 (tests/test_fusion.py's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.explain.fusion import AlbefFusionEncoder as JaxFusion
from srsem.explain.fusion import AlbefItmScorer as JaxItmScorer
from srsem.explain.fusion import convert_albef_fusion as jax_convert
from srsem_torch.explain.fusion import (
    AlbefFusionEncoder,
    AlbefItmScorer,
    FusionBertLayer,
    convert_albef_fusion,
)
from srsem_torch.utils.convert import load_albef_fusion
from test_fusion import FUSE, HEADS, INTER, LAYERS, VOCAB, H, TorchFusionBert
from test_fusion import _state_dict as mirror_state_dict
from test_torch_port_saliency import assert_trees_equal
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

TOL = dict(rtol=2e-4, atol=2e-5)
SIZES = dict(vocab_size=VOCAB, hidden=H, layers=LAYERS, heads=HEADS,
             intermediate=INTER, fusion_start=FUSE, max_position=64)


@pytest.fixture(scope="module")
def mirror():
    torch.manual_seed(0)
    model = TorchFusionBert().eval()
    with torch.no_grad():  # an ITM head that is not near zero
        model.itm.weight.mul_(10.0)
    return mirror_state_dict(model)


@pytest.mark.parametrize("with_itm", [True, False], ids=["itm", "zero_itm"])
def test_convert_albef_fusion_tree_equals_jax(mirror, with_itm):
    sd, itm = mirror
    # The checkpoint's prefixes, which both converters strip.
    prefixed = {f"text_encoder.bert.{k}": v for k, v in sd.items()}
    itm_sd = {f"itm_head.{k}": v for k, v in itm.items()} if with_itm else None
    got = convert_albef_fusion(prefixed, itm_sd)
    assert_trees_equal(got, jax_convert(prefixed, itm_sd))
    if not with_itm:
        assert not got["itm_head"]["kernel"].any()
        assert got["itm_head"]["kernel"].shape == (H, 2)


def inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, 6:] = 0
    img = rng.normal(size=(3, 5, H)).astype(np.float32)
    return ids, mask, img


def test_fusion_encoder_matches_jax(mirror):
    params = jax_convert(*mirror)
    ids, mask, img = inputs()
    want_seq, want_itm = JaxFusion(**SIZES).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(img))
    port = load_albef_fusion(AlbefFusionEncoder(**SIZES), params).eval()
    assert [layer.crossattention is not None
            for layer in port.encoder.layer] == [False, False, True, True]
    t = torch.from_numpy
    with torch.no_grad():
        seq, itm = port(t(ids), t(mask), t(img))
        seq_ones, _ = port(t(ids), t(mask), t(img),
                           torch.ones(3, 5, dtype=torch.long))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **TOL)
    np.testing.assert_allclose(itm.numpy(), np.asarray(want_itm), **TOL)
    assert np.abs(np.asarray(want_itm)).max() > 0.1
    # No image mask means every image token attends, as an all-ones mask.
    torch.testing.assert_close(seq_ones, seq, rtol=0, atol=0)
    # The mirror's HF-style state dict loads as it is, to the same output.
    hf = AlbefFusionEncoder(**SIZES).eval()
    hf.load_state_dict({**{k: v for k, v in mirror[0].items()},
                        **{f"itm_head.{k}": v for k, v in mirror[1].items()}})
    with torch.no_grad():
        np.testing.assert_allclose(hf(t(ids), t(mask), t(img))[0].numpy(),
                                   seq.numpy(), rtol=1e-6, atol=1e-7)


def test_cross_layer_requires_image_states():
    layer = FusionBertLayer(H, HEADS, INTER, cross=True)
    x = torch.zeros(1, 3, H)
    with pytest.raises(ValueError, match="image states"):
        layer(x, torch.ones(1, 3))


def fake_tokenizer(texts):
    n = len(texts)
    ids = np.arange(n * 6).reshape(n, 6) % VOCAB
    mask = np.ones((n, 6), np.int32)
    mask[-1, 4:] = 0
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask}


@pytest.mark.parametrize("states", ["broadcast_3d", "broadcast_2d", "paired"])
def test_itm_scorer_matches_jax(mirror, states):
    """P(match) of one image against three texts (a (1, T, H) or a 2-D
    (T, H) state, broadcast), and of three images paired with three
    texts."""
    params = jax_convert(*mirror)
    img = np.random.default_rng(1).normal(size=(3, 5, H)).astype(np.float32)
    tokens = {"broadcast_3d": img[:1], "broadcast_2d": img[0],
              "paired": img}[states]
    want = JaxItmScorer(JaxFusion(**SIZES), {"params": params},
                        lambda px: tokens, fake_tokenizer)(
        None, ["a", "b", "c"])
    scorer = AlbefItmScorer(load_albef_fusion(AlbefFusionEncoder(**SIZES),
                                              params),
                            lambda px: tokens, fake_tokenizer, device="cpu")
    got = scorer(None, ["a", "b", "c"])
    assert isinstance(got, np.ndarray) and got.shape == (3,)
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, **TOL)
