"""Embedding-metric wrapper suite — the port of srsem/explain/embedders.py:
the five embedders + RAM projector.

The reference's per-backbone wrapper classes (CLIP/SLIP/ALBEF all expose
the same five callables — reference:
additional_approaches/src/slip/model_wrapper.py:10-195,
clip/model_wrapper_old.py:31-186, albef/model_wrapper.py:11-197) as ONE
generic suite over any dual encoder with ``encode_image``/``encode_text``:

* ``img_embedder(pixels)``            — plain joint-space embedding;
* ``txt_embedder(texts)``             — text side;
* ``focus_img_embedder(pixels)``      — project the image embedding onto a
  text-concept direction: ``f̂ · (e·f̂)`` (reference slip wrapper :92-99);
* ``unfocus_img_embedder(pixels)``    — remove that projection: ``e − focus``
  (reference :116-123);
* ``splice_focus_img_embedder(pixels)`` — decompose → (optionally weights)
  → recompose through SpLiCE (reference :125-177).

Any object with ``encode_image``/``encode_text`` plugs in, including
srsem_torch.pseudo.clip_text.ClipDualEncoder, whose image side runs the
CLIP ResNet-50 through the bottleneck kernels and returns a tensor on the
card.  The focus embedders and the projector compute on the embedding's
device; SpLiCE takes the embedding to the host explicitly
(``.float().cpu().numpy()``), where the JAX package calls ``np.asarray``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from srsem_torch.explain.targets import as_tensor, unit

Tensor = torch.Tensor


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array as a float32 host array."""
    if isinstance(x, Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class FocusEmbedder:
    """Set ``.focus_emb`` (a text-concept embedding) then call on pixels —
    the reference's stateful-attribute protocol kept for API parity."""

    def __init__(self, encode_image: Callable, mode: str = "focus"):
        self.encode_image = encode_image
        self.focus_emb = None
        self.mode = mode

    def __call__(self, pixels):
        if self.focus_emb is None:
            raise RuntimeError("set .focus_emb before calling")
        emb = as_tensor(self.encode_image(pixels))
        f = unit(as_tensor(self.focus_emb).to(emb.device).reshape(-1))
        scalars = torch.sum(emb * f, dim=-1, keepdim=True)
        focused = f[None, :] * scalars
        return focused if self.mode == "focus" else emb - focused


class SpliceFocusEmbedder:
    """Embed → SpLiCE decompose → recompose (or raw weights).

    Attributes mirror the reference knobs (slip wrapper :132-141):
    ``method`` ("admm" / "skl"), ``l1``, ``rank``, ``target_mode``
    ("rank"/"l1"), ``weights_mode``.
    """

    def __init__(self, encode_image: Callable, splice):
        self.encode_image = encode_image
        self.splice = splice
        self.method = "admm"
        self.l1 = 3.0
        self.rank = 5
        self.target_mode = "rank"
        self.weights_mode = False

    def __call__(self, pixels):
        emb = to_numpy(self.encode_image(pixels))
        if self.target_mode == "l1":
            weights = self.splice.decompose(emb, self.method, l1=self.l1)
        else:
            weights = self.splice.decompose(emb, self.method, rank=self.rank)
        if weights is None:
            return None  # rank search failed (reference :170-172)
        if self.weights_mode:
            return weights
        return self.splice.recompose(weights)


class EmbedderSuite:
    """The uniform surface the eval orchestrators consume."""

    def __init__(self, dual_encoder, load_img: Callable = None,
                 patch_grid_size: int = 17, image_size: int = 224,
                 splice=None):
        self.model = dual_encoder
        self.load_img = load_img
        self.patch_grid_size = patch_grid_size
        self.image_size = image_size
        self.img_embedder = dual_encoder.encode_image
        self.txt_embedder = dual_encoder.encode_text
        self.focus_img_embedder = FocusEmbedder(dual_encoder.encode_image, "focus")
        self.unfocus_img_embedder = FocusEmbedder(dual_encoder.encode_image, "unfocus")
        self.splice_focus_img_embedder = (
            SpliceFocusEmbedder(dual_encoder.encode_image, splice)
            if splice is not None else None)


class RamProjector:
    """RAM-tag-driven embedding reconstruction
    (reference: additional_approaches/src/ram/model_wrapper.py:34-64):
    embed the image's tags, weight each tag embedding by its normalized dot
    product with the image embedding, return the weighted sum.  The
    reference normalizes the concept matrix along dim=0 — per embedding
    *dimension*, not per concept (sic, :50) — reproduced for parity.
    ``ret_concepts`` also returns the tag list (:36,:60-63)."""

    def __init__(self, tagger: Callable[[object], Sequence[str]],
                 encode_image: Callable, encode_text: Callable,
                 ret_concepts: bool = False):
        self.tagger = tagger  # image → list of tag strings (pluggable RAM++)
        self.encode_image = encode_image
        self.encode_text = encode_text
        self.ret_concepts = ret_concepts

    def tags(self, image) -> Sequence[str]:
        return self.tagger(image)

    def __call__(self, image, pixels):
        tags = list(self.tagger(image))
        img_emb = as_tensor(self.encode_image(pixels)).reshape(-1)
        tag_embs = as_tensor(self.encode_text(tags)).to(img_emb.device)
        tag_embs = tag_embs / torch.linalg.vector_norm(
            tag_embs, dim=0).clamp_min(1e-12)
        dots = tag_embs @ img_emb
        # Plain dots/dots.sum() like the reference (ram/model_wrapper.py:
        # 39-64) — a negative sum divides by the NEGATIVE sum (clipping it
        # to +eps would blow weights up to ~1e12 with flipped sign); only
        # the exact-zero singularity is guarded, sign-preserving.
        s = torch.sum(dots)
        s = torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)
        weights = dots / s
        rec = torch.sum(tag_embs * weights[:, None], dim=0)
        return (rec, tags) if self.ret_concepts else rec
