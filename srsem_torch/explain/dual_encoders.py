"""SLIP / ALBEF dual-encoder backends for the embedder suite — the port of
srsem/explain/dual_encoders.py.

* ``SlipDualEncoder`` — a ClipViT's class-token embedding ``@
  image_proj`` (SLIP's 512-d joint space); text: a ClipTextEncoder, then
  the optional ``text_proj``;
* ``AlbefDualEncoder`` — ALBEF's unimodal joint space (256-d): image =
  L2-normalized ``vision_proj(ViT CLS)`` on ALBEF's DeiT-style tower
  (``albef_vit``: no pre-norm, LayerNorm eps 1e-6, a 24x24 positional
  grid for 384 px, float32), text = L2-normalized ``text_proj(BERT CLS)``
  on a BERT-base in CLS-pool mode (``albef_bert``); both projections are
  biased Linears (reference: albef/model_wrapper.py:93-110).

Both satisfy the ``encode_image`` / ``encode_text`` protocol of
srsem_torch/explain/embedders.py::EmbedderSuite.  Like ClipDualEncoder,
they take port modules (not variable trees) and a ``device`` (default the
card), and return tensors there.  srsem_torch/utils/convert.py's
``load_slip`` / ``load_albef`` carry ``convert --kind slip`` / ``--kind
albef`` trees into them.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from srsem_torch.backbones.vit import ClipViT
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.pseudo.text_embed import MiniLMEncoder
from srsem_torch.utils.convert import _tensor

Tensor = torch.Tensor


def _f32(v, device: torch.device) -> Tensor:
    """A float32 copy on ``device`` of an array or a tensor."""
    return _tensor(v).to(device)


def _as_proj(proj, device: torch.device) -> Tuple[Tensor, Tensor]:
    """A bare (in, out) matrix, a {"kernel", "bias"} dict (convert_albef's
    layout) or a (kernel, bias) pair → (kernel, bias) on ``device``."""
    if isinstance(proj, Mapping):
        return _f32(proj["kernel"], device), _f32(proj["bias"], device)
    if isinstance(proj, (tuple, list)):
        return _f32(proj[0], device), _f32(proj[1], device)
    w = _f32(proj, device)
    return w, torch.zeros(w.shape[-1], device=device)


def _module(m: Optional[nn.Module], device: torch.device):
    return None if m is None else m.eval().requires_grad_(False).to(device)


class SlipDualEncoder:
    """SLIP ViT-B/16 joint space (512-d).  ``vit``: the port's ClipViT
    (bf16 by default, as JAX's ``ClipViT()``); ``text_encoder``: a
    ClipTextEncoder; ``tokenizer``: texts → ids (or a dict with
    ``input_ids``)."""

    def __init__(self, vit: ClipViT, image_proj, text_encoder=None,
                 text_proj=None, tokenizer=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vit = _module(vit, self.device)
        self.image_proj = _f32(image_proj, self.device)
        self.text_encoder = _module(text_encoder, self.device)
        self.text_proj = (_f32(text_proj, self.device)
                          if text_proj is not None else None)
        self.tokenizer = tokenizer

    @torch.no_grad()
    def encode_image(self, pixels) -> Tensor:
        x = torch.as_tensor(pixels, dtype=torch.float32, device=self.device)
        return self.vit(x)[0] @ self.image_proj

    @torch.no_grad()
    def encode_text(self, texts) -> Tensor:
        if self.text_encoder is None or self.tokenizer is None:
            raise RuntimeError("SLIP text tower not configured")
        ids = self.tokenizer(texts)
        if isinstance(ids, Mapping):
            ids = ids["input_ids"]
        emb = self.text_encoder(torch.as_tensor(
            np.asarray(ids), device=self.device).long())
        return emb @ self.text_proj if self.text_proj is not None else emb


def albef_vit(dtype: torch.dtype = torch.float32) -> ClipViT:
    """ALBEF's DeiT-style ViT-B/16 (reference albef/vit.py:97-141): no
    pre-norm, LayerNorm eps 1e-6, a 24x24 positional grid (384 px), exact
    GELU, float32."""
    return ClipViT(use_norm_pre=False, ln_eps=1e-6, pos_grid=24, act="gelu",
                   dtype=dtype)


def albef_bert() -> MiniLMEncoder:
    """ALBEF's text side: a 12-layer BERT-base in CLS-pool mode."""
    return MiniLMEncoder(hidden=768, layers=12, heads=12, intermediate=3072,
                         pool="cls")


class AlbefDualEncoder:
    """ALBEF unimodal joint space (256-d): L2-normalized ``vision_proj(ViT
    CLS)`` and ``text_proj(BERT CLS)``.  ``vit``: ``albef_vit()`` when
    None; ``bert``: a MiniLMEncoder (``albef_bert()``), None for an
    image-only encoder; ``tokenizer``: texts → {"input_ids",
    "attention_mask"}.  The projections take ``_as_proj``'s layouts."""

    def __init__(self, vit: Optional[ClipViT], vision_proj: Any,
                 bert: Optional[MiniLMEncoder] = None, text_proj=None,
                 tokenizer=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vit = _module(vit if vit is not None else albef_vit(),
                           self.device)
        self.vision_proj = _as_proj(vision_proj, self.device)
        self.bert = _module(bert, self.device)
        self.text_proj = (_as_proj(text_proj, self.device)
                          if text_proj is not None else None)
        self.tokenizer = tokenizer

    @torch.no_grad()
    def encode_image(self, pixels) -> Tensor:
        x = torch.as_tensor(pixels, dtype=torch.float32, device=self.device)
        w, b = self.vision_proj
        emb = self.vit(x)[0] @ w + b
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    @torch.no_grad()
    def encode_text(self, texts) -> Tensor:
        if self.bert is None or self.tokenizer is None:
            raise RuntimeError("ALBEF text tower not configured")
        tok = self.tokenizer(texts)
        as_ids = lambda k: torch.as_tensor(  # noqa: E731
            np.asarray(tok[k]), device=self.device).long()
        emb = self.bert(as_ids("input_ids"), as_ids("attention_mask"))
        if self.text_proj is None:
            return emb
        w, b = self.text_proj
        emb = emb @ w + b
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
