"""ALBEF cross-modal fusion encoder and ITM head — the port of
srsem/explain/fusion.py.

ALBEF's multimodal text encoder (reference: additional_approaches/src/
albef/xbert.py, model_retrieval.py): a post-LN BERT (LayerNorm eps 1e-12,
exact GELU, a -1e9 mask bias as in JAX, not ``-inf``) whose layers from
``fusion_start`` on cross-attend to the ViT's patch sequence, topped by
the 2-class image-text matching (ITM) head.  The module names are HF's
(``embeddings.word_embeddings``, ``encoder.layer.N.{attention,
crossattention}.self.query``, ``itm_head``), the JAX tree's paths joined
by dots, so ``convert_albef_fusion``'s tree loads through
srsem_torch/utils/convert.py::load_albef_fusion and an HF-style state
dict loads as it is.  Plain PyTorch matrix products, float32.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.pseudo.text_embed import (
    _BertAttention,
    _Embeddings,
    reset_bert_parameters,
)
from srsem_torch.train.partition import unflatten_dict

Tensor = torch.Tensor


class _Attention(_BertAttention):
    """BERT's attention sublayer, self (``kv`` = ``x``) or cross."""

    def __init__(self, hidden: int, heads: int):
        super().__init__(hidden)
        self.heads = heads

    def forward(self, x: Tensor, kv: Tensor, mask: Tensor) -> Tensor:
        n, tq, c = x.shape

        def split(v):
            return v.view(n, v.shape[1], self.heads, -1).transpose(1, 2)

        q = split(self.self.query(x))
        k, v = split(self.self.key(kv)), split(self.self.value(kv))
        scores = q @ k.transpose(-1, -2) / math.sqrt(c // self.heads)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        attn = torch.softmax(scores + bias, dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(n, tq, c)
        return self.output.LayerNorm(x + self.output.dense(ctx))


class FusionBertLayer(nn.Module):
    """A BERT layer with optional cross-attention to image states
    (xbert.py's BertLayer with ``add_cross_attention``)."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 cross: bool = False):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.crossattention = _Attention(hidden, heads) if cross else None
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(hidden, intermediate)
        self.output = nn.Module()
        self.output.dense = nn.Linear(intermediate, hidden)
        self.output.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x: Tensor, mask: Tensor,
                image_states: Optional[Tensor] = None,
                image_mask: Optional[Tensor] = None) -> Tensor:
        x = self.attention(x, x, mask)
        if self.crossattention is not None:
            if image_states is None:
                raise ValueError("fusion layer requires image states")
            if image_mask is None:
                image_mask = torch.ones(image_states.shape[:2],
                                        device=image_states.device)
            x = self.crossattention(x, image_states, image_mask)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class AlbefFusionEncoder(nn.Module):
    """ALBEF's multimodal text encoder and ITM head: layers ``0 ..
    fusion_start - 1`` are text-only, the rest cross-attend to the image
    patch sequence (BERT-base: 6 of 12).  ``forward(input_ids,
    attention_mask, image_states, image_mask=None)`` → (sequence,
    itm_logits)."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 fusion_start: int = 6, max_position: int = 512):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden, max_position)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            FusionBertLayer(hidden, heads, intermediate,
                            cross=i >= fusion_start)
            for i in range(layers))
        self.itm_head = nn.Linear(hidden, 2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """BERT's init (normal(0, 0.02)), from ``generator``."""
        return reset_bert_parameters(self, generator)

    def forward(self, input_ids: Tensor, attention_mask: Tensor,
                image_states: Tensor, image_mask: Optional[Tensor] = None):
        e = self.embeddings
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = e.LayerNorm(e.word_embeddings(input_ids)
                        + e.position_embeddings(pos)[None]
                        + e.token_type_embeddings.weight[0])
        for layer in self.encoder.layer:
            x = layer(x, attention_mask, image_states, image_mask)
        return x, self.itm_head(x[:, 0])


class AlbefItmScorer:
    """P(match) per (image, text) pair.  ``vit_tokens_fn``: pixels → the
    ``(N, T_img, hidden)`` patch sequence (a 2-D one is one image's; one
    image is broadcast against several texts); ``tokenizer``: texts →
    {"input_ids", "attention_mask"}.  Returns numpy."""

    def __init__(self, encoder: AlbefFusionEncoder,
                 vit_tokens_fn: Callable[[Any], Any], tokenizer,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.encoder = encoder.eval().requires_grad_(False).to(self.device)
        self.vit_tokens_fn = vit_tokens_fn
        self.tokenizer = tokenizer

    @torch.no_grad()
    def __call__(self, pixels, texts) -> np.ndarray:
        tok = self.tokenizer(texts)
        as_ids = lambda k: torch.as_tensor(  # noqa: E731
            np.asarray(tok[k]), device=self.device).long()
        ids = as_ids("input_ids")
        states = torch.as_tensor(self.vit_tokens_fn(pixels),
                                 dtype=torch.float32, device=self.device)
        if states.dim() == 2:
            states = states[None]
        if states.shape[0] == 1 and ids.shape[0] > 1:
            states = states.expand(ids.shape[0], *states.shape[1:])
        logits = self.encoder(ids, as_ids("attention_mask"), states)[1]
        return torch.softmax(logits, dim=-1)[:, 1].cpu().numpy()


def convert_albef_fusion(sd: Mapping[str, Any],
                         itm_sd: Optional[Mapping[str, Any]] = None) -> Dict:
    """HF-style ALBEF ``text_encoder`` state dict (``text_encoder.`` /
    ``bert.`` prefixes or not) → the JAX package's AlbefFusionEncoder
    tree (numpy float32): ``embeddings.*``, ``encoder.layer.N.{attention,
    crossattention}.self.{query,key,value}``, ``...output.{dense,
    LayerNorm}``, ``intermediate.dense``, ``output.{dense,LayerNorm}``;
    ``itm_sd``: the ``itm_head`` Linear, else a zero head."""

    def strip(k: str) -> str:
        for p in ("text_encoder.", "bert."):
            if k.startswith(p):
                k = k[len(p):]
        return k

    from srsem_torch.utils.convert import _f32, _layer_norm, _linear, _n_layers

    sd = {strip(k): v for k, v in sd.items()}
    flat: Dict[tuple, np.ndarray] = {}
    for emb in ("word_embeddings", "position_embeddings",
                "token_type_embeddings"):
        flat[(f"embeddings.{emb}", "embedding")] = _f32(
            sd[f"embeddings.{emb}.weight"])
    _layer_norm(flat, ("embeddings.LayerNorm",), sd, "embeddings.LayerNorm")
    for i in range(_n_layers(sd, r"encoder\.layer\.(\d+)\.")):
        p = f"encoder.layer.{i}"
        for blk in ("attention", "crossattention"):
            if f"{p}.{blk}.self.query.weight" not in sd:
                continue
            for proj in ("query", "key", "value"):
                _linear(flat, (p, blk, f"self.{proj}"), sd,
                        f"{p}.{blk}.self.{proj}")
            _linear(flat, (p, blk, "output.dense"), sd,
                    f"{p}.{blk}.output.dense")
            _layer_norm(flat, (p, blk, "output.LayerNorm"), sd,
                        f"{p}.{blk}.output.LayerNorm")
        _linear(flat, (p, "intermediate.dense"), sd, f"{p}.intermediate.dense")
        _linear(flat, (p, "output.dense"), sd, f"{p}.output.dense")
        _layer_norm(flat, (p, "output.LayerNorm"), sd, f"{p}.output.LayerNorm")

    if itm_sd is not None:
        itm = {k.replace("itm_head.", ""): v for k, v in itm_sd.items()}
        _linear(flat, ("itm_head",), {f"itm_head.{k}": v
                                      for k, v in itm.items()}, "itm_head")
    else:
        width = _f32(sd["embeddings.LayerNorm.weight"]).shape[0]
        flat[("itm_head", "kernel")] = np.zeros((width, 2), np.float32)
        flat[("itm_head", "bias")] = np.zeros((2,), np.float32)
    return unflatten_dict(flat)
