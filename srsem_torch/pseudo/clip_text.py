"""CLIP text tower and the dual encoder — the port of
srsem/pseudo/clip_text.py.

The OpenAI CLIP text transformer: token and positional embeddings, pre-LN
residual blocks (float32 LayerNorms, eps 1e-5; a causal -1e9 mask; the
softmax in float32; QuickGELU ``x·sigmoid(1.702x)``), a final LayerNorm,
the features at the EOT position (``argmax(ids)``, the highest token id)
and ``feats @ text_projection`` with the projection stored (width,
embed_dim).  The parameters carry OpenAI's names
(``transformer.resblocks.N.attn.in_proj_weight``, ``ln_final``, ...), so
an OpenAI CLIP state dict's text keys load straight in; the JAX package's
tree loads through ``load_jax_clip_text``.

``ClipDualEncoder`` pairs it with the port's CLIP ResNet-50 image tower,
frozen, through the fused tower (folded once): the C2I image embedding.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class _Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameter layout (fused ``in_proj``)."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class ClipTextBlock(nn.Module):
    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, 4 * width)
        self.mlp.c_proj = nn.Linear(4 * width, width)

    def _dense(self, h: Tensor, w: Tensor, b: Tensor) -> Tensor:
        return F.linear(h, w.to(self.dtype), b.to(self.dtype))

    def forward(self, x: Tensor, causal_mask: Tensor) -> Tensor:
        n, t, c = x.shape
        h = self.ln_1(x.float()).to(self.dtype)
        qkv = self._dense(h, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = qkv.view(n, t, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        scores = q @ k.transpose(-1, -2) / math.sqrt(c // self.heads)
        attn = torch.softmax((scores + causal_mask).float(), dim=-1)
        h = (attn.to(self.dtype) @ v).transpose(1, 2).reshape(n, t, c)
        out = self.attn.out_proj
        x = x + self._dense(h, out.weight, out.bias).to(x.dtype)
        h = self.ln_2(x.float()).to(self.dtype)
        h = self._dense(h, self.mlp.c_fc.weight, self.mlp.c_fc.bias)
        h = h * torch.sigmoid(1.702 * h)
        return x + self._dense(h, self.mlp.c_proj.weight,
                               self.mlp.c_proj.bias).to(x.dtype)


class ClipTextEncoder(nn.Module):
    """token ids (N, T) → joint-space embedding (N, embed_dim), float32."""

    def __init__(self, vocab_size: int = 49408, width: int = 512,
                 layers: int = 12, heads: int = 8, context: int = 77,
                 embed_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ClipTextBlock(width, heads, dtype) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers from ``generator``: normal(0, 1) token
        embeddings, normal(0.01) positions, normal(0.02) projection,
        LeCun-normal Dense kernels, zero biases, unit LayerNorms."""
        with torch.no_grad():
            self.token_embedding.weight.normal_(0.0, 1.0, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, 0.02, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, m.in_features ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
                elif isinstance(m, _Attention):
                    m.in_proj_weight.normal_(
                        0.0, m.in_proj_weight.shape[1] ** -0.5,
                        generator=generator)
                    m.in_proj_bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
        return self

    def forward(self, ids: Tensor) -> Tensor:
        n, t = ids.shape
        x = (self.token_embedding(ids).to(self.dtype)
             + self.positional_embedding[:t].to(self.dtype))
        causal = torch.triu(torch.full((t, t), -1e9, device=ids.device),
                            diagonal=1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x.float())
        feats = x[torch.arange(n, device=ids.device), ids.argmax(dim=-1)]
        return feats @ self.text_projection


def load_jax_clip_text(model: ClipTextEncoder, params: Mapping[str, Any]
                       ) -> ClipTextEncoder:
    """The JAX package's ClipTextEncoder tree (Dense kernels (in, out),
    the fused ``attn.qkv``) into ``model``, strictly."""
    def t(v, transpose=False):
        a = np.array(v, np.float32)
        return torch.from_numpy(a.T.copy() if transpose else a)

    sd = {"token_embedding.weight": t(params["token_embedding"]["embedding"]),
          "positional_embedding": t(params["positional_embedding"]),
          "text_projection": t(params["text_projection"]),
          "ln_final.weight": t(params["ln_final"]["scale"]),
          "ln_final.bias": t(params["ln_final"]["bias"])}
    names = {"attn.qkv": "attn.in_proj_", "attn.out_proj": "attn.out_proj.",
             "mlp.c_fc": "mlp.c_fc.", "mlp.c_proj": "mlp.c_proj.",
             "ln_1": "ln_1.", "ln_2": "ln_2."}
    for name, block in params.items():
        if not name.startswith("resblocks."):
            continue
        prefix = f"transformer.{name}."
        for jax_mod, leaves in block.items():
            for leaf, v in leaves.items():
                key = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
                sd[prefix + names[jax_mod] + key] = t(v, leaf == "kernel")
    model.load_state_dict(sd, strict=True)
    return model


class ClipDualEncoder:
    """Image and text towers sharing CLIP's joint space (C2I scoring).

    ``image_model``: the port's ``ClipResNet50`` (frozen; its fused tower
    folded once); ``text_model``: a ClipTextEncoder (seeded with
    ``init_text`` when None); ``tokenizer``: texts → ids (N, context)."""

    def __init__(self, image_model, text_model: Optional[ClipTextEncoder] = None,
                 embed_dim: int = 1024, tokenizer=None, context: int = 77,
                 device: DeviceLike = None):
        from srsem_torch.backbones.fused_resnet import fold_tower

        self.device = resolve_device(device)
        self.image_model = image_model.eval().to(self.device)
        self.folded = fold_tower(self.image_model, self.image_model.dtype)
        self.embed_dim, self.context = embed_dim, context
        self.text_model = (text_model.eval().to(self.device)
                           if text_model is not None else None)
        self.tokenizer = tokenizer

    def init_text(self, generator: Optional[torch.Generator] = None) -> None:
        self.text_model = ClipTextEncoder(
            embed_dim=self.embed_dim, context=self.context).reset_parameters(
            generator).eval().to(self.device)

    @torch.no_grad()
    def encode_image(self, images) -> Tensor:
        """Normalized NHWC images → (N, embed_dim) on the device."""
        from srsem_torch.backbones.fused_resnet import fused_clip_apply

        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        emb, _ = fused_clip_apply(self.image_model, x, self.image_model.dtype,
                                  folded=self.folded)
        return emb

    @torch.no_grad()
    def encode_text_ids(self, ids) -> Tensor:
        return self.text_model(torch.as_tensor(np.asarray(ids),
                                               device=self.device).long())

    def encode_text(self, texts) -> Tensor:
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer configured; pass token ids to encode_text_ids "
                "or supply a tokenizer (e.g. ClipBpeTokenizer)")
        ids = self.tokenizer(texts)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        return self.encode_text_ids(ids)

