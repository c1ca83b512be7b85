"""Text embedders for C2C scoring — the port of srsem/pseudo/text_embed.py.

* ``MiniLMEncoder`` — all-MiniLM-L6-v2: a post-LN BERT (LayerNorm eps
  1e-12, exact GELU; the -1e9 mask bias added to float32 scores) and a
  masked mean-pool (the count clamped at 1e-9) with an L2 norm, or the
  raw [CLS] state (``pool="cls"``).  Its parameters carry HF's names
  (``embeddings.word_embeddings.weight``, ``encoder.layer.N.attention.
  self.query.weight``, ...), so an HF ``BertModel`` state dict loads
  straight in (``load_hf_minilm``); ``convert_hf_minilm`` writes the JAX
  package's tree from one (``convert --kind minilm``).
* ``MiniLMEmbedder`` — batched embedding on a device, every batch padded
  to the static ``batch_size`` as in JAX.
* ``HashingTextEmbedder`` — the dependency-free fallback (a copy).
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class _BertSelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _BertAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.self = _BertSelfAttention(hidden)
        self.output = nn.Module()
        self.output.dense = nn.Linear(hidden, hidden)
        self.output.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)


class BertLayer(nn.Module):
    """Post-LN transformer encoder layer (BERT), HF's parameter names."""

    def __init__(self, hidden: int = 384, heads: int = 12,
                 intermediate: int = 1536):
        super().__init__()
        self.heads = heads
        self.attention = _BertAttention(hidden)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(hidden, intermediate)
        self.output = nn.Module()
        self.output.dense = nn.Linear(intermediate, hidden)
        self.output.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x: Tensor, mask: Tensor) -> Tensor:
        n, t, c = x.shape
        att = self.attention
        split = lambda v: v.view(n, t, self.heads, -1).transpose(1, 2)  # noqa: E731
        q, k, v = (split(lin(x)) for lin in (att.self.query, att.self.key,
                                             att.self.value))
        scores = q @ k.transpose(-1, -2) / math.sqrt(c // self.heads)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        attn = torch.softmax(scores.float() + bias, dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(n, t, c)
        x = att.output.LayerNorm(x + att.output.dense(ctx))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_position: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_position, hidden)
        self.token_type_embeddings = nn.Embedding(2, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)


class MiniLMEncoder(nn.Module):
    """all-MiniLM-L6-v2: (ids, mask) (N, T) → (N, hidden) embeddings."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 384,
                 layers: int = 6, heads: int = 12, intermediate: int = 1536,
                 max_position: int = 512, pool: str = "mean"):
        super().__init__()
        self.pool = pool
        self.embeddings = _Embeddings(vocab_size, hidden, max_position)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, heads, intermediate) for _ in range(layers))

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        n, t = input_ids.shape
        e = self.embeddings
        pos = torch.arange(t, device=input_ids.device)
        x = e.LayerNorm(e.word_embeddings(input_ids)
                        + e.position_embeddings(pos)[None]
                        + e.token_type_embeddings.weight[0])
        for layer in self.encoder.layer:
            x = layer(x, attention_mask)
        if self.pool == "cls":
            return x[:, 0]
        m = attention_mask[..., None].float()
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        return pooled / pooled.norm(dim=-1, keepdim=True)

    def reset_parameters(self, generator=None):
        """Normal(0, 0.02) weights and embeddings (BERT's init), zero
        biases, unit LayerNorms, from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
        return self


def _hf_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """HF BERT keys without a ``bert.`` / ``model.`` prefix, the pooler and
    ``position_ids`` left out."""
    out = {}
    for key, value in state_dict.items():
        key = key.replace("bert.", "").replace("model.", "")
        if key.startswith("pooler.") or key.endswith("position_ids"):
            continue
        out[key] = value
    return out


def load_hf_minilm(model: MiniLMEncoder, state_dict: Mapping[str, Any]
                   ) -> MiniLMEncoder:
    """An HF ``BertModel`` / sentence-transformers MiniLM state dict into
    ``model``, strictly.  Returns ``model``."""
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in _hf_keys(state_dict).items()})
    return model


def _np_of(v) -> np.ndarray:
    return np.asarray(getattr(v, "numpy", lambda: v)())


def convert_hf_minilm(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """HF torch ``all-MiniLM-L6-v2`` state dict → the JAX package's
    MiniLMEncoder param tree (numpy, each leaf's dtype kept): HF's module
    names verbatim (``embeddings.*`` at the top, ``encoder.layer.N`` then
    ``attention.self.query`` inside a layer), ``weight`` → ``scale`` for
    LayerNorms, ``embedding`` for embeddings, else ``kernel`` (in, out)."""
    tree: Dict[str, Any] = {}
    layer_re = re.compile(r"^encoder\.layer\.(\d+)\.(.+)$")
    for key, value in _hf_keys(state_dict).items():
        arr = _np_of(value)
        module, leaf = key.rsplit(".", 1)
        m = layer_re.match(module)
        path = (f"encoder.layer.{m.group(1)}", m.group(2)) if m else (module,)
        if leaf == "weight":
            if module.endswith("LayerNorm"):
                name = "scale"
            elif "embeddings" in module:
                name = "embedding"
            else:
                name, arr = "kernel", arr.T
        elif leaf == "bias":
            name = "bias"
        else:
            continue
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = arr
    return tree


class MiniLMEmbedder:
    """Batched caption embedder: ``encode(texts)`` → (N, hidden) float32
    numpy, each batch padded with empty strings to the static
    ``batch_size``."""

    def __init__(self, model: MiniLMEncoder, tokenizer, max_length: int = 128,
                 batch_size: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        outs = []
        for i in range(0, len(texts), self.batch_size):
            chunk = list(texts[i: i + self.batch_size])
            n = len(chunk)
            chunk += [""] * (self.batch_size - n)
            tok = self.tokenizer(chunk, padding="max_length", truncation=True,
                                 max_length=self.max_length,
                                 return_tensors="np")
            ids, mask = (torch.from_numpy(np.asarray(tok[k], np.int64))
                         .to(self.device) for k in ("input_ids",
                                                    "attention_mask"))
            outs.append(self.model(ids, mask)[:n].float().cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, 384))


class HashingTextEmbedder:
    """Deterministic offline fallback: word + char-trigram feature hashing
    into ``dim`` buckets, L2-normalized (a copy of the JAX package's)."""

    def __init__(self, dim: int = 384):
        self.dim = dim

    def _features(self, text: str) -> List[str]:
        words = re.findall(r"[a-z0-9]+", text.lower())
        grams = [w[i: i + 3] for w in words for i in range(max(1, len(w) - 2))]
        return words + grams

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for row, text in enumerate(texts):
            for feat in self._features(text):
                h = int.from_bytes(
                    hashlib.blake2s(feat.encode(), digest_size=8).digest(), "little")
                out[row, h % self.dim] += 1.0 if (h >> 63) else -1.0
        norms = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.clip(norms, 1e-9, None)
