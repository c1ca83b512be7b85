"""CLIP ViT-B/16 visual tower with per-block residual-branch taps — the port
of srsem/backbones/vit.py.

The reference's ViT heads hook ``blocks.{l}.ls2``, timm's LayerScale after
the MLP branch (reference: models/global_eval_models.py:19,116,218); for
CLIP checkpoints it is the identity, so the tap is the MLP residual
branch's output before the residual add, ``(batch, 1 + patches, width)``.

The module names are timm's ``vit_base_patch16_clip_224`` state-dict names
(``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``norm_pre``,
``blocks.{l}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``),
so a timm state dict loads as it is (srsem_torch/utils/convert.py).

Casts follow the JAX package exactly:

* the patch conv and every Linear compute in the compute dtype, their
  float32 parameters cast down;
* every LayerNorm runs in float32, so after ``norm_pre`` the residual
  stream is float32, every ``x + branch`` is float32, and the taps (the
  branches cast to the stream's dtype) are float32; without ``norm_pre``
  (ALBEF's DeiT towers) the stream stays in the compute dtype;
* attention: the scores' matrix product and the division by
  ``sqrt(head_dim)`` in the compute dtype, the softmax in float32, cast
  back.  Plain PyTorch matrix products, as the JAX package leaves
  attention to XLA: no attention kernel;
* GELU is exact; ``quick_gelu`` (OpenAI checkpoints) stays an option,
  which ``make_backbone`` never passes, as in JAX.

The positional table is always the 14x14 + 1 training grid and is
interpolated to the input's patch grid on every call.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.ops.image import interpolate_pos_embed

Tensor = torch.Tensor


def vit_block_taps(depth: int, total: int = 12, step: int = 1) -> Tuple[str, ...]:
    """Tap names for the ``depth`` deepest blocks (optionally strided):
    ``blocks.{11-depth..11}.ls2`` (reference: models/global_eval_models.py:19)
    or every 3rd block (reference: models/global_eval_models.py:116)."""
    last = total - 1
    return tuple(f"blocks.{l}.ls2" for l in range(last - (depth * step), last + 1, step)
                 if l >= 0)


def _act(name: str, h: Tensor) -> Tensor:
    if name == "gelu":
        return F.gelu(h)
    if name == "quick_gelu":
        # OpenAI CLIP's activation: x·sigmoid(1.702x).
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(f"unknown act {name!r}")


def _linear(h: Tensor, layer: nn.Linear) -> Tensor:
    """``layer`` in ``h``'s dtype (the compute dtype), its float32
    parameters cast down."""
    return F.linear(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype))


def _layer_norm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """A float32 LayerNorm (flax's ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class _Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, patch)


class ViTBlock(nn.Module):
    """Pre-LN transformer block; ``forward`` returns the stream after the
    attention residual and the MLP branch (the ``ls2`` tap), which the
    tower adds."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 act: str = "gelu", ln_eps: float = 1e-5):
        super().__init__()
        self.heads, self.dtype, self.act = heads, dtype, act
        # sqrt(head_dim) rounded to the compute dtype, as jnp.sqrt of it.
        self.scale = float(torch.tensor(float(width // heads), dtype=dtype).sqrt())
        self.norm1 = nn.LayerNorm(width, eps=ln_eps)
        self.attn = _Attention(width)
        self.norm2 = nn.LayerNorm(width, eps=ln_eps)
        self.mlp = _Mlp(width)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        n, t, c = x.shape
        hd = c // self.heads
        h = _layer_norm(x, self.norm1).to(self.dtype)
        qkv = _linear(h, self.attn.qkv).reshape(n, t, 3, self.heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (n,h,t,d)
        attn = (q @ k.transpose(-1, -2)) / self.scale
        # The float32 softmax upcasts its input itself: one pass fewer.
        attn = torch.softmax(attn, dim=-1, dtype=torch.float32).to(self.dtype)
        h = (attn @ v).transpose(1, 2).reshape(n, t, c)
        # The sum promotes the compute-dtype branch to the stream's dtype
        # (JAX casts it first: the same values, one pass fewer).
        x = x + _linear(h, self.attn.proj)
        h = _layer_norm(x, self.norm2).to(self.dtype)
        h = _act(self.act, _linear(h, self.mlp.fc1))
        return x, _linear(h, self.mlp.fc2).to(x.dtype)


class ClipViT(nn.Module):
    """NHWC images → ``(class-token embedding, {"blocks.{l}.ls2": tap})``;
    the embedding is the final LayerNorm's class token, float32."""

    def __init__(self, patch: int = 16, width: int = 768, depth: int = 12,
                 heads: int = 12, dtype: torch.dtype = torch.bfloat16,
                 pos_grid: int = 14, act: str = "gelu",
                 use_norm_pre: bool = True, ln_eps: float = 1e-5):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.patch_embed = _PatchEmbed(patch, width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1,
                                                  width))
        self.norm_pre = (nn.LayerNorm(width, eps=ln_eps) if use_norm_pre
                         else None)
        self.blocks = nn.ModuleList(
            ViTBlock(width, heads, dtype, act, ln_eps) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=ln_eps)

    def reset_parameters(self, generator=None) -> None:
        """Fresh weights, as the Flax init draws them: LeCun-normal patch
        conv and Linear kernels, zero biases, unit LayerNorms, normal(0,
        0.02) class token and positional table."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                     generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
        n = x.shape[0]
        dt = self.dtype
        proj = self.patch_embed.proj
        patches = F.conv2d(x.to(dt).permute(0, 3, 1, 2), proj.weight.to(dt),
                           proj.bias.to(dt), stride=self.patch)
        gh, gw = patches.shape[2:]
        tokens = patches.flatten(2).transpose(1, 2)  # (n, gh*gw, width)
        cls = self.cls_token.to(dt).expand(n, 1, tokens.shape[-1])
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + interpolate_pos_embed(self.pos_embed, (gh, gw)).to(dt)
        if self.norm_pre is not None:
            tokens = _layer_norm(tokens, self.norm_pre)
        taps: Dict[str, Tensor] = {}
        for l, block in enumerate(self.blocks):
            x_attn, branch = block(tokens)
            taps[f"blocks.{l}.ls2"] = branch
            tokens = x_attn + branch
        return _layer_norm(tokens, self.norm)[:, 0], taps
