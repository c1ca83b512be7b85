"""The plain CLIP ViT-B/16 image tower (Radford et al. 2021; ViT,
Dosovitskiy et al. 2021) over timm's ``vit_base_patch16_clip_224``
state-dict layout, and the reference's ViT token head
(models/global_eval_models.py:6-305), in ``torch`` operations.

The tower: a patch conv (stride = patch), the class token, the positional
table, ``norm_pre``, then pre-LN blocks: ``h += proj(attention(qkv(
norm1(h))))``, ``h += fc2(gelu(fc1(norm2(h))))`` with exact GELU, the
scores scaled by ``1 / sqrt(head width)`` and softmaxed over keys.  A
block's tap (timm's ``blocks.{l}.ls2``, the identity LayerScale) is the
MLP branch's output before its residual add.  LayerNorms and the residual
stream are float32.

``rounding.r`` rounds each value to the tower's dtype where a serving
tower in that dtype stores one: the input; the patch conv's output, and
its sum with the bias; the class token, the positional table and their
sum with the patch tokens; each Linear's output (its bias added in
float32 before the one rounding); each LayerNorm's output but
``norm_pre``'s; the scores, and the scores divided by ``sqrt(head
width)`` taken in the dtype; the softmax's output (float32 inside); the
weighted sum; GELU's output.  ``rounding.q`` rounds each Linear's and the
patch conv's input and weight (``r`` itself, or a control's lower
precision).  The residual stream and the taps stay float32.  In float32
every rounding is the identity.

Off the 14 x 14 training grid (inputs other than 224 px) the positional
table's grid is resized by ``F.interpolate``'s antialiased bilinear: the
triangle kernel at half-pixel centres, widened by the factor when
shrinking and normalised over the samples inside the grid, which is the
weighting of ``jax.image.resize(..., "bilinear")``; the class token's row
is kept.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.towers import Rounding, ident

Tensor = torch.Tensor
State = Dict[str, Tensor]


def block_taps(depth: int, blocks: int = 12, step: int = 3) -> Sequence[str]:
    """The ``depth + 1`` tapped blocks, every ``step``-th back from the
    last: ``blocks.{2,5,8,11}.ls2`` at depth 3 (the stages head, reference
    :116)."""
    last = blocks - 1
    return tuple(f"blocks.{last - step * i}.ls2" for i in range(depth, -1, -1))


def resize_pos(pos: Tensor, gh: int, gw: int) -> Tensor:
    """A ``(1, 1 + g*g, W)`` table on a ``gh`` x ``gw`` patch grid."""
    if pos.shape[1] == gh * gw + 1:
        return pos
    side = math.isqrt(pos.shape[1] - 1)
    grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                         align_corners=False, antialias=True)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


def layer_norm(x: Tensor, sd: State, key: str, eps: float = 1e-5) -> Tensor:
    """A float32 LayerNorm over the last axis."""
    return F.layer_norm(x, x.shape[-1:], sd[f"{key}.weight"],
                        sd[f"{key}.bias"], eps)


def vit_taps(x: Tensor, sd: State, names: Sequence[str], heads: int,
             prefix: str = "backbone.",
             rounding: Rounding = Rounding()) -> Dict[str, Tensor]:
    """NCHW float32 images → the float32 taps ``names``, each ``(N, 1 +
    patches, W)``; blocks after the last tap are not run."""
    p, r, q = prefix, rounding.r, rounding.q

    def linear(h: Tensor, key: str) -> Tensor:
        return r(F.linear(q(h), q(sd[f"{key}.weight"]),
                          r(sd[f"{key}.bias"])))

    w = sd[f"{p}patch_embed.proj.weight"]
    y = r(F.conv2d(q(r(x)), q(w), None, w.shape[-1]))
    y = r(y + r(sd[f"{p}patch_embed.proj.bias"]).view(1, -1, 1, 1))
    n, width, gh, gw = y.shape
    tokens = torch.cat([r(sd[f"{p}cls_token"]).expand(n, 1, width),
                        y.flatten(2).transpose(1, 2)], dim=1)
    h = r(tokens + r(resize_pos(sd[f"{p}pos_embed"], gh, gw)))
    h = layer_norm(h, sd, f"{p}norm_pre")
    t, hd = h.shape[1], width // heads
    scale = r(torch.tensor(float(hd), device=x.device)).sqrt()
    last = max(int(name.split(".")[1]) for name in names)
    taps = {}
    for blk in range(last + 1):
        k = f"{p}blocks.{blk}"
        qkv = linear(r(layer_norm(h, sd, f"{k}.norm1")), f"{k}.attn.qkv")
        qkv = qkv.reshape(n, t, 3, heads, hd)
        qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = r(r(qh @ kh.transpose(-1, -2)) / r(scale))
        att = r(torch.softmax(scores, dim=-1))
        o = r(att @ vh).transpose(1, 2).reshape(n, t, width)
        h = h + linear(o, f"{k}.attn.proj")
        m = r(F.gelu(linear(r(layer_norm(h, sd, f"{k}.norm2")),
                            f"{k}.mlp.fc1")))
        branch = linear(m, f"{k}.mlp.fc2")
        taps[f"blocks.{blk}.ls2"] = branch
        h = h + branch
    return {name: taps[name] for name in names}


def token_scores(taps_a: State, taps_b: State, sd: State,
                 names: Sequence[str], prefix: str = "aggregator.",
                 q: Callable = ident) -> Tensor:
    """(N,) scores: per tap the token mean of a Linear(W, 1) of the squared
    diff, the mean over taps, a ReLU; ``q`` rounds the diff and the weight
    (the identity, or a control's lower precision)."""
    per_tap = []
    for j, name in enumerate(names):
        d = q((taps_a[name] - taps_b[name]) ** 2)
        w = q(sd[f"{prefix}w_layers.{j}.weight"].reshape(-1, 1))
        b = sd[f"{prefix}w_layers.{j}.bias"][0]
        per_tap.append((d @ w)[..., 0].mean(dim=1) + b)
    return F.relu(torch.stack(per_tap).mean(dim=0))
