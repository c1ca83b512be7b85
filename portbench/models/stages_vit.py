"""A ViT regressor configuration (``"model": "stages_vit"``): the CLIP
ViT-B/16 tower with the stages token head on every third block, as the
port builds it (``make_global_model``, ``PairScorer`` through the eager
tower and the head kernel's token route) and as the plain reference
computes it (``reference/vit.py``)."""

from __future__ import annotations

from typing import List

import torch

from portbench.common.kernels import Work
from portbench.common.peaks import BYTES
from portbench.models import count_flops, meta_state
from portbench.models.stages_regressor import (  # noqa: F401 — the interface
    build,
    gap,
    image_size,
    port_config,
    tower_dtype,
)
from portbench.reference import heads, lowprec, towers, vit
from portbench.reference.layout import Spec

KIND = "global"
GAP = "score_gap"
STAGE_GAP = "head_gap"

#: The positional table's grid: the 224 px training grid of 16 px patches.
POS_GRID = 14
#: Linear and patch-conv biases; LayerNorm weights and biases.
BIAS = ("uniform", -0.1, 0.1)
LN_WEIGHT = ("uniform", 0.8, 1.2)
#: The token head's weights U(0, HEAD_SCALE / sqrt(W)) and bias: the
#: squared-diff term carries each score, and the final ReLU stays open.
HEAD_SCALE = 100.0
HEAD_BIAS = 1.01


def shape(cfg: dict) -> dict:
    """The tower's patch, width, blocks and heads (published by default)."""
    b = cfg["port_config"]["backbone"]
    return {"patch": b.get("vit_patch", 16), "width": b.get("vit_width", 768),
            "blocks": b.get("vit_depth", 12), "heads": b.get("vit_heads", 12)}


def tap_names(cfg: dict):
    return vit.block_taps(cfg["port_config"]["depth"], shape(cfg)["blocks"])


def tokens(cfg: dict) -> int:
    """Tokens a tower pass: the class token and the patches."""
    return 1 + (image_size(cfg) // shape(cfg)["patch"]) ** 2


def raw_layout(cfg: dict) -> List[Spec]:
    """timm's ``vit_base_patch16_clip_224`` keys under ``backbone.`` and the
    stages token head's ``aggregator.w_layers.{j}``.  LeCun-normal patch
    conv and Linear weights and near-unit LayerNorms keep the residual
    stream O(1) through the blocks; the class token and positional table
    are normal(0, 0.02), as timm draws them."""
    s, p = shape(cfg), "backbone."
    width, patch = s["width"], s["patch"]

    def linear(key, cout, cin):
        return [(f"{key}.weight", (cout, cin), ("normal", cin ** -0.5)),
                (f"{key}.bias", (cout,), BIAS)]

    def norm(key):
        return [(f"{key}.weight", (width,), LN_WEIGHT),
                (f"{key}.bias", (width,), BIAS)]

    fan_in = 3 * patch * patch
    out: List[Spec] = [
        (f"{p}patch_embed.proj.weight", (width, 3, patch, patch),
         ("normal", fan_in ** -0.5)),
        (f"{p}patch_embed.proj.bias", (width,), BIAS),
        (f"{p}cls_token", (1, 1, width), ("normal", 0.02)),
        (f"{p}pos_embed", (1, POS_GRID * POS_GRID + 1, width),
         ("normal", 0.02))] + norm(f"{p}norm_pre")
    for blk in range(s["blocks"]):
        k = f"{p}blocks.{blk}"
        out += (norm(f"{k}.norm1") + linear(f"{k}.attn.qkv", 3 * width, width)
                + linear(f"{k}.attn.proj", width, width) + norm(f"{k}.norm2")
                + linear(f"{k}.mlp.fc1", 4 * width, width)
                + linear(f"{k}.mlp.fc2", width, 4 * width))
    out += norm(f"{p}norm")
    for j in range(len(tap_names(cfg))):
        out.append((f"aggregator.w_layers.{j}.weight", (1, width),
                    ("uniform", 0.0, HEAD_SCALE * width ** -0.5)))
        out.append((f"aggregator.w_layers.{j}.bias", (1,),
                    ("const", HEAD_BIAS)))
    return out


class Reference:
    """Plain scores from uint8 NHWC arrays: the tower at the
    configuration's precision (a bfloat16 tower's rounding points,
    ``reference/vit.py``), the token head in float32 with TF32 off;
    ``control`` names a control of ``lowprec.CONTROLS`` computed in the
    program's place."""

    mean, std = heads.CLIP_MEAN, heads.CLIP_STD

    def __init__(self, cfg: dict, sd: dict, control=None):
        self.sd = sd
        self.names = tap_names(cfg)
        self.heads = shape(cfg)["heads"]
        self.prec = lowprec.Precision(tower_dtype(cfg), control)

    def taps(self, x_u8: torch.Tensor):
        x = towers.normalize(x_u8, self.mean, self.std)
        return vit.vit_taps(x, self.sd, self.names, self.heads,
                            rounding=self.prec.tower)

    def head(self, taps_a, taps_b):
        with self.prec.head_ctx():
            return vit.token_scores(taps_a, taps_b, self.sd, self.names,
                                    q=self.prec.head_q)


def flops(cfg: dict) -> dict:
    """Model FLOPs of one image's tower pass and of one pair's head, by
    the dtype the configuration states for each."""
    size = image_size(cfg)
    ref = Reference(cfg, meta_state(raw_layout(cfg)))
    x = torch.zeros(1, size, size, 3, dtype=torch.uint8, device="meta")
    tower, taps = count_flops(lambda: ref.taps(x))
    head, _ = count_flops(lambda: ref.head(taps, taps))
    return {"tower": (tower_dtype(cfg), tower), "pair": ("float32", head)}


def token_head(passes, pairs: int, taps: int, t: int, width: int,
               tap_dtype: str) -> Work:
    """The token head over ``taps`` taps of ``(t, width)`` from ``passes``
    tower passes and ``pairs`` scores: each tap element read once in
    ``tap_dtype``, the float32 weights and biases read once, the scores
    written once; a subtraction, a square and a multiply-add an element,
    float32 work (``common/kernels.py::stages_head``'s count on tokens)."""
    per_image = taps * t * width
    nbytes = (BYTES[tap_dtype] * per_image * sum(passes)
              + 4 * taps * (width + 1) + 4 * pairs)
    return 4 * per_image * pairs, nbytes, "float32"


def kernel_work(cfg: dict, passes, pairs: int, decodes: bool = True) -> dict:
    """The head kernel's work in one call (the tower has no hand-written
    kernel): float32 token taps, as the tower's residual stream leaves
    them."""
    return {"fused_head": [token_head(passes, pairs, len(tap_names(cfg)),
                                      tokens(cfg), shape(cfg)["width"],
                                      "float32")]}
