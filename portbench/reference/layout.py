"""The raw weight layouts both sides are given, and how the benchmark draws
them from a seed.

Keys follow torchvision's ``resnet50`` (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1..3}/bn{1..3}/downsample.{0,1}``), OpenAI CLIP's
``visual`` tower (three stem convs, the same block keys, ``attnpool``), the
reference's stages head (``w_layers.{j}``) and its CLIP_lpips_Unet decoder
(``decoder.{lvl}.{0: conv, 1: BN, 3: conv, 4: BN}``), under the model's
``backbone.`` / ``aggregator.`` prefixes.  A layout is a list of
``(key, shape, rule)``; a rule is ``("normal", std)``, ``("uniform", lo,
hi)``, ``("const", value)`` or ``("count",)`` (BatchNorm's
``num_batches_tracked``).

The rules are a frozen copy of the seeded models of ``chip_smoke.py``
(``randomize_bn``, ``seeded_model``, ``seeded_clu``): Kaiming-normal tower
convs, random frozen-BN statistics with small gammas on the BNs closing a
residual branch (activations stay O(1) through 16 blocks), nonnegative
stage-head weights scaled by 100 with a bias of 1.01 (the squared-diff
term carries each score and the final ReLU stays open), He-normal decoder
convs over fan-out, random decoder BN statistics, and a map head scaled by
0.1 with a bias of +0.5 (the sigmoid stays off its flat parts).
"""

from __future__ import annotations

import math
from typing import List, Tuple

Spec = Tuple[str, Tuple[int, ...], tuple]

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
STAGE_CHANNELS = (256, 512, 1024, 2048)
#: CLU decoder levels' tap channels, shallow to deep.
LEVEL_CHANNELS = (64, 256, 512, 1024, 2048)


def _conv(key: str, cout: int, cin: int, k: int) -> List[Spec]:
    return [(f"{key}.weight", (cout, cin, k, k),
             ("normal", math.sqrt(2.0 / (cin * k * k))))]


def _frozen_bn(key: str, c: int, closing: bool) -> List[Spec]:
    gamma = ("uniform", 0.1, 0.3) if closing else ("uniform", 0.5, 1.5)
    return [(f"{key}.weight", (c,), gamma),
            (f"{key}.bias", (c,), ("uniform", -0.5, 0.5)),
            (f"{key}.running_mean", (c,), ("uniform", -0.5, 0.5)),
            (f"{key}.running_var", (c,), ("uniform", 0.5, 1.5))]


def _blocks(prefix: str) -> List[Spec]:
    out: List[Spec] = []
    cin = 64
    for s, (blocks, width) in enumerate(zip(STAGE_BLOCKS, STAGE_WIDTHS)):
        for b in range(blocks):
            p = f"{prefix}layer{s + 1}.{b}"
            cout = width * 4
            out += _conv(f"{p}.conv1", width, cin, 1)
            out += _frozen_bn(f"{p}.bn1", width, False)
            out += _conv(f"{p}.conv2", width, width, 3)
            out += _frozen_bn(f"{p}.bn2", width, False)
            out += _conv(f"{p}.conv3", cout, width, 1)
            out += _frozen_bn(f"{p}.bn3", cout, True)
            if b == 0:
                out += _conv(f"{p}.downsample.0", cout, cin, 1)
                out += _frozen_bn(f"{p}.downsample.1", cout, True)
            cin = cout
    return out


def imagenet_resnet50(prefix: str = "backbone.") -> List[Spec]:
    """torchvision's ResNet-50 without its classifier."""
    return (_conv(f"{prefix}conv1", 64, 3, 7)
            + _frozen_bn(f"{prefix}bn1", 64, False) + _blocks(prefix))


def clip_resnet50(image_size: int, prefix: str = "backbone.",
                  width: int = 2048, embed_dim: int = 1024) -> List[Spec]:
    """OpenAI CLIP's modified ResNet-50 image tower."""
    out: List[Spec] = []
    for i, (cin, cout) in enumerate(((3, 32), (32, 32), (32, 64)), 1):
        out += _conv(f"{prefix}conv{i}", cout, cin, 3)
        out += _frozen_bn(f"{prefix}bn{i}", cout, False)
    out += _blocks(prefix)
    spatial = image_size // 32
    a = f"{prefix}attnpool"
    out.append((f"{a}.positional_embedding", (spatial * spatial + 1, width),
                ("normal", width ** -0.5)))
    for name, cout in (("k_proj", width), ("q_proj", width),
                       ("v_proj", width), ("c_proj", embed_dim)):
        out.append((f"{a}.{name}.weight", (cout, width),
                    ("normal", width ** -0.5)))
        out.append((f"{a}.{name}.bias", (cout,), ("const", 0.0)))
    return out


def stages_head(channels, prefix: str = "aggregator.") -> List[Spec]:
    """The stages head: ``w_layers.{j}`` = Conv2d(C_j, 1, 1)."""
    out: List[Spec] = []
    for j, c in enumerate(channels):
        out.append((f"{prefix}w_layers.{j}.weight", (1, c, 1, 1),
                    ("uniform", 0.0, 100.0 * c ** -0.5)))
        out.append((f"{prefix}w_layers.{j}.bias", (1,), ("const", 1.01)))
    return out


def _bn(key: str, c: int) -> List[Spec]:
    return _frozen_bn(key, c, False) + [(f"{key}.num_batches_tracked", (),
                                         ("count",))]


def clu_decoder(prefix: str = "decoder.") -> List[Spec]:
    """The CLU decoder (v1): level ``l`` takes [diff l, upsampled l+1]."""
    out: List[Spec] = []
    for lvl, ch in enumerate(LEVEL_CHANNELS):
        up = LEVEL_CHANNELS[lvl + 1] if lvl < 4 else 0
        cin = ch + up
        p = f"{prefix}{lvl}"
        mid, cout, k = (64, 1, 1) if lvl == 0 else (ch, ch, 3)
        out.append((f"{p}.0.weight", (mid, cin, 3, 3),
                    ("normal", math.sqrt(2.0 / (mid * 9)))))
        out.append((f"{p}.0.bias", (mid,), ("const", 0.0)))
        out += _bn(f"{p}.1", mid)
        std = math.sqrt(2.0 / (cout * k * k))
        if lvl == 0:  # the map head, scaled to keep the sigmoid live
            out.append((f"{p}.3.weight", (cout, mid, k, k),
                        ("normal", 0.1 * std)))
            out.append((f"{p}.3.bias", (cout,), ("const", 0.5)))
        else:
            out.append((f"{p}.3.weight", (cout, mid, k, k), ("normal", std)))
            out.append((f"{p}.3.bias", (cout,), ("const", 0.0)))
            out += _bn(f"{p}.4", cout)
    return out
