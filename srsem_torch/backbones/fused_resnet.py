"""Fused serving ResNet-50 towers — the port of srsem/backbones/fused_resnet.py.

Functions over the SAME ``ImageNetResNet50`` / ``ClipResNet50`` modules
(srsem_torch/backbones/resnet.py) that route the stride-1 interior
bottlenecks through the Hopper kernel (srsem_torch/ops/fused_bottleneck.py)
with frozen BN folded into the conv weights.  A stride-1 ``ClipBottleneck``
is the same block as the ImageNet one, so both towers use the one kernel.
The stems, pools, the four downsampling blocks and CLIP's attention pool
stay plain PyTorch (cuDNN), as the JAX package leaves them to XLA.  Serving
only: no LoRA, no tap offsets.  Same ``(embedding, taps)`` contract and tap
names as the modules.

``DEFAULT_FUSE_STAGES = (0, 1, 2, 3)`` differs from the JAX package's
``(1, 2, 3)`` on purpose.  The JAX default leaves stage 0 out because its
whole-image TPU kernel crashed the Mosaic compiler at 56x56x256, and makes
the whole fused tower opt-in because it measured slower than XLA on a TPU.
Neither reason carries over: on Hopper the kernel runs any stage (h1 and
h2 go through memory), and the port's main path is meant to run its
kernels.
Stage 0 keeps the JAX package's routing through the halo-tiled wrapper
(``TILED_STAGE_ROWS``), the configuration that
tests/test_fused_bottleneck.py::test_fused_tower_stage0_tiled_matches_flax
pins in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from srsem_torch.backbones.resnet import (
    CLIP_STEM_TAP,
    IMAGENET_STAGE_TAPS,
    IMAGENET_STEM_TAP,
    conv_nchw,
    to_nchw,
    to_nhwc,
)
from srsem_torch.ops.fused_bottleneck import (
    bottleneck_weights,
    fold_bn_into_conv,
    fused_bottleneck,
    fused_bottleneck_tiled,
    pack_weights,
)

Tensor = torch.Tensor

#: Stages whose interior blocks (b >= 1) run the fused kernel.
DEFAULT_FUSE_STAGES = (0, 1, 2, 3)

#: Row tile per stage for the halo-tiled wrapper when that stage is fused.
TILED_STAGE_ROWS = {0: 8}


#: JAX's message (srsem/eval/scorer.py:58-63) for a fused tower asked of a
#: tower it cannot serve.
FROZEN_BASE_ONLY = ("fused_tower serves the frozen base tower only — it "
                    "folds BN into conv weights and carries no LoRA deltas")


#: The refusal of a fused tower for a tower sharded over the model axis.
SHARDED_TOWER = ("fused_tower folds whole conv weights; a tower sharded "
                 "over the model axis runs as its module")


#: The towers the fused tower serves.
RESNET_KINDS = ("resnet50", "resnet50_clip")


def resolve_fused_tower(requested: Optional[bool], frozen_base: bool,
                        kind: str, sharded: bool = False) -> bool:
    """Whether to run the fused tower: ``requested``, or when None exactly
    when the tower is the frozen base tower (no LoRA factors, no
    gradients) of a ResNet.  ``True`` for any other tower raises JAX's
    ``ValueError``: the ViT has no bottleneck, and the folded weights
    carry no LoRA delta and would go stale under training.  A tower
    ``sharded`` over the model axis (srsem_torch/parallel/sharding.py)
    holds slices of its convs, which the kernels cannot fold: it runs as
    its module, and ``True`` raises."""
    if kind not in RESNET_KINDS:
        if requested:
            raise ValueError(f"fused_tower needs a ResNet backbone, got "
                             f"{kind!r}")
        return False
    if sharded:
        if requested:
            raise ValueError(SHARDED_TOWER)
        return False
    if requested is None:
        return frozen_base
    if requested and not frozen_base:
        raise ValueError(FROZEN_BASE_ONLY)
    return bool(requested)


def _fold_conv(conv, bn, dtype: torch.dtype):
    """conv + frozen BN folded into one conv and a bias, cast to ``dtype``."""
    w, b = fold_bn_into_conv(conv.weight, bn)
    return w.to(dtype), b.to(dtype).view(1, -1, 1, 1), conv.stride, conv.padding


def fold_tower(model, dtype: torch.dtype = torch.bfloat16,
               fuse_stages: Tuple[int, ...] = DEFAULT_FUSE_STAGES
               ) -> List[list]:
    """BN-folded weights of every block of ``model`` (either ResNet tower),
    cast once: per stage a list of ``("fused", Packed)`` (the kernel's
    K-major layout in ``dtype``, float32 biases: a call copies no weights)
    or ``("plain", (stride, [conv, ...]))`` entries.  The tower is frozen,
    so a scorer folds once and reuses the result (the JAX tower folds
    inside every jitted call instead)."""
    stages = []
    for s, blocks in enumerate(model.stages()):
        folded = []
        for b, block in enumerate(blocks):
            if b > 0 and s in fuse_stages:
                folded.append(("fused", pack_weights(bottleneck_weights(block),
                                                     dtype)))
            else:  # downsample block, or a stage left on cuDNN
                convs = [(block.conv1, block.bn1), (block.conv2, block.bn2),
                         (block.conv3, block.bn3)]
                if block.downsample is not None:
                    convs.append(tuple(block.downsample)[-2:])
                # CLIP blocks avg-pool instead of striding their convs.
                pool = getattr(block, "stride", 1)
                folded.append(("plain", (pool, [_fold_conv(c, bn, dtype)
                                                for c, bn in convs])))
        stages.append(folded)
    return stages


def _plain_block(weights, x: Tensor) -> Tensor:
    pool, convs = weights

    def conv(i: int, v: Tensor, relu: bool = True) -> Tensor:
        w, b, stride, padding = convs[i]
        y = F.conv2d(v, w, None, stride, padding) + b
        return F.relu(y) if relu else y

    h = conv(1, conv(0, x))
    if pool > 1:
        h = F.avg_pool2d(h, pool)
        x = F.avg_pool2d(x, pool)
    h = conv(2, h, relu=False)
    if len(convs) == 4:
        x = conv(3, x, relu=False)
    return F.relu(h + x)


def _fused_block(weights, x: Tensor, row_tile: Optional[int] = None) -> Tensor:
    h = x.shape[2]
    xn = to_nhwc(x)
    if row_tile and h // row_tile >= 2 and h % row_tile == 0:
        y = fused_bottleneck_tiled(xn, weights, row_tile=row_tile)
    else:
        y = fused_bottleneck(xn, weights)
    return to_nchw(y)


def _blocks(folded: List[list], h: Tensor):
    """Run the folded stages on ``h``; yield ``(stage, block, output)``."""
    for s, blocks in enumerate(folded):
        for b, (kind, weights) in enumerate(blocks):
            if kind == "fused":
                h = _fused_block(weights, h, TILED_STAGE_ROWS.get(s))
            else:
                h = _plain_block(weights, h)
            yield s, b, h


def fused_imagenet_apply(
    model, x: Tensor, dtype: torch.dtype = torch.bfloat16,
    fuse_stages: Tuple[int, ...] = DEFAULT_FUSE_STAGES,
    folded: Optional[List[list]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ImageNetResNet50 forward on NHWC ``x`` with fused interior blocks.

    ``folded`` is ``fold_tower(model, dtype, fuse_stages)``, computed
    here when not given.  Rounding points follow the JAX tower: the input
    is cast to ``dtype``, and the stem BN affine is applied in ``dtype``
    (fused_resnet.py:157-163).
    """
    if folded is None:
        folded = fold_tower(model, dtype, fuse_stages)
    taps: Dict[str, Tensor] = {}
    h = to_nchw(x.to(dtype))
    stem = conv_nchw(h, model.conv1)
    taps[IMAGENET_STEM_TAP] = to_nhwc(stem)  # reference hooks the bare conv
    h = F.relu(model.bn1(stem))
    h = F.max_pool2d(h, 3, 2, 1)
    for s, b, h in _blocks(folded, h):
        if b == 2:
            taps[IMAGENET_STAGE_TAPS[s]] = to_nhwc(h)
    return h.mean(dim=(2, 3)), taps


def fused_clip_apply(
    model, x: Tensor, dtype: torch.dtype = torch.bfloat16,
    fuse_stages: Tuple[int, ...] = DEFAULT_FUSE_STAGES,
    folded: Optional[List[list]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ClipResNet50 forward on NHWC ``x`` with fused interior blocks
    (fused_resnet.py:180-210): the module's stem (in ``dtype``), the
    avg-pool, the stages, the module's attention pool."""
    if folded is None:
        folded = fold_tower(model, dtype, fuse_stages)
    h = model.stem(x.to(dtype))
    taps: Dict[str, Tensor] = {CLIP_STEM_TAP: to_nhwc(h)}
    h = F.avg_pool2d(h, 2)
    for s, b, h in _blocks(folded, h):
        if b < 3:
            taps[f"stages.{s}.{b}.act"] = to_nhwc(h)
    return model.attnpool(h), taps


def fused_apply(kind: str, model, x: Tensor,
                dtype: torch.dtype = torch.bfloat16,
                fuse_stages: Tuple[int, ...] = DEFAULT_FUSE_STAGES,
                folded: Optional[List[list]] = None):
    """Dispatch on backbone kind (``"resnet50"`` | ``"resnet50_clip"``)."""
    if kind == "resnet50":
        return fused_imagenet_apply(model, x, dtype, fuse_stages, folded)
    if kind == "resnet50_clip":
        return fused_clip_apply(model, x, dtype, fuse_stages, folded)
    raise ValueError(f"no fused tower for backbone kind {kind!r}")
