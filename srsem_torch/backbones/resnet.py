"""ImageNet ResNet-50 feature-pyramid backbone — the port of
srsem/backbones/resnet.py::ImageNetResNet50.

Classic torchvision/timm ``resnet50``: 7x7/2 stem, 3x3/2 max-pool, four
bottleneck stages with the stride on the 3x3 conv (reference:
models/global_eval_models.py:695-698).  ``forward`` takes NHWC images and
returns ``(pooled, taps)`` with NHWC taps under the reference's
forward-hook names: ``"conv1"`` (the RAW stem conv, before BN —
resnet.py:251-252) and ``"layer{i}.2.act3"`` (third block's post-residual
ReLU of each stage).

Inside, activations are NCHW tensors in ``torch.channels_last`` memory
(cuDNN's fast layout); ``t.permute(0, 2, 3, 1)`` is then a contiguous NHWC
view with no copy.  Parameters stay float32 and are cast to the compute
dtype per conv, as the Flax modules do.  State-dict keys follow the
torchvision layout (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1..3}/bn{1..3}/downsample.{0,1}``), so
srsem/utils/convert.py::convert_torch_resnet50 reads the port's own
``state_dict()``.  The CLIP tower, LoRA and tap offsets wait (ROADMAP A3,
A7, A12).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: Stage depths of ResNet-50.
STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)

CLIP_STEM_TAP = "stem.conv3"
CLIP_STAGE_TAPS = tuple(f"stages.{s}.2.act" for s in range(4))
IMAGENET_STEM_TAP = "conv1"
IMAGENET_STAGE_TAPS = tuple(f"layer{s + 1}.2.act3" for s in range(4))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW view in channels_last memory (no copy when
    ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels_last tensor → its contiguous NHWC view."""
    return x.permute(0, 2, 3, 1).contiguous()


class FrozenBatchNorm(nn.Module):
    """BatchNorm locked to its running statistics — a buffer-only affine
    (the reference keeps backbones in eval mode).  Statistics are float32;
    the affine is applied in the input's dtype, as the Flax module does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 (scale, shift) with ``bn(x) == x * scale + shift``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.affine()
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def conv_nchw(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in the input's dtype (weights cast per call)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class ImageNetBottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: stride on the 3x3 conv."""

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * 4
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out_ch, 1), FrozenBatchNorm(out_ch)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride),
                                            FrozenBatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(conv_nchw(x, self.conv1)))
        h = F.relu(self.bn2(conv_nchw(h, self.conv2)))
        h = self.bn3(conv_nchw(h, self.conv3))
        if self.downsample is not None:
            x = self.downsample[1](conv_nchw(x, self.downsample[0]))
        return F.relu(h + x)


class ImageNetResNet50(nn.Module):
    """ImageNet ResNet-50 returning ``(pooled, taps)`` from NHWC images.

    ``dtype`` is the compute dtype of the tower (bf16 for serving)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for s, (blocks, width) in enumerate(zip(STAGE_BLOCKS, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(ImageNetBottleneck(
                    cin, width, 2 if (b == 0 and s > 0) else 1))
                cin = width * 4
            self.add_module(f"layer{s + 1}", nn.Sequential(*layer))

    def stages(self):
        """``[layer1, ..., layer4]`` as a list of block lists."""
        return [list(getattr(self, f"layer{s + 1}")) for s in range(4)]

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        h = to_nchw(x.to(self.dtype))
        stem = conv_nchw(h, self.conv1)
        taps[IMAGENET_STEM_TAP] = to_nhwc(stem)  # raw pre-BN conv output
        h = F.relu(self.bn1(stem))
        h = F.max_pool2d(h, 3, 2, 1)
        for s, blocks in enumerate(self.stages()):
            for b, block in enumerate(blocks):
                h = block(h)
                if b == 2:
                    taps[IMAGENET_STAGE_TAPS[s]] = to_nhwc(h)
        return h.mean(dim=(2, 3)), taps


def make_backbone(cfg) -> nn.Module:
    """Instantiate a backbone from a BackboneConfig (``resnet50`` only)."""
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.kind == "resnet50":
        return ImageNetResNet50(dtype=dtype)
    if cfg.kind == "resnet50_clip":
        raise NotImplementedError(
            "the CLIP ResNet-50 tower is not ported yet (ROADMAP A3)")
    if cfg.is_vit:
        raise NotImplementedError(
            "the CLIP ViT tower is not ported yet (ROADMAP A10)")
    raise ValueError(f"unknown backbone kind {cfg.kind!r}")
