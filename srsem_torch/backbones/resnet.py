"""ResNet-50 feature-pyramid backbones — the port of
srsem/backbones/resnet.py (ImageNet and CLIP towers).

* ``ImageNetResNet50`` — classic torchvision/timm ``resnet50``: 7x7/2
  stem, 3x3/2 max-pool, four bottleneck stages with the stride on the 3x3
  conv (reference: models/global_eval_models.py:695-698).  Taps:
  ``"conv1"`` (the RAW stem conv, before BN — resnet.py:251-252) and
  ``"layer{i}.2.act3"`` (third block's post-residual ReLU of each stage).
* ``ClipResNet50`` — OpenAI CLIP's modified ResNet-50: 3-conv stem + 2x2
  avg-pool, bottlenecks that downsample with an avg-pool after the 3x3
  conv (and before the shortcut's 1x1), and an attention-pool head with a
  1024-d embedding.  Taps: ``"stem.conv3"`` (after BN and ReLU —
  resnet.py:289-290) and ``"stages.{s}.{b}.act"`` for b < 3.

``forward`` takes NHWC images and returns ``(embedding, taps)`` with NHWC
taps under the reference's forward-hook names.

Inside, activations are NCHW tensors in ``torch.channels_last`` memory
(cuDNN's fast layout); ``t.permute(0, 2, 3, 1)`` is then a contiguous NHWC
view with no copy.  Parameters stay float32 and are cast to the compute
dtype per conv, as the Flax modules do.  State-dict keys follow the
torchvision layout (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1..3}/bn{1..3}/downsample.{0,1}``) and the OpenAI-CLIP
``visual`` layout (``conv1..3``/``bn1..3``, the same block keys,
``attnpool.{positional_embedding,q_proj,k_proj,v_proj,c_proj}``), so
srsem/utils/convert.py::convert_torch_resnet50 and ::convert_clip_resnet50
read the port's own ``state_dict()``.

``forward(x, tap_offsets)`` takes an optional ``{tap name: NHWC tensor}``
of additive offsets, each added where the JAX package's ``_tap`` adds it
(srsem/backbones/resnet.py:229-236) so that the tap and everything after
it see it: Grad-CAM (srsem_torch/explain/gradcam.py) differentiates with
respect to a zero offset to get d(output)/d(activation).  The tap records
the activation with its offset.  An entry of None makes that zero offset
in the forward (``tap_offset``).

``lora_rank`` puts LoRA factors (srsem_torch/ops/lora.py) on every conv of
the tower, the downsample convs included, and on no attention-pool
projection, as the Flax towers do: state-dict keys ``<conv>.lora_a`` and
``<conv>.lora_b`` beside ``<conv>.weight``.  The kernel is float32 plus the
float32 delta, then cast to the compute dtype (resnet.py:98-110).

The four FrozenBatchNorm statistics are parameters that do not require
gradients, under the state-dict names of torch's BatchNorm: they train
only where a caller asks for it (the full fine-tune, ``enc_ft``), as the
Flax module keeps them as params that ``trainable_predicate`` selects.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.core.meshes import gather_shards
from srsem_torch.ops.image import interpolate_pos_embed
from srsem_torch.ops.lora import init_lora_, lora_delta

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


def tap_offset(offsets, name: str, shape, like: torch.Tensor):
    """The offset registered for tap ``name``, or None.  An entry of None
    asks for a zero offset that takes a gradient: it is made here, of the
    tap's ``shape`` and ``like``'s dtype and device, and put back in
    ``offsets`` for the caller to differentiate against (Grad-CAM learns
    the tap's shape so without a forward of its own)."""
    if not offsets or name not in offsets:
        return None
    if offsets[name] is None:
        offsets[name] = torch.zeros(shape, dtype=like.dtype, device=like.device,
                                    requires_grad=True)
    return offsets[name].to(like.dtype)


def add_tap_offset(h: torch.Tensor, offsets, name: str) -> torch.Tensor:
    """NCHW ``h`` plus the NHWC offset registered for tap ``name`` (cast to
    h's dtype), or ``h`` when there is none."""
    n, c, hh, ww = h.shape
    off = tap_offset(offsets, name, (n, hh, ww, c), h)
    return h if off is None else h + to_nchw(off)


class FrozenBatchNorm(nn.Module):
    """BatchNorm locked to its running statistics — an affine (the
    reference keeps backbones in eval mode).  Statistics are float32
    parameters, frozen unless a caller turns their gradients on; the
    affine is applied in the input's dtype, as the Flax module does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", torch.ones(features)),
                            ("bias", torch.zeros(features)),
                            ("running_mean", torch.zeros(features)),
                            ("running_var", torch.ones(features))):
            setattr(self, name, nn.Parameter(value, requires_grad=False))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 (scale, shift) with ``bn(x) == x * scale + shift``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.affine()
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class LoraConv2d(nn.Conv2d):
    """A bias-free tower conv (padding k // 2, as torch's) whose kernel
    carries a LoRA delta when ``rank`` is set (the Flax ``LoraConv``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 rank: Optional[int] = None):
        super().__init__(cin, cout, k, stride, k // 2, bias=False)
        self.rank = rank
        if rank:
            self.lora_a = nn.Parameter(torch.zeros(k * k * cin, rank),
                                       requires_grad=False)
            self.lora_b = nn.Parameter(torch.zeros(rank, cout),
                                       requires_grad=False)

    def kernel(self) -> torch.Tensor:
        """The float32 OIHW kernel with its LoRA delta."""
        if not self.rank:
            return self.weight
        cout, cin, kh, kw = self.weight.shape
        return self.weight + lora_delta(self.lora_a, self.lora_b,
                                        (kh, kw, cin, cout))


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          rank: Optional[int] = None) -> LoraConv2d:
    return LoraConv2d(cin, cout, k, stride, rank)


def conv_nchw(x: torch.Tensor, conv: LoraConv2d) -> torch.Tensor:
    """``conv`` applied in the input's dtype: the float32 kernel (with its
    LoRA delta) cast per call.  A conv sharded over the model axis
    (srsem_torch/parallel/sharding.py) gathers its output channels."""
    y = F.conv2d(x, conv.kernel().to(x.dtype), None, conv.stride,
                 conv.padding)
    mesh = getattr(conv, "model_mesh", None)
    if mesh is None:
        return y
    return gather_shards(y, 1, mesh).contiguous(
        memory_format=torch.channels_last)


def dense(m: nn.Linear, t: torch.Tensor) -> torch.Tensor:
    """``m`` applied in ``t``'s dtype; a sharded ``m`` gathers its output
    features."""
    y = F.linear(t, m.weight.to(t.dtype), m.bias.to(t.dtype))
    mesh = getattr(m, "model_mesh", None)
    return y if mesh is None else gather_shards(y, -1, mesh)


class ImageNetBottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: stride on the 3x3 conv."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 lora_rank: Optional[int] = None):
        super().__init__()
        out_ch, r = width * 4, lora_rank
        self.conv1 = _conv(cin, width, 1, rank=r)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, r)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1, rank=r)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride, r),
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

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 lora_rank: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, lora_rank)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for s, (blocks, width) in enumerate(zip(STAGE_BLOCKS, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(ImageNetBottleneck(
                    cin, width, 2 if (b == 0 and s > 0) else 1, lora_rank))
                cin = width * 4
            self.add_module(f"layer{s + 1}", nn.Sequential(*layer))

    def stages(self):
        """``[layer1, ..., layer4]`` as a list of block lists."""
        return [list(getattr(self, f"layer{s + 1}")) for s in range(4)]

    def forward(self, x: torch.Tensor, tap_offsets=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        h = to_nchw(x.to(self.dtype))
        stem = conv_nchw(h, self.conv1)
        # The raw pre-BN conv output (the reference hooks the bare conv).
        stem = add_tap_offset(stem, tap_offsets, IMAGENET_STEM_TAP)
        taps[IMAGENET_STEM_TAP] = to_nhwc(stem)
        h = F.relu(self.bn1(stem))
        h = F.max_pool2d(h, 3, 2, 1)
        for s, blocks in enumerate(self.stages()):
            for b, block in enumerate(blocks):
                h = block(h)
                if b == 2:
                    name = IMAGENET_STAGE_TAPS[s]
                    h = add_tap_offset(h, tap_offsets, name)
                    taps[name] = to_nhwc(h)
        return h.mean(dim=(2, 3)), taps


class ClipBottleneck(nn.Module):
    """OpenAI ModifiedResNet bottleneck: every conv stride 1; a stride-2
    block avg-pools after the 3x3 conv and before the shortcut's 1x1 conv
    (CLIP's anti-aliased downsampling).  The shortcut keeps CLIP's keys
    ``downsample.{-1 (pool), 0 (conv), 1 (bn)}``."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 lora_rank: Optional[int] = None):
        super().__init__()
        out_ch, r = width * 4, lora_rank
        self.stride = stride
        self.conv1 = _conv(cin, width, 1, rank=r)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, rank=r)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1, rank=r)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample: Optional[nn.Sequential] = None
        if stride > 1 or cin != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", _conv(cin, out_ch, 1, rank=r)),
                ("1", FrozenBatchNorm(out_ch))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(conv_nchw(x, self.conv1)))
        h = F.relu(self.bn2(conv_nchw(h, self.conv2)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(conv_nchw(h, self.conv3))
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            x = bn(conv_nchw(pool(x), conv))
        return F.relu(h + x)


class AttentionPool2d(nn.Module):
    """CLIP's attention-pool head: the spatial mean prepended as a query
    token, learned positional embeddings (resized with
    ``interpolate_pos_embed`` for other input sizes), one multi-head
    attention step, the query output projected to ``embed_dim``.  Runs in
    the input's dtype with the softmax in float32, as the Flax module."""

    def __init__(self, spatial: int, width: int = 2048, num_heads: int = 32,
                 embed_dim: int = 1024):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spatial * spatial + 1, width), requires_grad=False)
        self.k_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW features → (N, embed_dim)."""
        n, c, h, w = x.shape
        dt = x.dtype
        tokens = x.flatten(2).transpose(1, 2)  # (N, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pos = interpolate_pos_embed(self.positional_embedding, (h, w))
        tokens = tokens + pos.to(dt)
        hd = c // self.num_heads
        split = lambda t: t.reshape(n, t.shape[1], self.num_heads, hd)  # noqa: E731
        q = split(dense(self.q_proj, tokens[:, :1]))
        k = split(dense(self.k_proj, tokens))
        v = split(dense(self.v_proj, tokens))
        attn = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(attn.float(), dim=-1).to(dt)
        out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, 1, c)
        return dense(self.c_proj, out)[:, 0]


class ClipResNet50(nn.Module):
    """CLIP modified ResNet-50 returning ``(embedding, taps)`` from NHWC
    images, in the OpenAI-CLIP ``visual`` state-dict layout."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224, embed_dim: int = 1024,
                 lora_rank: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        r = lora_rank
        self.conv1, self.bn1 = _conv(3, 32, 3, 2, r), FrozenBatchNorm(32)
        self.conv2, self.bn2 = _conv(32, 32, 3, rank=r), FrozenBatchNorm(32)
        self.conv3, self.bn3 = _conv(32, 64, 3, rank=r), FrozenBatchNorm(64)
        cin = 64
        for s, (blocks, width) in enumerate(zip(STAGE_BLOCKS, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(ClipBottleneck(
                    cin, width, 2 if (b == 0 and s > 0) else 1, r))
                cin = width * 4
            self.add_module(f"layer{s + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(image_size // 32, cin, 32, embed_dim)

    def stages(self):
        """``[layer1, ..., layer4]`` as a list of block lists."""
        return [list(getattr(self, f"layer{s + 1}")) for s in range(4)]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → the stem tap (NCHW, after bn3 and ReLU)."""
        h = to_nchw(x.to(self.dtype))
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            h = F.relu(bn(conv_nchw(h, conv)))
        return h

    def forward(self, x: torch.Tensor, tap_offsets=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = add_tap_offset(self.stem(x), tap_offsets, CLIP_STEM_TAP)
        taps: Dict[str, torch.Tensor] = {CLIP_STEM_TAP: to_nhwc(h)}
        h = F.avg_pool2d(h, 2)
        for s, blocks in enumerate(self.stages()):
            for b, block in enumerate(blocks):
                h = block(h)
                if b < 3:
                    name = f"stages.{s}.{b}.act"
                    h = add_tap_offset(h, tap_offsets, name)
                    taps[name] = to_nhwc(h)
        return self.attnpool(h), taps


def reset_tower(tower: nn.Module, generator: Optional[torch.Generator] = None):
    """Fresh tower weights from ``generator``, as the Flax init draws them:
    Kaiming-normal (fan_in) convs and LoRA's zero ``a`` and Kaiming-normal
    ``b``, identity frozen BN, and in CLIP's attention pool a
    normal(0, C^-1/2) positional table, LeCun-normal projections and zero
    biases; a ClipViT its own init (``ClipViT.reset_parameters``)."""
    if hasattr(tower, "cls_token"):
        tower.reset_parameters(generator)
        return
    with torch.no_grad():
        for m in tower.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                 generator=generator)
                if getattr(m, "rank", None):
                    init_lora_(m.lora_a, m.lora_b, generator)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, AttentionPool2d):
                c = m.positional_embedding.shape[1]
                m.positional_embedding.normal_(0.0, c ** -0.5,
                                               generator=generator)


def make_backbone(cfg, lora_rank: Optional[int] = None) -> nn.Module:
    """Instantiate a backbone from a BackboneConfig: a ResNet, with LoRA
    factors of ``lora_rank`` on every conv when it is set, or the CLIP
    ViT."""
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.kind == "resnet50":
        return ImageNetResNet50(dtype=dtype, lora_rank=lora_rank)
    if cfg.kind == "resnet50_clip":
        return ClipResNet50(dtype=dtype, image_size=cfg.image_size,
                            lora_rank=lora_rank)
    if cfg.is_vit:
        # No LoRA on the ViT, and no ``act``: exact GELU whatever the
        # weights' origin (srsem/backbones/resnet.py::make_backbone).
        from srsem_torch.backbones.vit import ClipViT

        return ClipViT(patch=cfg.vit_patch, width=cfg.vit_width,
                       depth=cfg.vit_depth, heads=cfg.vit_heads, dtype=dtype)
    raise ValueError(f"unknown backbone kind {cfg.kind!r}")
