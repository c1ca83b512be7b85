"""Local semantic-fidelity map models ("CLU" = CLIP-LPIPS-UNet) — the port
of srsem/models/local_models.py.

The frozen backbone yields a 5-level squared-difference pyramid over taps
``stem + stages.{0..3}.2.act`` (channels 64/256/512/1024/2048, strides
2-32).  The decoder starts at the deepest diff; at each level a conv block,
a x2 align-corners bilinear upsample, and the next shallower diff beside it
(reference: models/local_eval_models.py:38-124).  Blocks are
Conv3x3+BN+ReLU twice, except level 0 (Conv3x3+BN+ReLU, then Conv1x1 to one
channel and ReLU).  The map is the sigmoid of channel 0 at input size.
``v2`` adds a pixel-space squared-error channel at every level (reference:
:444-456).

Decoder blocks keep the reference's ``nn.Sequential`` layout
(``decoder.{lvl}.{0: conv, 1: BN, 3: conv, 4: BN}``), so
srsem/utils/convert.py::convert_clu_decoder reads the port's own weights.
Conv1's input channels are ordered ``[skip diff (+ v2 pixel channel),
upsampled]``; it runs as two sliced convs (the split-concat identity), so
the concat is never built.

Serving: ``fold_decoder`` folds BN (running statistics) into the conv
weights and packs each level in the Hopper kernel's layout once
(srsem_torch/ops/fused_decoder.py::pack_level); ``fused_serving_decode``
runs all five levels through the kernel.  The JAX package fuses levels
0-2 only and leaves 3-4 to XLA, for the TPU's sake
(srsem/models/local_models.py:296-306: level 4's weights do not fit v5e's
VMEM); on Hopper the kernel streams its weights through TMA, and levels
3-4 (14x14 and 7x7, K up to 27,648) take its flat M tiles.

Training: ``forward(..., train=True)`` and ``decode_from_diffs(...,
train=True)`` run the decoder's BatchNorms on batch statistics and update
their running statistics, as the JAX package's ``TorchBatchNorm``
(srsem/ops/batchnorm.py) does: torch momentum 0.1 (flax's 0.9), the
biased batch variance to normalize, the Bessel-corrected one into
``running_var``.  On a mesh (``sync_batch_norm``) the batch statistics
are the global batch's, summed over the mesh's ``data`` axis as jit's
psums make them in JAX; the backward sums the two gradient reductions
the same way.

Tower training (``lora_rank``): an int puts LoRA factors of that rank on
every tower conv (srsem_torch/ops/lora.py), and ``"full"`` trains the
whole tower, run under activation checkpointing (``torch.utils.checkpoint``
over the tower call, the Flax module's ``nn.remat``).  The taps carry
gradients in both modes and are detached otherwise, as the Flax module's
``stop_gradient`` (local_models.py:214-232).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from srsem_torch.backbones.resnet import (
    CLIP_STAGE_TAPS,
    CLIP_STEM_TAP,
    IMAGENET_STAGE_TAPS,
    IMAGENET_STEM_TAP,
    make_backbone,
    reset_tower,
    to_nchw,
    to_nhwc,
)
from srsem_torch.config import BackboneConfig, LocalModelConfig
from srsem_torch.core.meshes import DATA_AXIS, Mesh, all_reduce
from srsem_torch.ops.fused_bottleneck import fold_bn_into_conv
from srsem_torch.ops.fused_decoder import (
    PackedLevel,
    fused_decoder_level,
    fused_decoder_level_tiled,
    pack_level,
)
from srsem_torch.ops.image import resize_bilinear, upsample_x2_align_corners
from srsem_torch.utils.profiling import span

Tensor = torch.Tensor

#: Decoder channel plan, shallow to deep (the tap channels).
_LEVEL_CHANNELS = (64, 256, 512, 1024, 2048)

#: Row tile per level for ``fused_decoder_level_tiled``: levels 0 and 1
#: (112 and 56 px at 224) — the levels the JAX docstring names for it
#: (srsem/ops/fused_decoder.py:248-251).  JAX defaults to ``{}`` only
#: because Mosaic crashed on these shapes (local_models.py:310-317).  On
#: the card both wrappers launch the same kernel, which ignores the row
#: tile; on the CPU it picks the plain version's row tiles.
DEFAULT_TILED_LEVEL_ROWS: Dict[int, int] = {0: 7, 1: 7}


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN of float32 NCHW ``x`` with the statistics of the
    global batch, summed over the mesh's data axis: the mean, then the
    biased variance about it (JAX's two passes).  Returns ``(y, mean,
    var, count)``; only ``y`` carries gradients.  The backward sums the
    per-channel ``sum(dy)`` and ``sum(dy * xhat)`` over the data axis for
    the input's gradient, and returns the rank's own sums for the weight
    and bias (the train step sums those over ``data``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh: Mesh, eps: float):
        c = x.shape[1]
        dims = (0, 2, 3)
        first = all_reduce(mesh, torch.cat(
            [x.sum(dim=dims), x.new_full((1,), x.numel() // c)]))
        count = first[c]
        mean = first[:c] / count
        centered = x - mean.view(1, -1, 1, 1)
        var = all_reduce(mesh, (centered * centered).sum(dim=dims)) / count
        invstd = torch.rsqrt(var + eps)
        xhat = centered * invstd.view(1, -1, 1, 1)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.mesh, ctx.count = mesh, count
        ctx.mark_non_differentiable(mean, var, count)
        return (xhat * weight.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1),
                mean, var, count)

    @staticmethod
    def backward(ctx, gy, *_):
        xhat, weight, invstd = ctx.saved_tensors
        c = xhat.shape[1]
        dims = (0, 2, 3)
        local = torch.cat([gy.sum(dim=dims), (gy * xhat).sum(dim=dims)])
        total = all_reduce(ctx.mesh, local) / ctx.count
        view = lambda v: v.view(1, -1, 1, 1)  # noqa: E731
        dx = view(weight * invstd) * (gy - view(total[:c])
                                      - xhat * view(total[c:]))
        return dx, local[c:], local[:c], None, None


def _batch_norm(x: Tensor, bn: nn.BatchNorm2d, train: bool = False,
                mesh: Optional[Mesh] = None) -> Tensor:
    """BN in float32: running statistics, or with ``train`` the batch's
    (biased variance), updating the running statistics in place with
    momentum 0.1 and the unbiased variance (torch's BatchNorm2d).  With
    ``train`` on a ``mesh`` whose data axis has more than one rank, the
    batch is the global one (``_SyncBatchNorm``)."""
    if not (train and mesh is not None and mesh.distributed
            and mesh.shape[DATA_AXIS] > 1):
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, train, 0.1, bn.eps)
    y, mean, var, count = _SyncBatchNorm.apply(x.float(), bn.weight,
                                               bn.bias, mesh, bn.eps)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
        bn.running_var.mul_(0.9).add_(var * (count / (count - 1)),
                                      alpha=0.1)
    return y


class DecoderBlock(nn.Sequential):
    """Conv3x3+BN+ReLU, then Conv(k)+[BN]+ReLU, in the reference's
    ``nn.Sequential`` layout.  The shallowest block ends with a 1x1 conv
    to one channel and no second BN (reference :39-45).

    ``forward`` takes a ``(skip_diff, upsampled)`` pair of NCHW tensors
    (``upsampled`` None at the deepest level) and runs in ``dtype``; the
    BNs compute in float32, then ReLU, then a cast back to ``dtype``, as
    the Flax block does, in training too (``train``: batch statistics)."""

    def __init__(self, cin: int, mid: int, out: int, final_kernel: int = 3,
                 final_bn: bool = True, dtype: torch.dtype = torch.float32):
        layers = [nn.Conv2d(cin, mid, 3, padding=1), nn.BatchNorm2d(mid),
                  nn.ReLU(),
                  nn.Conv2d(mid, out, final_kernel,
                            padding=final_kernel // 2)]
        if final_bn:
            layers.append(nn.BatchNorm2d(out))
        layers.append(nn.ReLU())
        super().__init__(*layers)
        self.final_kernel = final_kernel
        self.dtype = dtype
        #: The mesh whose data axis the train-mode BN statistics span.
        self.mesh: Optional[Mesh] = None

    def forward(self, d: Tensor, u: Optional[Tensor] = None,
                train: bool = False) -> Tensor:
        dt = self.dtype
        conv1, bn1, conv2 = self[0], self[1], self[3]
        w = conv1.weight.to(dt)
        cd = d.shape[1]
        x = F.conv2d(d.to(dt), w[:, :cd], None, 1, 1)
        if u is not None:
            x = x + F.conv2d(u.to(dt), w[:, cd:], None, 1, 1)
        x = F.relu(_batch_norm(x + conv1.bias.to(dt).view(1, -1, 1, 1),
                               bn1, train, self.mesh)).to(dt)
        x = F.conv2d(x, conv2.weight.to(dt), conv2.bias.to(dt), 1,
                     conv2.padding)
        if isinstance(self[4], nn.BatchNorm2d):
            x = _batch_norm(x, self[4], train, self.mesh)
        return F.relu(x.to(dt))


class CluUnet(nn.Module):
    """map = model(a, b): a per-pixel semantic-fidelity map in [0, 1] for
    NHWC image batches (the port of the Flax ``CluUnet``)."""

    def __init__(self, backbone_kind: str = "resnet50_clip", v2: bool = False,
                 lora_rank=None, compute_dtype: torch.dtype = torch.bfloat16,
                 sigmoid: bool = True, image_size: int = 224,
                 decoder_dtype: torch.dtype = torch.float32,
                 output_dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0, split_tower: bool = False):
        super().__init__()
        if backbone_kind == "resnet50_clip":
            self.tap_names = (CLIP_STEM_TAP,) + CLIP_STAGE_TAPS
        elif backbone_kind == "resnet50":
            self.tap_names = (IMAGENET_STEM_TAP,) + IMAGENET_STAGE_TAPS
        else:
            raise ValueError(f"unsupported CLU backbone {backbone_kind!r}")
        self.backbone_kind = backbone_kind
        self.lora_rank = lora_rank
        self.v2 = v2
        self.sigmoid = sigmoid
        self.decoder_dtype = decoder_dtype
        self.output_dtype = output_dtype
        self.width_mult = width_mult
        self.split_tower = split_tower
        self.backbone = make_backbone(BackboneConfig(
            kind=backbone_kind, image_size=image_size,
            compute_dtype=str(compute_dtype).replace("torch.", "")),
            lora_rank=lora_rank if isinstance(lora_rank, int) else None)

        def scaled(ch: int) -> int:
            return ch if width_mult == 1.0 else max(8, int(ch * width_mult))

        # Block lvl takes [diff lvl (+ v2 channel), upsampled block lvl+1]
        # and emits ch[lvl] channels; level 0 emits the 1-channel map.
        extra = 1 if v2 else 0
        blocks = []
        for lvl, ch in enumerate(_LEVEL_CHANNELS):
            up = scaled(_LEVEL_CHANNELS[lvl + 1]) if lvl < 4 else 0
            cin = ch + extra + up
            if lvl == 0:
                blocks.append(DecoderBlock(cin, scaled(64), 1, final_kernel=1,
                                           final_bn=False, dtype=decoder_dtype))
            else:
                blocks.append(DecoderBlock(cin, scaled(ch), scaled(ch),
                                           dtype=decoder_dtype))
        self.decoder = nn.ModuleList(blocks)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh weights from ``generator``, as the Flax init draws them:
        the tower as ``reset_tower``; decoder convs He-normal over fan_out
        with zero biases; identity BN."""
        reset_tower(self.backbone, generator)
        with torch.no_grad():
            for m in self.decoder.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()

    def sync_batch_norm(self, mesh: Optional[Mesh]) -> None:
        """Take the decoder's train-mode BN statistics over ``mesh``'s
        data axis (None: this rank's batch)."""
        for block in self.decoder:
            block.mesh = mesh

    @property
    def tower_trains(self) -> bool:
        """LoRA (an int rank) or the full fine-tune: the taps carry
        gradients."""
        return self.lora_rank == "full" or isinstance(self.lora_rank, int)

    def tower(self, x: Tensor):
        """``(embedding, taps)`` of the module tower: checkpointed under the
        full fine-tune, detached unless the tower trains."""
        if self.lora_rank == "full":
            return checkpoint(self.backbone, x, use_reentrant=False)
        emb, taps = self.backbone(x)
        if self.tower_trains:
            return emb, taps
        return emb.detach(), {k: v.detach() for k, v in taps.items()}

    def forward(self, a: Tensor, b: Tensor, train: bool = False) -> Tensor:
        if not self.split_tower:
            n = a.shape[0]
            _, taps = self.tower(torch.cat([a, b], dim=0))
            taps_a = {k: v[:n] for k, v in taps.items()}
            taps_b = {k: v[n:] for k, v in taps.items()}
        else:
            _, taps_a = self.tower(a)
            _, taps_b = self.tower(b)
        return self.decode_from_taps(taps_a, taps_b, a, b, train)

    def decode_from_taps(self, taps_a: Dict[str, Tensor],
                         taps_b: Dict[str, Tensor], a: Tensor, b: Tensor,
                         train: bool = False) -> Tensor:
        """Diff pyramid (subtraction in float32, stored in the decoder
        dtype) and the v2 pixel channel, then ``decode_from_diffs``."""
        diffs = squared_diff_pyramid(taps_a, taps_b, self.tap_names,
                                     self.decoder_dtype)
        img_sq = pixel_sq_error(a, b) if self.v2 else None
        return self.decode_from_diffs(diffs, img_sq, train)

    def with_pixel_channel(self, diffs: Sequence[Tensor],
                           img_sq: Optional[Tensor]) -> List[Tensor]:
        """v2: each NHWC diff with ``img_sq`` (N, H, W, 1) resized to its
        size (align_corners=False) as one more channel."""
        if not self.v2:
            return list(diffs)
        return [torch.cat([d, self.pixel_channel(img_sq, d)], dim=-1)
                for d in diffs]

    def pixel_channel(self, img_sq: Optional[Tensor], d: Tensor) -> Tensor:
        """v2's channel for the NHWC diff ``d``: ``img_sq`` resized to its
        size (align_corners=False), in its dtype."""
        if img_sq is None:
            raise ValueError("v2 decode needs the pixel img_sq channel")
        return resize_bilinear(img_sq.float(), d.shape[1:3]).to(d.dtype)

    def skip_input(self, d: Tensor, img_sq: Optional[Tensor],
                   width: int) -> Tensor:
        """A level's skip input in one buffer of ``width`` channels in the
        decoder dtype: the diff ``d``, v2's pixel channel, then zeros (the
        kernel's padding, ``skip_width``) — one copy a level, none where
        ``d`` is that buffer already."""
        c = d.shape[-1]
        if not self.v2 and c == width:
            return d.to(self.decoder_dtype).contiguous()
        out = torch.empty(*d.shape[:-1], width, dtype=self.decoder_dtype,
                          device=d.device)
        out[..., :c] = d
        if self.v2:
            out[..., c:c + 1] = self.pixel_channel(img_sq, d)
            c += 1
        out[..., c:] = 0
        return out

    def decode_from_diffs(self, diffs: Sequence[Tensor],
                          img_sq: Optional[Tensor] = None,
                          train: bool = False) -> Tensor:
        """UNet decode over NHWC squared-diff pyramids (shallow to deep, in
        ``tap_names`` order); ``img_sq`` is v2's (N, H, W, 1) pixel error.
        Returns the (N, H, W) map in ``output_dtype``; ``train`` runs the
        BatchNorms on batch statistics and updates their running ones."""
        dd = self.decoder_dtype
        diffs = [to_nchw(d.to(dd)) for d in self.with_pixel_channel(diffs, img_sq)]
        up = lambda v: to_nchw(upsample_x2_align_corners(to_nhwc(v)))  # noqa: E731
        h = up(self.decoder[-1](diffs[-1], None, train))
        for lvl in range(len(diffs) - 2, -1, -1):
            h = up(self.decoder[lvl](diffs[lvl], h, train))
        return finish_map(to_nhwc(h), self.sigmoid, self.output_dtype)


def squared_diff_pyramid(taps_a: Dict[str, Tensor], taps_b: Dict[str, Tensor],
                         names: Sequence[str],
                         dtype: torch.dtype) -> List[Tensor]:
    """``((f_a - f_b) ** 2)`` per tap, subtracted in float32 (bf16
    cancellation is the risky part), stored in ``dtype``."""
    return [((taps_a[n].float() - taps_b[n].float()) ** 2).to(dtype)
            for n in names]


def pixel_sq_error(a: Tensor, b: Tensor) -> Tensor:
    """v2's pixel channel: mean over RGB of ``(a - b) ** 2``, (N, H, W, 1)."""
    return ((a.float() - b.float()) ** 2).mean(dim=-1, keepdim=True)


def finish_map(h: Tensor, sigmoid: bool, output_dtype: torch.dtype) -> Tensor:
    """Channel 0 of the last level, sigmoid in float32, then the output
    dtype."""
    h = h[..., 0].float()
    return (torch.sigmoid(h) if sigmoid else h).to(output_dtype)


def folded_decoder_weights(model: CluUnet, lvl: int, cd: int):
    """BN-folded float32 serving weights of decoder level ``lvl`` in the JAX
    layouts: ``(w1d, w1u, b1, w2, b2, final_kernel)`` with conv1 as HWIO
    split at ``cd`` input channels (w1u None at the deepest level), w2 HWIO
    (1x1 at level 0, which has no second BN)."""
    block = model.decoder[lvl]
    w1, b1 = fold_bn_into_conv(block[0].weight, block[1], bias=block[0].bias)
    w1 = w1.permute(2, 3, 1, 0)
    w1d, w1u = w1[:, :, :cd], (w1[:, :, cd:] if w1.shape[2] > cd else None)
    if isinstance(block[4], nn.BatchNorm2d):
        w2, b2 = fold_bn_into_conv(block[3].weight, block[4],
                                   bias=block[3].bias)
    else:  # level 0: Conv1x1 → 1 channel, no second BN
        w2, b2 = block[3].weight.float(), block[3].bias.float()
    return w1d, w1u, b1, w2.permute(2, 3, 1, 0), b2, block.final_kernel


def skip_channels(model: CluUnet, lvl: int) -> int:
    """Channels of level ``lvl``'s skip input (the tap, + v2's channel)."""
    cin = model.decoder[lvl][0].in_channels
    up = model.decoder[lvl + 1][3].out_channels if lvl + 1 < len(
        model.decoder) else 0
    return cin - up


def fold_decoder(model: CluUnet) -> List[PackedLevel]:
    """Serving weights of every level, folded and packed once (the decoder
    is frozen when serving) in the kernel's layout (``pack_level``: w1d's
    input rows zero-padded to ``skip_width`` for v2's odd skip widths,
    K-major, split for 3xTF32 in float32); weights in the decoder dtype,
    biases float32."""
    with torch.no_grad():
        return [pack_level(*folded_decoder_weights(
                    model, lvl, skip_channels(model, lvl)),
                    model.decoder_dtype)
                for lvl in range(len(model.decoder))]


def fused_serving_decode(model: CluUnet, diffs: Sequence[Tensor],
                         img_sq: Optional[Tensor] = None,
                         tiled_rows: Optional[Dict[int, int]] = None,
                         folded: Optional[List[PackedLevel]] = None
                         ) -> Tensor:
    """Serving-only UNet decode (eval BN folded into the convs): every
    level through the fused kernel with its packed weights, levels in
    ``tiled_rows`` through the tiled wrapper with that row tile.  Matches
    ``decode_from_diffs`` up to FP order.  ``folded`` is
    ``fold_decoder(model)``, computed here when not given; each level's
    skip input is written once at its packed width (``CluUnet.skip_input``:
    v2's pixel channel and the kernel's zero channels in the same
    buffer)."""
    if tiled_rows is None:
        tiled_rows = DEFAULT_TILED_LEVEL_ROWS
    if folded is None:
        folded = fold_decoder(model)
    diffs = [model.skip_input(d, img_sq, p.cd) for d, p in zip(diffs, folded)]

    def level(lvl: int, d: Tensor, u: Optional[Tensor]) -> Tensor:
        p = folded[lvl]
        with span("srsem.decode.level", level=lvl, route="kernel"):
            th = tiled_rows.get(lvl)
            if th and th < d.shape[1]:
                return fused_decoder_level_tiled(d, u, p, row_tile=th,
                                                 final_kernel=p.final_kernel)
            return fused_decoder_level(d, u, p, final_kernel=p.final_kernel)

    h = upsample_x2_align_corners(level(len(diffs) - 1, diffs[-1], None))
    for lvl in range(len(diffs) - 2, -1, -1):
        h = upsample_x2_align_corners(level(lvl, diffs[lvl], h))
    return finish_map(h, model.sigmoid, model.output_dtype)


def make_local_model(cfg: LocalModelConfig, split_tower: bool = False,
                     width_mult: float = 1.0,
                     generator: Optional[torch.Generator] = None) -> CluUnet:
    """A CluUnet on the CPU with weights drawn from ``generator`` (move it
    with ``.to(device)``)."""
    model = CluUnet(
        backbone_kind=cfg.backbone.kind, v2=cfg.v2, lora_rank=cfg.lora_rank,
        compute_dtype=getattr(torch, cfg.backbone.compute_dtype),
        image_size=cfg.backbone.image_size,
        decoder_dtype=getattr(torch, cfg.decoder_dtype),
        output_dtype=getattr(torch, cfg.output_dtype),
        width_mult=width_mult, split_tower=split_tower)
    model.reset_parameters(generator)
    return model.eval().requires_grad_(False)
