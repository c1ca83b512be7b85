"""Global pair-scoring regressor ("CLIP-LPIPS") — the port of
srsem/models/global_models.py for ``head="stages_cnn"``.

Shared numerics (reference: models/global_eval_models.py:341-397): run
both images through the frozen backbone; per tapped stage the squared
difference ``(f_a - f_b) ** 2``; a 1x1 conv to one channel, the spatial
mean, the mean over stages, a final ReLU.  As in the JAX package the two
backbone passes are one pass on a 2N batch, and the head runs in float32.

The other heads (wperlay_cnn, stages_cnn_pooling, emb_lin, the ViT heads,
unet_global) are not ported yet (ROADMAP A4, A5, A10).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.backbones.resnet import (
    CLIP_STAGE_TAPS,
    IMAGENET_STAGE_TAPS,
    make_backbone,
    reset_tower,
)
from srsem_torch.config import GlobalModelConfig

Tensor = torch.Tensor

#: Output channels of the four stage taps (BackboneConfig.stage_channels).
_STAGE_CHANNELS = (256, 512, 1024, 2048)


def head_bias_initializer(mode: str, fan_in: int
                          ) -> Callable[[Tensor, Optional[torch.Generator]], None]:
    """In-place initializer of a scoring-head bias for ``cfg.head_bias_init``.

    ``"live"`` — constant +0.01: squared-diff inputs are nonnegative, so
    under a symmetric init a fresh head has a ~50% chance of a dead final
    ReLU; +0.01 sits inside torch's range but on the live side.
    ``"torch"`` — torch's Conv2d default ``U(±1/√fan_in)``, as the
    reference heads get (models/global_eval_models.py:361-369).
    """
    if mode == "live":
        return lambda t, generator=None: t.fill_(0.01)
    if mode == "torch":
        bound = float(fan_in) ** -0.5
        return lambda t, generator=None: t.uniform_(-bound, bound,
                                                    generator=generator)
    raise ValueError(f"unknown head_bias_init {mode!r}")


def stage_taps_for(kind: str, depth: int) -> Tuple[str, ...]:
    """The ``depth + 1`` deepest per-stage taps (reference:
    models/global_eval_models.py:327,701): depth∈{1,2,3} taps 2..4 stages."""
    names = CLIP_STAGE_TAPS if kind == "resnet50_clip" else IMAGENET_STAGE_TAPS
    return names[3 - depth:]


def squared_diffs(taps_a: Dict[str, Tensor], taps_b: Dict[str, Tensor],
                  names: Sequence[str]) -> List[Tensor]:
    return [(taps_a[n].float() - taps_b[n].float()) ** 2 for n in names]


def grouped_diff_pyramid(taps_g: Dict[str, Tensor], taps_s: Dict[str, Tensor],
                         names: Sequence[str],
                         dtype: torch.dtype = torch.float32) -> List[Tensor]:
    """Per-pair squared-diff pyramids from grouped taps
    (global_models.py:237-257): GT taps (G, h, w, c) broadcast against SR
    taps (G*K, h, w, c), subtracted in float32, stored in ``dtype`` as
    ``[(G*K, h, w, c), ...]``; the GT taps are never tiled K times."""
    g = taps_g[names[0]].shape[0]
    out = []
    for nm in names:
        t = taps_s[nm]
        ts = t.reshape(g, t.shape[0] // g, *t.shape[1:]).float()
        diff = (taps_g[nm].float()[:, None] - ts) ** 2
        out.append(diff.to(dtype).reshape(t.shape))
    return out


class ConvHeadAggregator(nn.Module):
    """Per-layer 1x1-conv-to-scalar heads + spatial mean + layer mean +
    ReLU (reference: models/global_eval_models.py:379-395).  The heads are
    ``w_layers.{j}`` = ``Conv2d(C_j, 1, 1)``, the reference ``save_model``
    layout, so srsem/utils/convert.py::convert_global_head reads them."""

    def __init__(self, channels: Sequence[int], bias_init: str = "live"):
        super().__init__()
        head_bias_initializer(bias_init, 1)  # validate the mode early
        self.bias_init = bias_init
        self.w_layers = nn.ModuleList(nn.Conv2d(c, 1, 1) for c in channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's default ``U(±1/√fan_in)`` weights; bias per
        ``bias_init``."""
        with torch.no_grad():
            for layer in self.w_layers:
                fan_in = layer.weight.shape[1]
                bound = fan_in ** -0.5
                layer.weight.uniform_(-bound, bound, generator=generator)
                head_bias_initializer(self.bias_init, fan_in)(
                    layer.bias, generator)

    def forward(self, diffs: List[Tensor]) -> Tensor:
        """NHWC squared diffs → (N,) scores."""
        scores = []
        for layer, d in zip(self.w_layers, diffs):
            w = layer.weight.reshape(-1).float()
            scores.append((d @ w + layer.bias.float()).mean(dim=(1, 2)))
        return F.relu(torch.stack(scores).mean(dim=0))


def conv_head_from_stats(head: ConvHeadAggregator,
                         stats: Sequence[Tensor]) -> Tensor:
    """:class:`ConvHeadAggregator` scores from per-layer spatial means of
    the squared diffs, shape ``(..., C_j)``: ``mean_hw(d @ w + b) ==
    mean_hw(d) @ w + b`` exactly, up to FP reduction order."""
    scores = [s.float() @ layer.weight.reshape(-1).float() + layer.bias.float()[0]
              for layer, s in zip(head.w_layers, stats)]
    return F.relu(torch.stack(scores).mean(dim=0))


class GlobalPairScorer(nn.Module):
    """score = model(a, b) for NHWC image batches a, b (stages_cnn)."""

    def __init__(self, cfg: GlobalModelConfig):
        super().__init__()
        if cfg.head_bias_init not in ("live", "torch"):
            raise ValueError(f"unknown head_bias_init {cfg.head_bias_init!r}")
        if cfg.head != "stages_cnn":
            raise NotImplementedError(
                f"head {cfg.head!r} is not ported yet (ROADMAP A4/A10); the "
                "port has stages_cnn")
        self.cfg = cfg
        self.backbone = make_backbone(cfg.backbone)
        self.tap_names = stage_taps_for(cfg.backbone.kind, cfg.depth)
        self.aggregator = ConvHeadAggregator(
            _STAGE_CHANNELS[3 - cfg.depth:], bias_init=cfg.head_bias_init)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh weights from ``generator``: Kaiming-normal (fan_in) convs
        and identity frozen BN in the tower, as the Flax init does, and the
        head's torch-default weights."""
        reset_tower(self.backbone, generator)
        self.aggregator.reset_parameters(generator)

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        n = a.shape[0]
        emb, taps = self.backbone(torch.cat([a, b], dim=0))
        taps_a = {k: v[:n] for k, v in taps.items()}
        taps_b = {k: v[n:] for k, v in taps.items()}
        return self.score_from_taps(emb[:n], emb[n:], taps_a, taps_b)

    def score_from_taps(self, emb_a: Tensor, emb_b: Tensor,
                        taps_a: Dict[str, Tensor],
                        taps_b: Dict[str, Tensor]) -> Tensor:
        """Head on precomputed tower outputs (the plain head; the scorer's
        kernel path is srsem_torch/ops/fused_head.py::fused_global_score)."""
        return self.aggregator(squared_diffs(taps_a, taps_b, self.tap_names))


def make_global_model(cfg: GlobalModelConfig,
                      generator: Optional[torch.Generator] = None
                      ) -> GlobalPairScorer:
    """A GlobalPairScorer on the CPU with weights drawn from ``generator``
    (move it with ``.to(device)``)."""
    model = GlobalPairScorer(cfg)
    model.reset_parameters(generator)
    return model.eval().requires_grad_(False)
