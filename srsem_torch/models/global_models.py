"""Global pair-scoring regressors ("CLIP-LPIPS") — the port of
srsem/models/global_models.py.

Shared numerics (reference: models/global_eval_models.py:341-397): run
both images through the frozen backbone; as in the JAX package the two
backbone passes are one pass on a 2N batch, and the head runs in float32.

==================  ====================================================
cfg.head            head
==================  ====================================================
stages_cnn          per tapped stage ``(f_a - f_b) ** 2``, a 1x1 conv to
                    one channel, the spatial mean; the mean over stages,
                    a final ReLU (``ConvHeadAggregator``)
wperlay_cnn         the same head over the last ``depth + 1`` of the CLIP
                    tower's 12 per-block taps (``wperlay_taps``)
stages_cnn_pooling  the float32 spatial mean of each tapped stage of A
                    and of B, concatenated, into ``MlpHead``
emb_lin             the two embeddings concatenated, into ``MlpHead``
unet_global         ``make_global_model`` returns the CLU ``CluUnet``
                    with ``sigmoid=False`` (a raw map)
stages_vit          on the CLIP ViT tower: per tapped block (every 3rd,
                    ``vit_block_taps(depth, step=3)``) ``(t_a - t_b) ** 2``
                    over (N, T, W) tokens, a Linear to one value, the
                    token mean; the mean over blocks, a final ReLU
                    (``TokenHeadAggregator``)
wperlay_vit         the same over the ``depth + 1`` deepest blocks
single_lin_vit      the same blocks as wperlay_vit, one Linear shared by
                    all of them (``w_layer``)
==================  ====================================================
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.backbones.resnet import (
    CLIP_STAGE_TAPS,
    IMAGENET_STAGE_TAPS,
    make_backbone,
    reset_tower,
)
from srsem_torch.backbones.vit import vit_block_taps
from srsem_torch.config import GlobalModelConfig
from srsem_torch.models.local_models import CluUnet

Tensor = torch.Tensor

#: Output channels of the four stage taps (BackboneConfig.stage_channels).
_STAGE_CHANNELS = (256, 512, 1024, 2048)
#: Embedding width of each tower: CLIP's attention pool, ImageNet's GAP.
_EMBED_WIDTH = {"resnet50_clip": 1024, "resnet50": 2048}
#: The heads ``ConvHeadAggregator`` serves.
CONV_HEADS = ("stages_cnn", "wperlay_cnn")
#: The heads ``TokenHeadAggregator`` serves, on the ViT tower.
TOKEN_HEADS = ("single_lin_vit", "stages_vit", "wperlay_vit")
#: The linear-to-scalar heads: the head kernel's (ops/fused_head.py).
KERNEL_HEADS = CONV_HEADS + TOKEN_HEADS


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


def wperlay_taps(depth: int) -> Tuple[str, ...]:
    """Last ``depth + 1`` of the CLIP tower's 12 per-block taps
    (reference: models/global_eval_models.py:832-833)."""
    names = [f"stages.{s}.{b}.act" for s in range(4) for b in range(3)]
    return tuple(names[11 - depth:])


def tap_channels(name: str) -> int:
    """Channels of a stage or block tap of either ResNet tower
    (``stages.{s}.{b}.act``, ``layer{s+1}.2.act3``)."""
    stage = (int(name.split(".")[1]) if name.startswith("stages.")
             else int(name.split(".")[0][len("layer"):]) - 1)
    return _STAGE_CHANNELS[stage]


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


class TokenHeadAggregator(nn.Module):
    """The ViT token head (srsem/models/global_models.py:320-343): per
    tapped block a Linear(W, 1) on the squared token diffs, the mean over
    tokens, then over blocks, a ReLU.  ``shared`` (single_lin_vit) uses one
    Linear for every block, ``w_layer`` = ``Sequential(Linear)`` (reference:
    models/global_eval_models.py:29-31); otherwise ``w_layers.{j}`` (:125,
    :227).  These are the reference's state-dict layouts, which
    srsem/utils/convert.py::convert_global_head reads."""

    def __init__(self, width: int, n_layers: int, shared: bool = False,
                 bias_init: str = "live"):
        super().__init__()
        head_bias_initializer(bias_init, 1)  # validate the mode early
        self.bias_init, self.n_layers, self.shared = bias_init, n_layers, shared
        if shared:
            self.w_layer = nn.Sequential(nn.Linear(width, 1))
        else:
            self.w_layers = nn.ModuleList(nn.Linear(width, 1)
                                          for _ in range(n_layers))

    def linears(self) -> List[nn.Linear]:
        """The head of each tapped block, in tap order (``n_layers`` times
        the one Linear when shared)."""
        if self.shared:
            return [self.w_layer[0]] * self.n_layers
        return list(self.w_layers)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's default ``U(±1/√W)`` weights (JAX's ``_head_init``);
        bias per ``bias_init``."""
        with torch.no_grad():
            for layer in dict.fromkeys(self.linears()):
                fan_in = layer.weight.shape[1]
                bound = fan_in ** -0.5
                layer.weight.uniform_(-bound, bound, generator=generator)
                head_bias_initializer(self.bias_init, fan_in)(
                    layer.bias, generator)

    def forward(self, diffs: List[Tensor]) -> Tensor:
        """(N, T, W) squared token diffs → (N,) scores."""
        scores = [(d @ layer.weight.reshape(-1).float()
                   + layer.bias.float()).mean(dim=1)
                  for layer, d in zip(self.linears(), diffs)]
        return F.relu(torch.stack(scores).mean(dim=0))


def token_head_from_stats(head: TokenHeadAggregator,
                          stats: Sequence[Tensor]) -> Tensor:
    """:class:`TokenHeadAggregator` scores from per-block token means of
    the squared diffs, shape ``(..., W)``: ``mean_t(d @ w + b) ==
    mean_t(d) @ w + b`` exactly, up to FP reduction order
    (srsem/models/global_models.py:219-234)."""
    scores = [s.float() @ layer.weight.reshape(-1).float() + layer.bias.float()[0]
              for layer, s in zip(head.linears(), stats)]
    return F.relu(torch.stack(scores).mean(dim=0))


def grouped_token_head(head: TokenHeadAggregator, taps_g: Dict[str, Tensor],
                       taps_s: Dict[str, Tensor],
                       names: Sequence[str]) -> Tensor:
    """(G, K) token-head scores of G GT taps against G·K SR taps: the
    plain counterpart of srsem/models/global_models.py::
    fused_grouped_token_head, through the module over the broadcast squared
    diffs (the head kernel folds the head into the reduction instead)."""
    g = taps_g[names[0]].shape[0]
    return head(grouped_diff_pyramid(taps_g, taps_s, names)).reshape(g, -1)


def conv_head_params(weights: Sequence, biases: Sequence[float]
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """A :class:`ConvHeadAggregator`'s parameters in the JAX layout
    (``w_layers.{j}``: Dense ``kernel`` (C_j, 1), ``bias`` (1,), float32
    numpy) from per-layer weight vectors and scalar biases — what the
    closed-form solver (srsem_torch/train/statcache.py) emits, as
    srsem/models/global_models.py:287-300 does."""
    return {
        f"w_layers.{j}": {
            "kernel": np.asarray(w, np.float32).reshape(-1, 1),
            "bias": np.asarray([b], np.float32),
        }
        for j, (w, b) in enumerate(zip(weights, biases))
    }


def token_head_params(weights: Sequence, biases: Sequence[float],
                      shared: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
    """The ViT token head's parameters in the JAX layout: the conv heads'
    Dense layout (``conv_head_params``), or with ``shared`` the singleLin
    ``w_layer`` from one weight and bias (srsem/models/global_models.py:
    305-317; reference: models/global_eval_models.py:29-31)."""
    params = conv_head_params(weights, biases)
    if not shared:
        return params
    if len(weights) != 1:
        raise ValueError("shared head takes exactly one weight vector")
    return {"w_layer": params["w_layers.0"]}


def _truncated_normal_(t: Tensor, std: float,
                       generator: Optional[torch.Generator]) -> Tensor:
    """``std`` times a standard normal truncated to [-2, 2], by the
    inverse CDF (as ``nn.init.trunc_normal_``)."""
    lo, hi = (math.erf(x / math.sqrt(2.0)) for x in (-2.0, 2.0))
    t.uniform_(lo, hi, generator=generator).erfinv_()
    return t.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


class MlpHead(nn.Module):
    """ReLU MLP ending in a scalar (reference fin_lin,
    models/global_eval_models.py:460-469,594-601): ``fin_lin`` is the
    reference's ``nn.Sequential``, Linear at the even indices and a ReLU
    after every Linear, the last one included, so
    srsem/utils/convert.py::convert_global_head reads its state dict.
    Runs in float32; (N, in_features) → (N,)."""

    def __init__(self, in_features: int, widths: Sequence[int]):
        super().__init__()
        layers: List[nn.Module] = []
        for width in widths:
            layers += [nn.Linear(in_features, width), nn.ReLU()]
            in_features = width
        self.fin_lin = nn.Sequential(*layers)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Kaiming-normal over fan_out, truncated at two deviations, and
        zero biases: the JAX package's ``_mlp_init`` (variance scaling 2.0,
        fan_out, truncated normal)."""
        with torch.no_grad():
            for m in self.fin_lin:
                if isinstance(m, nn.Linear):
                    std = math.sqrt(2.0 / m.out_features) / 0.87962566103423978
                    _truncated_normal_(m.weight, std, generator)
                    m.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return self.fin_lin(x.float())[..., 0]


class GlobalPairScorer(nn.Module):
    """score = model(a, b) for NHWC image batches a, b."""

    def __init__(self, cfg: GlobalModelConfig):
        super().__init__()
        head, depth, kind = cfg.head, cfg.depth, cfg.backbone.kind
        if cfg.head_bias_init not in ("live", "torch"):
            raise ValueError(f"unknown head_bias_init {cfg.head_bias_init!r}")
        if head == "unet_global":
            raise ValueError("head 'unet_global' is a CluUnet: build it with "
                             "make_global_model")
        if cfg.backbone.is_vit and head not in TOKEN_HEADS + ("emb_lin",):
            raise ValueError(f"head {head!r} taps a ResNet tower; the ViT "
                             f"takes {TOKEN_HEADS} and emb_lin")
        self.cfg = cfg
        self.backbone = make_backbone(cfg.backbone)
        bias = cfg.head_bias_init
        if head in TOKEN_HEADS:
            if not cfg.backbone.is_vit:
                raise ValueError(f"{head} taps the ViT tower's blocks; "
                                 f"backbone {kind!r} has none")
            # stages_vit taps every 3rd block, as ResNet's four stages
            # (reference: models/global_eval_models.py:116).
            self.tap_names = vit_block_taps(
                depth, total=cfg.backbone.vit_depth,
                step=3 if head == "stages_vit" else 1)
            self.aggregator = TokenHeadAggregator(
                cfg.backbone.vit_width, len(self.tap_names),
                shared=head == "single_lin_vit", bias_init=bias)
        elif head in ("stages_cnn", "stages_cnn_pooling"):
            if not 0 <= depth <= 3:
                raise ValueError(f"{head} taps depth + 1 of 4 stages, got "
                                 f"depth {depth}")
            self.tap_names = stage_taps_for(kind, depth)
            channels = _STAGE_CHANNELS[3 - depth:]
            self.aggregator = (
                ConvHeadAggregator(channels, bias_init=bias)
                if head == "stages_cnn" else
                # Widths mirror the reference's (sic) 2056/1028 (:460-469).
                MlpHead(2 * sum(channels), (2056, 1028, 512, 1)))
        elif head == "wperlay_cnn":
            if kind != "resnet50_clip":
                raise ValueError("wperlay_cnn taps the CLIP tower's per-block "
                                 f"taps; backbone {kind!r} has none")
            if not 0 <= depth <= 11:
                raise ValueError(f"wperlay_cnn taps depth + 1 of 12 blocks, "
                                 f"got depth {depth}")
            self.tap_names = wperlay_taps(depth)
            self.aggregator = ConvHeadAggregator(
                [_STAGE_CHANNELS[i // 3] for i in range(11 - depth, 12)],
                bias_init=bias)
        elif head == "emb_lin":
            self.tap_names = ()
            width = (cfg.backbone.vit_width if cfg.backbone.is_vit
                     else _EMBED_WIDTH[kind])
            self.aggregator = MlpHead(2 * width, (1028, 512, 1))
        else:
            raise ValueError(f"unknown global head {head!r}")

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh weights from ``generator``: the tower's Flax-like init
        (``reset_tower``) and the head's own (torch-default conv and token
        heads, Kaiming MLPs)."""
        reset_tower(self.backbone, generator)
        self.aggregator.reset_parameters(generator)

    @property
    def tower_trains(self) -> bool:
        """``enc_ft``: gradients reach the tower (no checkpointing, as in
        JAX)."""
        return self.cfg.enc_ft

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        n = a.shape[0]
        emb, taps = self.backbone(torch.cat([a, b], dim=0))
        if not self.tower_trains:
            emb, taps = emb.detach(), {k: v.detach() for k, v in taps.items()}
        taps_a = {k: v[:n] for k, v in taps.items()}
        taps_b = {k: v[n:] for k, v in taps.items()}
        return self.score_from_taps(emb[:n], emb[n:], taps_a, taps_b)

    def score_from_taps(self, emb_a: Tensor, emb_b: Tensor,
                        taps_a: Dict[str, Tensor],
                        taps_b: Dict[str, Tensor]) -> Tensor:
        """Head on precomputed tower outputs (the plain head; the scorer
        runs the conv and token heads through the head kernel,
        srsem_torch/ops/fused_head.py::fused_global_score, and the MLP
        heads here, as the JAX package leaves them to XLA)."""
        head = self.cfg.head
        if head == "emb_lin":
            return self.aggregator(torch.cat([emb_a.float(), emb_b.float()],
                                             dim=-1))
        if head == "stages_cnn_pooling":
            # Absolute (not diff) features: per-stage GAP, concat stages,
            # then concat A/B (reference :514-526).
            def pool(taps):
                return torch.cat([taps[n].float().mean(dim=(1, 2))
                                  for n in self.tap_names], dim=-1)

            return self.aggregator(torch.cat([pool(taps_a), pool(taps_b)],
                                             dim=-1))
        return self.aggregator(squared_diffs(taps_a, taps_b, self.tap_names))


def make_global_model(cfg: GlobalModelConfig,
                      generator: Optional[torch.Generator] = None
                      ) -> Union[GlobalPairScorer, CluUnet]:
    """A GlobalPairScorer on the CPU with weights drawn from ``generator``
    (move it with ``.to(device)``); for ``head="unet_global"`` the
    reference's global CLIP_lpips_Unet copy, the CLU decoder without the
    final sigmoid (reference: models/global_eval_models.py:921-1068)."""
    if cfg.head == "unet_global":
        model = CluUnet(backbone_kind=cfg.backbone.kind,
                        compute_dtype=getattr(torch, cfg.backbone.compute_dtype),
                        image_size=cfg.backbone.image_size, sigmoid=False)
    else:
        model = GlobalPairScorer(cfg)
    model.reset_parameters(generator)
    return model.eval().requires_grad_(False)
