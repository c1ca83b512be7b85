"""Plain float32 heads over tower taps: the stages head of the reference's
CLIP-LPIPS regressor (models/global_eval_models.py:308-429) and the
CLIP_lpips_Unet decoder (models/local_eval_models.py:38-124), written out
in ``torch`` operations.

The decoder's BatchNorm is written out too: eval mode normalizes by the
running statistics; train mode by the batch's (biased variance) and moves
the running statistics by 0.1 toward the batch's mean and unbiased
variance, as torch's BatchNorm2d does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
State = Dict[str, Tensor]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

IMAGENET_STAGE_TAPS = tuple(f"layer{s + 1}.2.act3" for s in range(4))
CLU_TAPS = ("stem.conv3",) + tuple(f"stages.{s}.2.act" for s in range(4))


def stage_taps(depth: int) -> Sequence[str]:
    """The ``depth + 1`` deepest ImageNet stage taps."""
    return IMAGENET_STAGE_TAPS[3 - depth:]


def ident(t: Tensor) -> Tensor:
    return t


def stages_scores(taps_a: State, taps_b: State, sd: State,
                  names: Sequence[str], prefix: str = "aggregator.",
                  q: Callable = ident) -> Tensor:
    """(N,) scores: per tap the spatial mean of a 1x1 conv to one channel
    of the squared diff, the mean over taps, a ReLU; ``q`` rounds the
    diff and the weight (the identity, or a control's lower precision)."""
    per_tap = []
    for j, name in enumerate(names):
        d = q(((taps_a[name] - taps_b[name]) ** 2).permute(0, 2, 3, 1))
        w = q(sd[f"{prefix}w_layers.{j}.weight"].reshape(-1, 1))
        b = sd[f"{prefix}w_layers.{j}.bias"][0]
        per_tap.append((d @ w)[..., 0].mean(dim=(1, 2)) + b)
    return F.relu(torch.stack(per_tap).mean(dim=0))


def batch_norm(x: Tensor, sd: State, key: str, train: bool,
               eps: float = 1e-5, momentum: float = 0.1) -> Tensor:
    """BatchNorm2d in float32; in ``train`` mode on batch statistics,
    moving ``sd``'s running statistics in place by ``momentum``."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            rm, rv = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
            rm.mul_(1 - momentum).add_(momentum * mean.detach())
            rv.mul_(1 - momentum).add_(momentum * var.detach() * n / (n - 1))
    else:
        mean, var = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
    xhat = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1)
                                                     + eps)
    return (xhat * sd[f"{key}.weight"].view(1, -1, 1, 1)
            + sd[f"{key}.bias"].view(1, -1, 1, 1))


def upsample2(x: Tensor) -> Tensor:
    """x2 bilinear upsampling with aligned corners (the reference's
    ``nn.UpsamplingBilinear2d(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def decoder_block(d: Tensor, u: Optional[Tensor], sd: State, lvl: int,
                  train: bool, momentum: float = 0.1,
                  prefix: str = "decoder.", q: Callable = ident) -> Tensor:
    """One decoder level; ``q`` rounds each conv's input and weight (the
    identity, or a control's lower precision)."""
    p = f"{prefix}{lvl}"
    w1, cd = sd[f"{p}.0.weight"], d.shape[1]
    # conv1 over [d, u] as the sum of its two slices' convs (no gradient
    # flows into the diffs).
    x = F.conv2d(q(d), q(w1[:, :cd]), sd[f"{p}.0.bias"], 1, 1)
    if u is not None:
        x = x + F.conv2d(q(u), q(w1[:, cd:]), None, 1, 1)
    x = F.relu(batch_norm(x, sd, f"{p}.1", train, momentum=momentum))
    w2 = sd[f"{p}.3.weight"]
    x = F.conv2d(q(x), q(w2), sd[f"{p}.3.bias"], 1, w2.shape[-1] // 2)
    if lvl > 0:
        x = batch_norm(x, sd, f"{p}.4", train, momentum=momentum)
    return F.relu(x)


def clu_maps(taps_a: State, taps_b: State, sd: State, train: bool = False,
             momentum: float = 0.1, names: Sequence[str] = CLU_TAPS,
             q: Callable = ident) -> Tensor:
    """(N, H, W) maps in [0, 1]: the squared-diff pyramid decoded from the
    deepest level up, each level's output upsampled x2 beside the next
    shallower diff, the sigmoid of the last level's one channel."""
    diffs: List[Tensor] = [(taps_a[n] - taps_b[n]) ** 2 for n in names]
    h = upsample2(decoder_block(diffs[-1], None, sd, len(diffs) - 1, train,
                                momentum, q=q))
    for lvl in range(len(diffs) - 2, -1, -1):
        h = upsample2(decoder_block(diffs[lvl], h, sd, lvl, train, momentum,
                                    q=q))
    return torch.sigmoid(h[:, 0])


def masked_mse(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """The mean squared error over the valid rows' pixels."""
    err = (pred - target) ** 2
    return (err * mask.view(-1, 1, 1)).sum() / (mask.sum() * err[0].numel())
