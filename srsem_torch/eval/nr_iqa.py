"""No-reference IQA head — the port of srsem/eval/nr_iqa.py.

A five-output regression head (overall quality and the four distortion
dimensions of KonIQ++) over the frozen ImageNet ResNet-50: the GAP of each
stage's last block (``IMAGENET_STAGE_TAPS``) in float32, concatenated
(256 + 512 + 1024 + 2048 = 3,840 features), a LayerNorm (Flax's epsilon,
1e-6), then fc1 512 → ReLU → fc2 256 → ReLU → out 5 (zero-initialized).

The tower is frozen: it runs under ``no_grad`` through the fused tower
(srsem_torch/backbones/fused_resnet.py, the Hopper bottleneck kernel on
the card) with its BN-folded weights computed once (``fold``).  Its
weights are the JAX package's ``params["backbone"]`` layout through
``load_jax_nr_iqa``, the head's ``head.*`` Dense and LayerNorm leaves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from srsem_torch.backbones.fused_resnet import fold_tower, fused_imagenet_apply
from srsem_torch.backbones.resnet import (
    IMAGENET_STAGE_TAPS,
    ImageNetResNet50,
    reset_tower,
)
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.train.partition import unflatten_dict

Tensor = torch.Tensor

OUTPUT_NAMES = ("Koniq++IQA", "Koniq++blur", "Koniq++artifacts",
                "Koniq++contrast", "Koniq++color")

#: GAP features: the four tapped stages' widths.
FEATURES = 256 + 512 + 1024 + 2048

#: JAX leaf names of the head's modules, and the torch ones.
_HEAD = ("norm", "fc1", "fc2", "out")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


class _Mlp(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(FEATURES, eps=1e-6)
        self.fc1 = nn.Linear(FEATURES, hidden)
        self.fc2 = nn.Linear(hidden, hidden // 2)
        self.out = nn.Linear(hidden // 2, len(OUTPUT_NAMES))

    def forward(self, pooled: Tensor) -> Tensor:
        h = torch.relu(self.fc1(self.norm(pooled)))
        return self.out(torch.relu(self.fc2(h)))


class NrIqaHead(nn.Module):
    """Frozen tower → per-stage GAP → concat → MLP → 5 quality scores, on
    ImageNet-normalized NHWC images."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 hidden: int = 512):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = ImageNetResNet50(dtype=compute_dtype)
        self.backbone.requires_grad_(False)
        self.head = _Mlp(hidden)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The tower as ``reset_tower`` draws it, the Dense kernels
        LeCun-normal and the output's zero, zero biases, a unit LayerNorm
        (Flax's initializers)."""
        reset_tower(self.backbone, generator)
        with torch.no_grad():
            for lin in (self.head.fc1, self.head.fc2):
                lin.weight.normal_(0.0, lin.in_features ** -0.5,
                                   generator=generator)
                lin.bias.zero_()
            self.head.out.weight.zero_()
            self.head.out.bias.zero_()
            self.head.norm.reset_parameters()
        return self

    def fold(self) -> List[list]:
        """The tower's BN-folded weights for the fused tower; computed once
        a scorer or a training run, after the weights are loaded."""
        return fold_tower(self.backbone, self.compute_dtype)

    @torch.no_grad()
    def features(self, x: Tensor, folded: Optional[List[list]] = None
                 ) -> Tensor:
        """(N, 3840) float32 GAP features of the frozen tower."""
        _, taps = fused_imagenet_apply(self.backbone, x, self.compute_dtype,
                                       folded=folded or self.fold())
        return torch.cat([taps[n].float().mean(dim=(1, 2))
                          for n in IMAGENET_STAGE_TAPS], dim=-1)

    def forward(self, x: Tensor, folded: Optional[List[list]] = None
                ) -> Tensor:
        return self.head(self.features(x, folded))


def load_jax_nr_iqa(model: NrIqaHead, params: Mapping[str, Any],
                    partial: bool = False) -> NrIqaHead:
    """JAX ``NrIqaHead`` params (``backbone`` and the ``head.*`` leaves;
    numpy arrays or tensors) into ``model``: strictly, or with ``partial``
    only what ``params`` holds (a checkpoint's ``trainable`` head)."""
    from srsem_torch.utils.convert import jax_backbone_state_dict

    sd: Dict[str, Tensor] = {}
    if "backbone" in params:
        sd.update({f"backbone.{k}": v for k, v in
                   jax_backbone_state_dict(params["backbone"]).items()})
    for name in _HEAD:
        for leaf, value in params.get(f"head.{name}", {}).items():
            t = torch.from_numpy(np.array(value, np.float32))
            sd[f"head.{name}.{_LEAF[leaf]}"] = (t.t().contiguous()
                                                if leaf == "kernel" else t)
    if partial:
        sd = {**model.state_dict(), **sd}
    model.load_state_dict(sd, strict=True)
    return model


def jax_head_params(model: NrIqaHead) -> Dict[str, Any]:
    """The head's leaves in the JAX layout (``head.fc1/kernel`` (in, out),
    ``head.norm/scale``, ...): a checkpoint's ``trainable``."""
    flat = {}
    for name in _HEAD:
        mod = getattr(model.head, name)
        w = mod.weight.detach().float().cpu()
        flat[(f"head.{name}", "scale" if name == "norm" else "kernel")] = \
            (w if name == "norm" else w.t()).numpy().copy()
        flat[(f"head.{name}", "bias")] = \
            mod.bias.detach().float().cpu().numpy().copy()
    return unflatten_dict(flat)


class NrIqaScorer:
    """The KonIQ++ backend of ImageQualityMetrics: ``__call__`` on a path →
    score dict, ``batch`` on a normalized NHWC batch → (N, 5)."""

    def __init__(self, model: NrIqaHead, image_size: int = 224,
                 device: DeviceLike = None):
        from srsem_torch.data.preprocess import Preprocess

        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.folded = self.model.fold()
        self.preprocess = Preprocess.for_backbone("resnet50", image_size)

    @torch.no_grad()
    def batch(self, images) -> Tensor:
        """Normalized NHWC batch (on any device, or numpy) → (N, 5) on the
        scorer's device."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        return self.model(x, self.folded)

    def __call__(self, path: str) -> Dict[str, float]:
        out = self.batch(self.preprocess(path)[None])[0]
        return dict(zip(OUTPUT_NAMES, out.cpu().tolist()))

