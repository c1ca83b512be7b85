"""Weights into the port's modules.

* ``load_jax_global_params`` — the JAX GlobalPairScorer variables, as
  numpy arrays, into the port's GlobalPairScorer: HWIO conv kernels →
  OIHW, FrozenBatchNorm scale/bias/mean/var → weight/bias/running_mean/
  running_var, Dense (C, 1) heads → Conv2d (1, C, 1, 1).
* ``load_torch_resnet50`` — a torchvision/timm ``resnet50`` state dict
  straight into the port's ImageNet tower (the layouts are the same).

The reverse direction needs no code here: the port's ``state_dict()`` is
in the torchvision layout, which srsem/utils/convert.py::
convert_torch_resnet50 and ::convert_global_head already read.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _tensor(v) -> torch.Tensor:
    return torch.tensor(np.array(v, np.float32, copy=True))


def jax_backbone_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ImageNetResNet50 params → torchvision-layout state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst: str, p):
        sd[f"{dst}.weight"] = _tensor(p["kernel"]).permute(3, 2, 0, 1).contiguous()

    def bn(dst: str, p):
        for src, name in _BN.items():
            sd[f"{dst}.{name}"] = _tensor(p[src])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"])
    for key, block in params.items():
        if not key.startswith("layer"):
            continue
        for c in (1, 2, 3):
            conv(f"{key}.conv{c}", block[f"conv{c}"])
            bn(f"{key}.bn{c}", block[f"bn{c}"])
        if "downsample_conv" in block:
            conv(f"{key}.downsample.0", block["downsample_conv"])
            bn(f"{key}.downsample.1", block["downsample_bn"])
    return sd


def load_jax_global_params(model: nn.Module, variables: Mapping[str, Any]):
    """Fill a port GlobalPairScorer from JAX ``{"params": {"backbone": ...,
    "aggregator": {"w_layers.{j}": {"kernel": (C, 1), "bias": (1,)}}}}``
    (numpy arrays).  Strict: every key must match.  Returns ``model``."""
    params = variables["params"]
    sd = {f"backbone.{k}": v
          for k, v in jax_backbone_state_dict(params["backbone"]).items()}
    for name, head in params["aggregator"].items():
        kernel = _tensor(head["kernel"])  # (C, 1)
        sd[f"aggregator.{name}.weight"] = kernel.t().reshape(1, -1, 1, 1).contiguous()
        sd[f"aggregator.{name}.bias"] = _tensor(head["bias"]).reshape(1)
    model.load_state_dict(sd, strict=True)
    return model


def load_torch_resnet50(backbone: nn.Module, state_dict: Mapping[str, Any]):
    """Load a torchvision/timm ``resnet50`` state dict (``.pt``) into the
    port's ImageNetResNet50: drops the classifier (``fc.*``) and BN
    ``num_batches_tracked`` counters, strips a ``module.`` prefix, then
    loads strictly.  Returns ``backbone``."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    backbone.load_state_dict(sd, strict=True)
    return backbone
