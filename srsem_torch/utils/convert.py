"""Weights into the port's modules.

* ``load_jax_global_params`` — the JAX GlobalPairScorer variables, as
  numpy arrays, into the port's GlobalPairScorer: HWIO conv kernels →
  OIHW, FrozenBatchNorm scale/bias/mean/var → weight/bias/running_mean/
  running_var, Dense (C, 1) heads → Conv2d (1, C, 1, 1).
* ``load_jax_local_params`` — the JAX CluUnet variables (``params`` for
  the tower and ``decoder.{lvl}``, plus ``batch_stats``), as numpy arrays,
  into the port's CluUnet.
* ``load_torch_resnet50`` — a torchvision/timm ``resnet50`` state dict
  straight into the port's ImageNet tower (the layouts are the same).
* ``load_clip_resnet50`` — an OpenAI-CLIP ``visual`` state dict straight
  into the port's CLIP tower (the layouts are the same).

The reverse direction needs no code here: the port's ``state_dict()`` is
in the torchvision / OpenAI-CLIP / reference-decoder layouts, which
srsem/utils/convert.py::convert_torch_resnet50, ::convert_clip_resnet50,
::convert_global_head and ::convert_clu_decoder already read.
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


def _oihw(kernel) -> torch.Tensor:
    return _tensor(kernel).permute(3, 2, 0, 1).contiguous()


def jax_backbone_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ImageNetResNet50 or ClipResNet50 params → torchvision- or
    OpenAI-CLIP-layout state dict (CLIP: ``stem.conv{i}`` → ``conv{i}``,
    ``stages.{s}.{b}`` → ``layer{s+1}.{b}``, ``attnpool.out_proj`` →
    ``attnpool.c_proj``)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst: str, p):
        sd[f"{dst}.weight"] = _oihw(p["kernel"])

    def bn(dst: str, p):
        for src, name in _BN.items():
            sd[f"{dst}.{name}"] = _tensor(p[src])

    for i in ("1", "2", "3"):
        for src in (f"conv{i}", f"stem.conv{i}"):
            if src in params:
                conv(f"conv{i}", params[src])
                bn(f"bn{i}", params[src.replace("conv", "bn")])
    for key, block in params.items():
        if key.startswith("stages."):
            _, s, b = key.split(".")
            key = f"layer{int(s) + 1}.{b}"
        elif not key.startswith("layer"):
            continue
        for c in (1, 2, 3):
            conv(f"{key}.conv{c}", block[f"conv{c}"])
            bn(f"{key}.bn{c}", block[f"bn{c}"])
        if "downsample_conv" in block:
            conv(f"{key}.downsample.0", block["downsample_conv"])
            bn(f"{key}.downsample.1", block["downsample_bn"])
    if "attnpool" in params:
        pool = params["attnpool"]
        sd["attnpool.positional_embedding"] = _tensor(pool["positional_embedding"])
        for src, dst in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                         ("v_proj", "v_proj"), ("out_proj", "c_proj")):
            sd[f"attnpool.{dst}.weight"] = _tensor(pool[src]["kernel"]).t().contiguous()
            sd[f"attnpool.{dst}.bias"] = _tensor(pool[src]["bias"])
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


def load_jax_local_params(model: nn.Module, variables: Mapping[str, Any]):
    """Fill a port CluUnet from JAX ``{"params": {"backbone": ...,
    "decoder.{lvl}": {conv1, bn1, conv2[, bn2]}}, "batch_stats":
    {"decoder.{lvl}": {bn1: {mean, var}[, bn2]}}}`` (numpy arrays) into the
    reference layout ``decoder.{lvl}.{0: conv, 1: BN, 3: conv, 4: BN}``.
    Strict: every key must match.  Returns ``model``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {f"backbone.{k}": v
          for k, v in jax_backbone_state_dict(params["backbone"]).items()}
    for name, block in params.items():
        if not name.startswith("decoder."):
            continue
        lvl = name.split(".")[1]
        for src, idx in (("conv1", 0), ("conv2", 3)):
            sd[f"decoder.{lvl}.{idx}.weight"] = _oihw(block[src]["kernel"])
            sd[f"decoder.{lvl}.{idx}.bias"] = _tensor(block[src]["bias"])
        for src, idx in (("bn1", 1), ("bn2", 4)):
            if src not in block:
                continue
            bn = {**block[src], **stats[name][src]}
            for key, dst in _BN.items():
                sd[f"decoder.{lvl}.{idx}.{dst}"] = _tensor(bn[key])
            sd[f"decoder.{lvl}.{idx}.num_batches_tracked"] = torch.tensor(0)
    model.load_state_dict(sd, strict=True)
    return model


def _strip(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a ``module.`` prefix and BN ``num_batches_tracked`` counters."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_clip_resnet50(backbone: nn.Module, state_dict: Mapping[str, Any]):
    """Load an OpenAI-CLIP state dict into the port's ClipResNet50: a whole
    model's (its ``visual.*`` keys; the text tower is dropped) or the
    visual tower's own.  Strict.  Returns ``backbone``."""
    sd = _strip(state_dict)
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    backbone.load_state_dict(sd, strict=True)
    return backbone


def load_torch_resnet50(backbone: nn.Module, state_dict: Mapping[str, Any]):
    """Load a torchvision/timm ``resnet50`` state dict (``.pt``) into the
    port's ImageNetResNet50: drops the classifier (``fc.*``) and BN
    ``num_batches_tracked`` counters, strips a ``module.`` prefix, then
    loads strictly.  Returns ``backbone``."""
    sd = {k: v for k, v in _strip(state_dict).items() if not k.startswith("fc.")}
    backbone.load_state_dict(sd, strict=True)
    return backbone
