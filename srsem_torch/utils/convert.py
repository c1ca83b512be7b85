"""Weights into the port's modules.

* ``load_jax_global_params`` — the JAX GlobalPairScorer variables, as
  numpy arrays, into the port's GlobalPairScorer (every CNN head): HWIO
  conv kernels → OIHW, FrozenBatchNorm scale/bias/mean/var → weight/bias/
  running_mean/running_var, Dense (C, 1) heads ``w_layers.{j}`` → Conv2d
  (1, C, 1, 1), MLP Dense ``fin_lin.{j}`` (in, out) → ``fin_lin.{2j}``
  Linear (out, in).  ``unet_global``'s CluUnet takes
  ``load_jax_local_params``.
* ``load_jax_local_params`` — the JAX CluUnet variables (``params`` for
  the tower and ``decoder.{lvl}``, plus ``batch_stats``), as numpy arrays,
  into the port's CluUnet.
* Both take ``partial=True`` for a checkpoint's trainable subset
  (srsem_torch/train/checkpoint.py): what the tree holds is loaded over
  the model, which keeps the rest — the JAX CLI's
  ``merge_params(restored["trainable"], variables["params"])``.
* ``jax_trainable_params`` — the reverse for the trained subset: a
  model's heads or decoder (and BN statistics) in the JAX layout, what a
  checkpoint's ``trainable`` / ``batch_stats`` hold, to write with
  srsem_torch/train/checkpoint.py::save_checkpoint, with the tower's
  trained leaves under ``backbone``: LoRA's ``lora_a`` / ``lora_b`` of
  every conv, or under the full fine-tune and ``enc_ft`` every tower leaf
  (the FrozenBatchNorm statistics included), as
  srsem/train/partition.py::trainable_predicate selects them;
  ``jax_adam_state`` writes a ``torch.optim.Adam``'s state as the
  checkpoint's ``opt_state``.
* ``load_backbone_params`` — a JAX tower param tree or a torchvision /
  OpenAI-CLIP state dict into a ResNet tower; a JAX ClipViT tree, a timm
  ``vit_base_patch16_clip_224`` or an HF ``CLIPVisionModel`` state dict
  into the ViT (``load_clip_vit``).
* ``jax_vit_state_dict`` / ``jax_tower_params`` — the ViT both ways: the
  patch conv HWIO ↔ OIHW, Dense ``(in, out)`` ↔ Linear ``(out, in)``,
  LayerNorm ``scale`` ↔ ``weight``.
* ``load_torch_resnet50`` — a torchvision/timm ``resnet50`` state dict
  straight into the port's ImageNet tower (the layouts are the same).
* ``load_clip_resnet50`` — an OpenAI-CLIP ``visual`` state dict straight
  into the port's CLIP tower (the layouts are the same).

The ``convert`` command's producers, ``convert_torch_resnet50``,
``convert_clip_resnet50``, ``convert_clip_vit``, ``convert_hf_clip_vit``,
``convert_global_head`` and ``convert_clu_decoder``, build the nested
float32 numpy trees srsem/utils/convert.py's functions of those names
build, without flax; in ``jax_key_order`` the port's msgpack writer gives
the bytes ``srsem convert`` writes.  The port's own
``state_dict()`` is in the torchvision / OpenAI-CLIP / timm /
reference-head and reference-decoder layouts, which they read.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from srsem_torch.ops.lora import LORA_LEAVES
from srsem_torch.train.partition import flatten_dict, unflatten_dict

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _tensor(v) -> torch.Tensor:
    """A float32 CPU copy of a numpy array or a tensor (a checkpoint's
    bfloat16 leaves are tensors)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32, copy=True)
    return torch.tensor(np.array(v, np.float32, copy=True))


def _oihw(kernel) -> torch.Tensor:
    return _tensor(kernel).permute(3, 2, 0, 1).contiguous()


_BN_JAX = {v: k for k, v in _BN.items()}
_SHORTCUT = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_SHORTCUT_JAX = {v: k for k, v in _SHORTCUT.items()}
_PROJ = {"out_proj": "c_proj"}
_PROJ_JAX = {"c_proj": "out_proj"}


def _tower_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """``(state-dict key, layout)`` of a JAX tower leaf path; layout
    ``"conv"`` (HWIO kernel), ``"dense"`` ((in, out) kernel) or ``""``."""
    *mod, leaf = path
    if mod[0] == "attnpool":
        if len(mod) == 1:  # positional_embedding
            return f"attnpool.{leaf}", ""
        proj = f"attnpool.{_PROJ.get(mod[1], mod[1])}"
        return (f"{proj}.weight", "dense") if leaf == "kernel" else (
            f"{proj}.{leaf}", "")
    if mod[0].startswith("stages."):  # CLIP block
        _, s, b = mod[0].split(".")
        prefix, name = f"layer{int(s) + 1}.{b}.", mod[1]
    elif len(mod) == 2:  # ImageNet block
        prefix, name = f"{mod[0]}.", mod[1]
    else:  # a stem conv or BN
        prefix, name = "", mod[0].replace("stem.", "")
    key = prefix + _SHORTCUT.get(name, name)
    if "conv" in name:
        return (f"{key}.weight", "conv") if leaf == "kernel" else (
            f"{key}.{leaf}", "")
    return f"{key}.{_BN[leaf]}", ""


def _jax_tower_path(key: str, clip: bool) -> Tuple[Tuple[str, ...], str]:
    """The reverse of ``_tower_key``: a tower state-dict key's JAX path and
    layout (``clip``: the CLIP tower's ``stem.`` and ``stages.`` names)."""
    *mod, leaf = key.split(".")
    if mod[0] == "attnpool":
        if len(mod) == 1:
            return ("attnpool", leaf), ""
        proj = ("attnpool", _PROJ_JAX.get(mod[1], mod[1]))
        return (proj + ("kernel",), "dense") if leaf == "weight" else (
            proj + (leaf,), "")
    if mod[0].startswith("layer"):
        s, b = int(mod[0][len("layer"):]), mod[1]
        name = ".".join(mod[2:])
        top = (f"stages.{s - 1}.{b}" if clip else f"{mod[0]}.{b}",
               _SHORTCUT_JAX.get(name, name))
    else:
        top = (f"stem.{mod[0]}" if clip else mod[0],)
    if "conv" in top[-1]:
        return (top + ("kernel",), "conv") if leaf == "weight" else (
            top + (leaf,), "")
    return top + (_BN_JAX[leaf],), ""


# ---- the ViT tower -------------------------------------------------------

_VIT_TOP = ("cls_token", "pos_embed", "patch_embed", "norm_pre", "norm")


def _is_vit_tree(params: Mapping[str, Any]) -> bool:
    """Whether a JAX tower tree (or a subset of one) is a ClipViT's."""
    return any(k in _VIT_TOP or k.startswith("blocks.") for k in params)


def _vit_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """``(state-dict key, layout)`` of a JAX ClipViT leaf path: the patch
    conv's kernel ``"conv"`` (HWIO), a Dense kernel ``"dense"``."""
    *mod, leaf = path
    if not mod:  # cls_token, pos_embed
        return leaf, ""
    key = "patch_embed.proj" if mod[0] == "patch_embed" else ".".join(mod)
    if leaf == "kernel":
        return f"{key}.weight", "conv" if mod[0] == "patch_embed" else "dense"
    return f"{key}.{'weight' if leaf == 'scale' else leaf}", ""


def _jax_vit_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """The reverse of ``_vit_key``: a ClipViT state-dict key's JAX path
    and layout."""
    *mod, leaf = key.split(".")
    if not mod:
        return (leaf,), ""
    if mod[0] == "patch_embed":
        top: Tuple[str, ...] = ("patch_embed",)
    elif mod[0] == "blocks":
        top = (f"blocks.{mod[1]}", ".".join(mod[2:]))
    else:
        top = (mod[0],)
    if leaf == "weight" and "norm" in top[-1]:
        return top + ("scale",), ""
    if leaf == "weight":
        return top + ("kernel",), "conv" if top == ("patch_embed",) else "dense"
    return top + (leaf,), ""


def jax_vit_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ClipViT params, whole or a subset, → timm-layout state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flatten_dict(params).items():
        key, layout = _vit_key(path)
        sd[key] = (_oihw(value) if layout == "conv" else
                   _tensor(value).t().contiguous() if layout == "dense"
                   else _tensor(value))
    return sd


def hf_clip_vit_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """An HF ``CLIPVisionModel`` state dict (``vision_model.`` prefix or
    not) in the timm layout the port's ClipViT reads: q/k/v fused into
    ``attn.qkv`` (concatenated along the output dim), ``pre_layrnorm``
    (sic) / ``post_layernorm`` → ``norm_pre`` / ``norm``, a zero patch-conv
    bias (HF's has none), as srsem/utils/convert.py::convert_hf_clip_vit
    maps them."""
    sd = {k[len("vision_model."):] if k.startswith("vision_model.") else k: v
          for k, v in state_dict.items()}
    patch = _tensor(sd["embeddings.patch_embedding.weight"])
    width = patch.shape[0]
    pre = "pre_layrnorm" if "pre_layrnorm.weight" in sd else "pre_layernorm"
    out: Dict[str, Any] = {
        "patch_embed.proj.weight": patch,
        "patch_embed.proj.bias": torch.zeros(width),
        "cls_token": _tensor(sd["embeddings.class_embedding"]).reshape(1, 1, width),
        "pos_embed": _tensor(sd["embeddings.position_embedding.weight"]).reshape(
            1, -1, width),
        "norm_pre.weight": sd[f"{pre}.weight"], "norm_pre.bias": sd[f"{pre}.bias"],
        "norm.weight": sd["post_layernorm.weight"],
        "norm.bias": sd["post_layernorm.bias"],
    }
    layers = {int(m.group(1)) for k in sd
              if (m := re.match(r"encoder\.layers\.(\d+)\.", k))}
    for l in sorted(layers):
        tp, jp = f"encoder.layers.{l}", f"blocks.{l}"
        for leaf in ("weight", "bias"):
            out[f"{jp}.attn.qkv.{leaf}"] = torch.cat([
                _tensor(sd[f"{tp}.self_attn.{p}_proj.{leaf}"]) for p in "qkv"])
            out[f"{jp}.attn.proj.{leaf}"] = sd[f"{tp}.self_attn.out_proj.{leaf}"]
            for hf, ours in (("layer_norm1", "norm1"), ("layer_norm2", "norm2"),
                             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                out[f"{jp}.{ours}.{leaf}"] = sd[f"{tp}.{hf}.{leaf}"]
    return out


def load_clip_vit(backbone: nn.Module, state_dict: Mapping[str, Any]):
    """Load a timm ``vit_base_patch16_clip_224``-layout or an HF
    ``CLIPVisionModel`` state dict into the port's ClipViT: every tower
    key must be there; the rest (a classifier ``head``, LayerScale's
    identity ``ls1`` / ``ls2``) is dropped, as srsem/utils/convert.py's
    converters read only the tower's keys.  Returns ``backbone``."""
    sd = _strip(state_dict)
    if any(k.endswith("embeddings.patch_embedding.weight") for k in sd):
        sd = hf_clip_vit_state_dict(sd)
    own = backbone.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"ViT keys missing from the state dict: {missing[:6]}")
    backbone.load_state_dict(
        {k: _tensor(sd[k]).reshape(own[k].shape) for k in own}, strict=True)
    return backbone


def jax_backbone_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ImageNetResNet50 or ClipResNet50 params, whole or a
    checkpoint's subset (LoRA's ``lora_a`` / ``lora_b`` leaves), →
    torchvision- or OpenAI-CLIP-layout state dict (CLIP: ``stem.conv{i}``
    → ``conv{i}``, ``stages.{s}.{b}`` → ``layer{s+1}.{b}``,
    ``attnpool.out_proj`` → ``attnpool.c_proj``); a ClipViT's →
    ``jax_vit_state_dict``."""
    if _is_vit_tree(params):
        return jax_vit_state_dict(params)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flatten_dict(params).items():
        key, layout = _tower_key(path)
        sd[key] = (_oihw(value) if layout == "conv" else
                   _tensor(value).t().contiguous() if layout == "dense"
                   else _tensor(value))
    return sd


def jax_tower_params(backbone: nn.Module, keys,
                     value: Callable[[torch.Tensor], torch.Tensor]
                     ) -> Dict[str, Any]:
    """The tower parameters and buffers named by ``keys`` (state-dict keys
    of ``backbone``) as a nested JAX-layout tree of float32 numpy, each
    tensor mapped through ``value`` first (a ResNet or the ViT)."""
    clip = isinstance(getattr(backbone, "attnpool", None), nn.Module)
    vit = hasattr(backbone, "cls_token")
    own = {**dict(backbone.named_buffers()),
           **dict(backbone.named_parameters())}
    flat = {}
    for key in keys:
        path, layout = (_jax_vit_path(key) if vit
                        else _jax_tower_path(key, clip))
        t = value(own[key])
        flat[path] = _np(t.permute(2, 3, 1, 0) if layout == "conv" else
                         t.t() if layout == "dense" else t)
    return unflatten_dict(flat)


def trained_tower_keys(model: nn.Module):
    """The tower parameters a model trains, as srsem/train/partition.py
    selects them: every one under the full fine-tune (a CluUnet's
    ``lora_rank="full"``) and ``enc_ft``, the LoRA factors under an int
    ``lora_rank``, none for a frozen tower."""
    if not getattr(model, "tower_trains", False):
        return []
    keys = [k for k, _ in model.backbone.named_parameters()]
    if getattr(model, "lora_rank", None) not in (None, "full"):
        keys = [k for k in keys if k.split(".")[-1] in LORA_LEAVES]
    return keys


def _load(model: nn.Module, sd: Dict[str, torch.Tensor], partial: bool):
    """Load ``sd`` strictly, or with ``partial`` over the model's own
    state: every key must exist in the model with the same shape."""
    if partial:
        own = model.state_dict()
        unknown = sorted(set(sd) - set(own))
        if unknown:
            raise KeyError(f"not in the model: {unknown[:6]}")
        for key, v in sd.items():
            if tuple(v.shape) != tuple(own[key].shape):
                raise ValueError(f"{key}: shape {tuple(v.shape)}, the model "
                                 f"has {tuple(own[key].shape)}")
        sd = {**own, **sd}
    model.load_state_dict(sd, strict=True)
    return model


def _backbone(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "backbone" not in params:
        return {}
    return {f"backbone.{k}": v
            for k, v in jax_backbone_state_dict(params["backbone"]).items()}


def load_jax_global_params(model: nn.Module, variables: Mapping[str, Any],
                           partial: bool = False):
    """Fill a port GlobalPairScorer from JAX ``{"params": {"backbone": ...,
    "aggregator": {"w_layers.{j}": {"kernel": (C, 1), "bias": (1,)}},
    {"w_layer": ...} (the shared token head) or {"fin_lin.{j}":
    {"kernel": (in, out), "bias": (out,)}}}}`` (numpy arrays or tensors).
    Strict: every key must match, unless ``partial`` (see the module
    docstring).  Returns ``model``."""
    params = variables["params"]
    sd = _backbone(params)
    own = model.state_dict()
    for name, head in params.get("aggregator", {}).items():
        kernel = _tensor(head["kernel"])
        if name.startswith("fin_lin."):  # Dense j → Sequential index 2j
            dst = f"aggregator.fin_lin.{2 * int(name.split('.')[1])}"
            sd[f"{dst}.weight"] = kernel.t().contiguous()
            sd[f"{dst}.bias"] = _tensor(head["bias"])
            continue
        # (C, 1) Dense → (1, C, 1, 1) Conv2d or (1, W) Linear; the shared
        # w_layer is Sequential(Linear).
        dst = "aggregator.w_layer.0" if name == "w_layer" else f"aggregator.{name}"
        shape = (own[f"{dst}.weight"].shape if f"{dst}.weight" in own
                 else (1, -1, 1, 1))
        sd[f"{dst}.weight"] = kernel.t().reshape(shape).contiguous()
        sd[f"{dst}.bias"] = _tensor(head["bias"]).reshape(1)
    return _load(model, sd, partial)


def load_jax_local_params(model: nn.Module, variables: Mapping[str, Any],
                          partial: bool = False):
    """Fill a port CluUnet from JAX ``{"params": {"backbone": ...,
    "decoder.{lvl}": {conv1, bn1, conv2[, bn2]}}, "batch_stats":
    {"decoder.{lvl}": {bn1: {mean, var}[, bn2]}}}`` (numpy arrays or
    tensors) into the reference layout ``decoder.{lvl}.{0: conv, 1: BN,
    3: conv, 4: BN}``.  Strict: every key must match, unless ``partial``
    (see the module docstring).  Returns ``model``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _backbone(params)
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
            bn = {**block[src], **stats.get(name, {}).get(src, {})}
            for key, dst in _BN.items():
                if key in bn:
                    sd[f"decoder.{lvl}.{idx}.{dst}"] = _tensor(bn[key])
            sd[f"decoder.{lvl}.{idx}.num_batches_tracked"] = torch.tensor(0)
    return _load(model, sd, partial)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def jax_trainable_params(model: nn.Module,
                         value: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, batch_stats)`` of a model's trained subset in the JAX
    layout, float32 numpy: a GlobalPairScorer's ``{"aggregator": ...}``
    (``w_layers.{j}`` Dense (C, 1) or ``fin_lin.{j}`` Dense (in, out)) and
    no statistics, or a CluUnet's ``{"decoder.{lvl}": {conv1, bn1, conv2
    [, bn2]}}`` (HWIO kernels) and its BN running statistics; the tower's
    trained leaves (``trained_tower_keys``) under ``"backbone"``.  The
    loaders' ``partial`` mode reads both back.  ``value`` maps each
    parameter to the tensor written in its place, in the parameter's own
    layout (``jax_adam_state`` writes Adam's moments so)."""
    v = value or (lambda p: p)
    params, stats = _head_params(model, v)
    tower = trained_tower_keys(model)
    if tower:
        params = {"backbone": jax_tower_params(model.backbone, tower, v),
                  **params}
    return params, stats


def jax_head_params(aggregator: nn.Module,
                    value: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> Dict[str, Any]:
    """A global head's parameters in the JAX layout: ``w_layers.{j}``
    Dense (C, 1) of a ConvHeadAggregator or a TokenHeadAggregator (its
    ``w_layer`` when shared) or ``fin_lin.{j}`` Dense (in, out) of an
    MlpHead."""
    v = value or (lambda p: p)
    head: Dict[str, Any] = {}
    if hasattr(aggregator, "fin_lin"):
        linears = [m for m in aggregator.fin_lin if isinstance(m, nn.Linear)]
        for j, m in enumerate(linears):
            head[f"fin_lin.{j}"] = {"kernel": _np(v(m.weight).t()),
                                    "bias": _np(v(m.bias))}
    elif getattr(aggregator, "shared", False):
        m = aggregator.w_layer[0]
        head["w_layer"] = {"kernel": _np(v(m.weight).reshape(-1, 1)),
                           "bias": _np(v(m.bias))}
    else:
        for j, m in enumerate(aggregator.w_layers):
            head[f"w_layers.{j}"] = {"kernel": _np(v(m.weight).reshape(-1, 1)),
                                     "bias": _np(v(m.bias))}
    return head


def conv_head_from_params(params: Mapping[str, Any], bias_init: str = "live"):
    """A ConvHeadAggregator holding JAX-layout ``w_layers.{j}`` parameters
    (``conv_head_params``, a checkpoint's ``aggregator``)."""
    from srsem_torch.models.global_models import ConvHeadAggregator

    n = len(params)
    kernels = [_tensor(params[f"w_layers.{j}"]["kernel"]) for j in range(n)]
    head = ConvHeadAggregator([k.shape[0] for k in kernels], bias_init)
    with torch.no_grad():
        for j, (layer, k) in enumerate(zip(head.w_layers, kernels)):
            layer.weight.copy_(k.t().reshape(layer.weight.shape))
            layer.bias.copy_(_tensor(params[f"w_layers.{j}"]["bias"])
                             .reshape(1))
    return head


def _head_params(model: nn.Module, v: Callable[[torch.Tensor], torch.Tensor]):
    if hasattr(model, "aggregator"):
        return {"aggregator": jax_head_params(model.aggregator, v)}, {}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for lvl, block in enumerate(model.decoder):
        name = f"decoder.{lvl}"
        params[name], stats[name] = {}, {}
        for dst, idx in (("conv1", 0), ("conv2", 3)):
            params[name][dst] = {"kernel": _np(v(block[idx].weight).permute(2, 3, 1, 0)),
                                 "bias": _np(v(block[idx].bias))}
        for dst, idx in (("bn1", 1), ("bn2", 4)):
            if isinstance(block[idx], nn.BatchNorm2d):
                bn = block[idx]
                params[name][dst] = {"scale": _np(v(bn.weight)),
                                     "bias": _np(v(bn.bias))}
                stats[name][dst] = {"mean": _np(bn.running_mean),
                                    "var": _np(bn.running_var)}
    return params, stats


def jax_adam_state(model: nn.Module, optimizer: torch.optim.Adam) -> Dict[str, Any]:
    """``torch.optim.Adam``'s state over a model's trained subset as the
    JAX package's checkpoints hold ``optax.adam``'s (a ``(ScaleByAdamState,
    EmptyState)`` tuple, as flax serializes it): ``{"0": {"count": int32,
    "mu": ..., "nu": ...}, "1": {}}`` with ``mu`` / ``nu`` (Adam's
    ``exp_avg`` / ``exp_avg_sq``) in ``jax_trainable_params``'s layout.
    The two updates are the same (bias correction, eps outside the square
    root); a parameter Adam has not stepped yet has zero moments."""
    state = optimizer.state

    def moment(key: str):
        return lambda p: state[p][key] if p in state else torch.zeros_like(p)

    steps = {int(s["step"]) for s in state.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters are at different steps {steps}")
    mu, _ = jax_trainable_params(model, moment("exp_avg"))
    nu, _ = jax_trainable_params(model, moment("exp_avg_sq"))
    count = np.asarray(steps.pop() if steps else 0, np.int32)
    return {"0": {"count": count, "mu": mu, "nu": nu}, "1": {}}


def load_backbone_params(backbone: nn.Module, kind: str, params: Mapping[str, Any]):
    """A tower's weights into ``backbone``, strictly: a JAX-layout param
    tree (nested, as ``srsem convert`` writes and ``msgpack_restore`` reads
    it), a torchvision ``resnet50`` / OpenAI-CLIP state dict, or for
    ``vit_clip`` a timm / HF CLIP ViT state dict (flat, of tensors).
    Returns ``backbone``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return _load_tower(backbone, jax_backbone_state_dict(params))
    if kind == "vit_clip":
        return load_clip_vit(backbone, params)
    if kind == "resnet50_clip":
        return load_clip_resnet50(backbone, params)
    return load_torch_resnet50(backbone, params)


def _load_tower(backbone: nn.Module, sd: Mapping[str, Any]):
    """Load a tower's weights strictly, except LoRA factors the file does
    not hold: the tower keeps its own (a tower file is the base tower; a
    LoRA checkpoint then loads the factors over it)."""
    own = {k: v for k, v in backbone.state_dict().items()
           if k.split(".")[-1] in LORA_LEAVES and k not in sd}
    backbone.load_state_dict({**own, **sd}, strict=True)
    return backbone


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
    return _load_tower(backbone, sd)


def load_torch_resnet50(backbone: nn.Module, state_dict: Mapping[str, Any]):
    """Load a torchvision/timm ``resnet50`` state dict (``.pt``) into the
    port's ImageNetResNet50: drops the classifier (``fc.*``) and BN
    ``num_batches_tracked`` counters, strips a ``module.`` prefix, then
    loads strictly.  Returns ``backbone``."""
    sd = {k: v for k, v in _strip(state_dict).items() if not k.startswith("fc.")}
    return _load_tower(backbone, sd)


# ---- the ``convert`` command's trees -----------------------------------
# srsem/utils/convert.py's producers without flax: the same trees of
# float32 numpy leaves, the towers' through the port's loaders and
# ``jax_tower_params``; written in ``jax_key_order``, msgpack_serialize
# gives the bytes ``srsem convert`` writes.


def jax_key_order(tree: Any) -> Any:
    """``tree`` with every dict's keys sorted: the order ``jax.device_get``
    (a ``tree_map``) gives the trees the JAX CLI writes."""
    if isinstance(tree, Mapping):
        return {k: jax_key_order(tree[k]) for k in sorted(tree)}
    return tree


def _f32(v) -> np.ndarray:
    """A float32 numpy copy (srsem/utils/convert.py::_np)."""
    return _np(_tensor(v))


def _hwio(w) -> np.ndarray:
    return _f32(w).transpose(2, 3, 1, 0)  # OIHW → HWIO


def _converted(backbone: nn.Module, load: Callable, sd: Mapping[str, Any]
               ) -> Dict:
    """``sd`` loaded into ``backbone`` by ``load`` (strictly: every tower
    key must be there), then the whole tower as its JAX tree."""
    load(backbone, sd)
    return jax_tower_params(backbone, backbone.state_dict(), lambda t: t)


def _resnet(kind: str) -> nn.Module:
    from srsem_torch.backbones.resnet import make_backbone
    from srsem_torch.config import BackboneConfig

    return make_backbone(BackboneConfig(kind=kind))


def convert_torch_resnet50(sd: Mapping[str, Any]) -> Dict:
    """torchvision/timm ``resnet50`` state dict (a ``module.`` prefix or
    not; the classifier dropped) → ImageNetResNet50 params."""
    return _converted(_resnet("resnet50"), load_torch_resnet50, sd)


def convert_clip_resnet50(sd: Mapping[str, Any]) -> Dict:
    """OpenAI CLIP ``visual`` tower state dict (``visual.`` prefix or not)
    → ClipResNet50 params (``stem.conv{i}``, ``stages.{s-1}.{b}``, the
    attention pool's Dense projections)."""
    return _converted(_resnet("resnet50_clip"), load_clip_resnet50, sd)


def convert_clip_vit(sd: Mapping[str, Any]) -> Dict:
    """timm ``vit_base_patch16_clip_224``-layout state dict → ClipViT
    params, through a ClipViT of the file's patch, width, depth and
    positional grid; LayerScale's identity ``ls1`` / ``ls2`` and any key
    outside the tower are dropped."""
    from srsem_torch.backbones.vit import ClipViT

    sd = _strip(sd)
    width = _tensor(sd["cls_token"]).shape[-1]
    tokens = _tensor(sd["pos_embed"]).numel() // width
    depth = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.match(r"blocks\.(\d+)\.", k)))
    # The heads split the attention, not its weights: one fits any width.
    vit = ClipViT(_tensor(sd["patch_embed.proj.weight"]).shape[-1], width,
                  depth, heads=1, pos_grid=math.isqrt(tokens - 1))
    return _converted(vit, load_clip_vit, sd)


def convert_hf_clip_vit(sd: Mapping[str, Any]) -> Dict:
    """HF ``CLIPVisionModel`` state dict → ClipViT params (q/k/v fused into
    ``attn.qkv``, a zero patch bias; see ``hf_clip_vit_state_dict``)."""
    return convert_clip_vit(hf_clip_vit_state_dict(sd))


def _prefixed(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_global_head(sd: Mapping[str, Any], shared: bool = False) -> Dict:
    """The reference's trained-head state dict (``save_model``:
    ``{j}.weight`` / ``{j}.bias`` of Conv2d (1, C, 1, 1) or Linear (1, W)
    heads, or a full enc_ft state dict filtered on ``w_layers.`` /
    ``w_layer.`` / ``fin_lin.``) → ``{"aggregator": ...}``; ``shared``
    reads the singleLin ``w_layer``.  The port's own aggregators'
    ``state_dict()`` is in these layouts."""
    if any(k.startswith(("w_layers.", "w_layer.", "fin_lin.")) for k in sd):
        lin = _prefixed(sd, "fin_lin.")
        if lin:
            idxs = sorted({int(k.split(".")[0]) for k in lin})
            return {"aggregator": {
                f"fin_lin.{j}": {"kernel": _f32(lin[f"{i}.weight"]).T,
                                 "bias": _f32(lin[f"{i}.bias"])}
                for j, i in enumerate(idxs)}}
        sd = _prefixed(sd, "w_layer." if shared else "w_layers.")
        if not sd:
            raise ValueError(
                "no head keys survived the prefix filter — a 'w_layer.'-"
                "prefixed (singleLin) checkpoint needs shared=True "
                "(CLI: --shared-head); a 'w_layers.' one needs shared=False")
    idxs = sorted({int(k.split(".")[0]) for k in sd if "." in k})
    if not idxs:
        raise ValueError(
            f"no '{{index}}.weight' head entries found (keys: "
            f"{sorted(sd)[:6]}...) — is this really a save_model head "
            "state dict?")
    heads = {}
    for j in idxs:
        w = _f32(sd[f"{j}.weight"])
        kernel = w[0, :, 0, 0][:, None] if w.ndim == 4 else w.T
        heads[f"w_layers.{j}"] = {"kernel": kernel, "bias": _f32(sd[f"{j}.bias"])}
    if shared:
        if len(idxs) != 1:
            raise ValueError(f"shared head expects ONE linear, got indices {idxs}")
        heads = {"w_layer": heads["w_layers.0"]}
    return {"aggregator": heads}


def convert_clu_decoder(sd: Mapping[str, Any]) -> Dict:
    """The reference's trained CLU decoder state dict (``{lvl}.{0,1,3,4}``
    of conv, BN, conv, BN; or a full state dict filtered on ``decoder.``)
    → ``{"params": {"decoder.{lvl}": ...}, "batch_stats": ...}``."""
    if any("lora" in k.lower() for k in sd):
        raise ValueError(
            "state dict contains LoRA weights — convert the backbone "
            "subtree with convert_clip_resnet50/convert_torch_resnet50 "
            "(LoRA factors follow pytora's layout and need the lora_a/"
            "lora_b mapping) instead of dropping it")
    if any(k.startswith("decoder.") for k in sd):
        sd = _prefixed(sd, "decoder.")
    params: Dict[str, Dict] = {}
    stats: Dict[str, Dict] = {}
    for lvl in sorted({int(k.split(".")[0]) for k in sd if "." in k}):
        block = {
            "conv1": {"kernel": _hwio(sd[f"{lvl}.0.weight"]),
                      "bias": _f32(sd[f"{lvl}.0.bias"])},
            "bn1": {"scale": _f32(sd[f"{lvl}.1.weight"]),
                    "bias": _f32(sd[f"{lvl}.1.bias"])},
            "conv2": {"kernel": _hwio(sd[f"{lvl}.3.weight"]),
                      "bias": _f32(sd[f"{lvl}.3.bias"])},
        }
        bstats = {"bn1": {"mean": _f32(sd[f"{lvl}.1.running_mean"]),
                          "var": _f32(sd[f"{lvl}.1.running_var"])}}
        if f"{lvl}.4.weight" in sd:  # level 0 has no second BN
            block["bn2"] = {"scale": _f32(sd[f"{lvl}.4.weight"]),
                            "bias": _f32(sd[f"{lvl}.4.bias"])}
            bstats["bn2"] = {"mean": _f32(sd[f"{lvl}.4.running_mean"]),
                             "var": _f32(sd[f"{lvl}.4.running_var"])}
        params[f"decoder.{lvl}"] = block
        stats[f"decoder.{lvl}"] = bstats
    return {"params": params, "batch_stats": stats}
