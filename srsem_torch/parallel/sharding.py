"""Column-parallel tower weights over the mesh's model axis — the port of
srsem/parallel/sharding.py.

The JAX package shards the output-channel dimension of every large
``kernel`` (HWIO convs, (in, out) dense layers: the last dimension) over
``model`` and lets GSPMD insert the all-gathers.  The port's convs are
OIHW and its linear layers (out, in): the output channels come first.
``param_shardings`` keeps each model rank's slice of those rows (and of a
LoRA factor's columns), and the layer's output is all-gathered along
channels by ``core.meshes.gather_shards``, whose backward hands each rank
its slice of the gradient.  A LoRA or fully trained tower therefore
trains under it too, each rank updating its slice.

The folded kernel tower (backbones/fused_resnet.py) needs whole conv
weights: a sharded tower runs as its module (``resolve_fused_tower``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from srsem_torch.backbones.resnet import AttentionPool2d, LoraConv2d
from srsem_torch.core.meshes import MODEL_AXIS, Mesh


def _spec_for(module: nn.Module, leaf: str, p: torch.Tensor,
              min_shard_dim: int) -> Tuple:
    """Shard the output-channel (first) dimension of big conv and linear
    weights over the model axis; replicate everything else (BN
    statistics, biases, LoRA factors are O(channels))."""
    if leaf != "weight" or not isinstance(module, (nn.Conv2d, nn.Linear)):
        return ()
    if p.dim() < 2 or p.shape[0] < min_shard_dim:
        return ()
    return (MODEL_AXIS,) + (None,) * (p.dim() - 1)


def param_pspecs(model: nn.Module, min_shard_dim: int = 1024
                 ) -> Dict[str, Tuple]:
    """``{parameter name: spec}``: ``("model", None, ...)`` for the
    weights JAX shards, ``()`` for the replicated rest."""
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        out[name] = _spec_for(model.get_submodule(mod_name), leaf, p,
                              min_shard_dim)
    return out


def _gathers(model: nn.Module, mod_name: str) -> bool:
    """Whether the module's forward gathers a sharded output: the tower
    convs (``conv_nchw``) and the attention pool's projections."""
    module = model.get_submodule(mod_name)
    if isinstance(module, LoraConv2d):
        return True
    parent = model.get_submodule(mod_name.rpartition(".")[0])
    return isinstance(module, nn.Linear) and isinstance(parent,
                                                         AttentionPool2d)


def param_shardings(mesh: Mesh, model: nn.Module,
                    min_shard_dim: int = 1024) -> nn.Module:
    """Shard ``model``'s large weights over ``mesh``'s model axis in place
    and return it.  With a trivial model axis this does nothing, so the
    same code path serves one card and many.  Takes a ResNet tower (or a
    model holding one): the layers it shards must gather their output."""
    m = mesh.shape[MODEL_AXIS]
    if m <= 1:
        return model
    i = mesh.model_index
    for name, spec in param_pspecs(model, min_shard_dim).items():
        if not spec:
            continue
        mod_name = name.rpartition(".")[0]
        if not _gathers(model, mod_name):
            raise ValueError(
                f"{mod_name} cannot be sharded: param_shardings shards "
                "tower convs and attention-pool projections")
        module = model.get_submodule(mod_name)
        out = module.weight.shape[0]
        if out % m:
            raise ValueError(f"{mod_name}: {out} output channels do not "
                             f"divide over model={m}")
        rows = slice(i * out // m, (i + 1) * out // m)
        with torch.no_grad():
            for leaf, dim in (("weight", 0), ("bias", 0), ("lora_b", 1)):
                p = getattr(module, leaf, None)
                if p is None:
                    continue
                part = p[rows] if dim == 0 else p[:, rows]
                setattr(module, leaf, nn.Parameter(
                    part.clone(), requires_grad=p.requires_grad))
        module.model_mesh = mesh
    return model


def is_sharded(model: nn.Module) -> bool:
    """Whether ``param_shardings`` sharded any of ``model``'s layers."""
    return any(getattr(m, "model_mesh", None) is not None
               for m in model.modules())


def require_sharded(mesh, model: nn.Module) -> None:
    """Refuse a model axis over which ``model`` holds no slice: its ranks
    would each compute the same replica.  ``mesh`` None is no mesh."""
    m = 1 if mesh is None else mesh.shape[MODEL_AXIS]
    if m > 1 and not is_sharded(model):
        raise ValueError(
            f"mesh model axis of {m} but nothing is sharded over it: call "
            "param_shardings(mesh, tower) first, or use model_axis=1")
