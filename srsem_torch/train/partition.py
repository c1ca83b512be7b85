"""Trainable/frozen parameter partitioning — the port of
srsem/train/partition.py, on nested dicts keyed by str with tuple paths
(flax.traverse_util's ``flatten_dict`` / ``unflatten_dict`` semantics:
empty dicts vanish when flattened).

A checkpoint holds the trainable half only; the scoring CLIs merge its
``"trainable"`` tree back over the model's parameters (``merge_params``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

Path = Tuple[str, ...]
PathPredicate = Callable[[Path], bool]


def trainable_predicate(enc_ft: bool = False, lora: bool = False,
                        full_finetune: bool = False,
                        backbone_key: str = "backbone") -> PathPredicate:
    """Which param paths train: everything outside the backbone (heads,
    decoder); with ``lora`` also the backbone's ``lora_a`` / ``lora_b``;
    with ``enc_ft`` or ``full_finetune`` everything."""

    def pred(path: Path) -> bool:
        if enc_ft or full_finetune or path[0] != backbone_key:
            return True
        return lora and any(p in ("lora_a", "lora_b") for p in path)

    return pred


def flatten_dict(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    """``{path tuple: leaf}``; a leaf is anything that is not a mapping."""
    out: Dict[Path, Any] = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            out.update(flatten_dict(value, path))
        else:
            out[path] = value
    return out


def unflatten_dict(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        cursor = out
        for key in path[:-1]:
            cursor = cursor.setdefault(key, {})
        cursor[path[-1]] = value
    return out


def partition_params(params: Mapping[str, Any], predicate: PathPredicate):
    """Split a nested param dict into ``(trainable, frozen)`` nested dicts."""
    flat = flatten_dict(params)
    return (unflatten_dict({k: v for k, v in flat.items() if predicate(k)}),
            unflatten_dict({k: v for k, v in flat.items() if not predicate(k)}))


def merge_params(trainable: Mapping[str, Any],
                 frozen: Mapping[str, Any]) -> Dict[str, Any]:
    """``frozen`` with every leaf of ``trainable`` put over it."""
    flat = flatten_dict(frozen)
    flat.update(flatten_dict(trainable))
    return unflatten_dict(flat)
