"""Panoptic-segmentation post-processing.

Rebuilds the reference's OneFormer post-processing
(reference: datasets/SRdatasetPseudolabelGen/oneformer_panoptic.py:18-97)
and mask splitting (caption_generation_vipllava.py:69-87).

These are deliberately host-side numpy/scipy: connected-component labeling
and the merge-until-converged loop have data-dependent iteration counts and
dynamic region shapes — exactly the control flow XLA can't tile — and they
run once per image at dataset-build time, not in the training hot path
(SURVEY.md §7 "hard parts" #5).  The segmentation model itself is a
pluggable VLM adapter (srsem_torch.pseudo.vlm).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

try:
    from scipy import ndimage

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover - scipy is in the base image
    _HAVE_SCIPY = False


def _label(mask: np.ndarray):
    if _HAVE_SCIPY:
        return ndimage.label(mask)
    # 4-connected two-pass fallback.
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    current = 0
    for i in range(h):
        for j in range(w):
            if mask[i, j] and labels[i, j] == 0:
                current += 1
                stack = [(i, j)]
                labels[i, j] = current
                while stack:
                    y, x = stack.pop()
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        ny, nx = y + dy, x + dx
                        if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                                and labels[ny, nx] == 0):
                            labels[ny, nx] = current
                            stack.append((ny, nx))
    return labels, current


def _dilate(mask: np.ndarray) -> np.ndarray:
    if _HAVE_SCIPY:
        return ndimage.binary_dilation(mask)
    out = mask.copy()
    out[1:] |= mask[:-1]
    out[:-1] |= mask[1:]
    out[:, 1:] |= mask[:, :-1]
    out[:, :-1] |= mask[:, 1:]
    return out


def reassign_disconnected_components(
    panoptic_map: np.ndarray, ignore_background: bool = False
) -> np.ndarray:
    """Give every spatially-connected region its own unique id
    (reference: oneformer_panoptic.py:18-45, including its exact id
    numbering: components of the k-th instance get ids offset by the running
    count + 1)."""
    np_map = np.asarray(panoptic_map)
    result = np.zeros_like(np_map)
    current_id = 1
    unique_ids = np.unique(np_map)
    if ignore_background:
        unique_ids = unique_ids[unique_ids != 0]
    for inst_id in unique_ids:
        labeled, num = _label(np_map == inst_id)
        for lab in range(1, num + 1):
            result[labeled == lab] = lab + current_id
        current_id += num
    return result


def filter_small_components(
    panoptic_map: np.ndarray, area_threshold_percent: float = 0.5,
    max_iterations: int = 100,
) -> np.ndarray:
    """Merge regions smaller than ``area_threshold_percent``% of the image
    into their most frequent neighboring label, iterating to convergence
    with a 100-iteration cap (reference: oneformer_panoptic.py:47-97)."""
    result = np.asarray(panoptic_map).copy()
    min_area = int((area_threshold_percent / 100.0) * result.size)
    for _ in range(max_iterations):
        changed = False
        for inst_id in np.unique(result):
            component = result == inst_id
            if component.sum() >= min_area:
                continue
            ring = _dilate(component) & ~component
            neighbor_labels = result[ring]
            neighbor_labels = neighbor_labels[neighbor_labels != inst_id]
            if neighbor_labels.size:
                values, counts = np.unique(neighbor_labels, return_counts=True)
                result[component] = values[np.argmax(counts)]
                changed = True
        if not changed:
            break
    return result


def panoptic_to_masks(panoptic_map: np.ndarray) -> Dict[int, np.ndarray]:
    """Split a panoptic id map into {id: boolean mask}
    (reference: caption_generation_vipllava.py:69-87)."""
    return {int(i): panoptic_map == i for i in np.unique(panoptic_map)}


def postprocess_panoptic(panoptic_map: np.ndarray,
                         area_threshold_percent: float = 0.5) -> np.ndarray:
    """The full reference post-processing chain: split disconnected ids,
    then erode small regions (reference: oneformer_panoptic.py:99-113)."""
    return filter_small_components(
        reassign_disconnected_components(panoptic_map),
        area_threshold_percent)
