"""Visualization: similarity heatmaps, image/CAM grids, SpLiCE bar plots —
a copy of srsem/explain/visual.py over srsem_torch/ops/npimage.py.

Rebuilds ``visual_utils``
(reference: additional_approaches/src/visual_utils.py:9-219) on bare
matplotlib: similarity-matrix heatmaps (:9-58), image grids (:61-111), CAM
overlay grids (:113-156), the combined grid analysis (:162-199) and SpLiCE
word-weight bar plots (:202-219).  CAM overlay uses a jet colormap blended
onto the image — the behavior of pytorch_grad_cam's ``show_cam_on_image``.
matplotlib and numpy only: nothing here imports torch or touches a card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _resize_bilinear_np(m: np.ndarray, out_hw) -> np.ndarray:
    """Pure-numpy half-pixel bilinear resize of a 2-D map
    (srsem_torch/ops/npimage.py): the visualization path never initializes
    CUDA, so a plotting command never claims a card a running ``serve``
    holds."""
    from srsem_torch.ops.npimage import resize_bilinear_np

    return resize_bilinear_np(np.asarray(m, np.float32), tuple(out_hw),
                              align_corners=False)


def overlay_cam(image01: np.ndarray, cam01: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Blend a [0,1] CAM onto a [0,1] HWC image with the jet colormap →
    uint8 HWC (pytorch_grad_cam show_cam_on_image semantics)."""
    from matplotlib import cm

    if cam01.shape != image01.shape[:2]:
        cam01 = _resize_bilinear_np(cam01, image01.shape[:2])
    heat = cm.jet(np.clip(cam01, 0, 1))[..., :3]
    blended = (1 - alpha) * np.clip(image01, 0, 1) + alpha * heat
    return (blended * 255).astype(np.uint8)


def plot_similarity_heatmap(matrix: np.ndarray, labels: Sequence[str] = None,
                            title: str = "", ax=None, annotate: bool = True):
    """(reference: visual_utils.py:9-58)"""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, cmap="viridis")
    ax.figure.colorbar(im, ax=ax)
    if labels is not None:
        ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
        ax.set_yticks(range(len(labels)), labels)
    if annotate:
        for i in range(matrix.shape[0]):
            for j in range(matrix.shape[1]):
                ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center",
                        va="center", fontsize=8, color="w")
    ax.set_title(title)
    return ax


def plot_image_grid(images: Sequence[np.ndarray],
                    titles: Sequence[str] = None, cols: int = 4,
                    figsize_per_cell: float = 2.5):
    """(reference: visual_utils.py:61-111)"""
    import matplotlib.pyplot as plt

    n = len(images)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * figsize_per_cell,
                                                  rows * figsize_per_cell))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i])
            if titles is not None and i < len(titles):
                ax.set_title(titles[i], fontsize=8)
    fig.tight_layout()
    return fig


def plot_cam_matrix(images01: Sequence[np.ndarray], cams: np.ndarray,
                    row_labels: Sequence[str] = None,
                    col_labels: Sequence[str] = None):
    """All-pairs CAM overlay grid (reference: visual_utils.py:113-156;
    pairs with srsem_torch.explain.gradcam.grad_cam_matrix)."""
    import matplotlib.pyplot as plt

    n_rows, n_cols = cams.shape[:2]
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(2.2 * n_cols, 2.2 * n_rows))
    axes = np.atleast_2d(axes)
    for i in range(n_rows):
        for j in range(n_cols):
            ax = axes[i, j]
            ax.axis("off")
            ax.imshow(overlay_cam(images01[i], cams[i, j]))
            if i == 0 and col_labels is not None:
                ax.set_title(col_labels[j], fontsize=8)
            if j == 0 and row_labels is not None:
                # axis('off') hides ylabel — draw the row label as text in
                # axes coordinates so it actually renders.
                ax.text(-0.06, 0.5, row_labels[i], fontsize=8,
                        rotation=90, va="center", ha="right",
                        transform=ax.transAxes)
    fig.tight_layout()
    return fig


def plot_splice_weights(words: Sequence[str], scores: Sequence[float],
                        title: str = "SpLiCE decomposition", ax=None):
    """Word-weight horizontal bars (reference: visual_utils.py:202-219)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 0.4 * max(4, len(words))))
    order = np.argsort(scores)
    ax.barh(np.arange(len(words)), np.asarray(scores)[order])
    ax.set_yticks(np.arange(len(words)),
                  [str(words[i]) for i in order])
    ax.set_title(title)
    return ax
