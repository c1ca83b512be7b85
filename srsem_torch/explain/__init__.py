"""Explainability + classical-metric evaluation — the port of srsem/explain:
Grad-CAM on scalar targets, overlap metrics, PSNR/SSIM (+ sliding-window
maps), the embedder suite.

The JAX package's exports, loaded on first use: ``visual`` (matplotlib and
numpy) imports without torch, so ``visualize`` starts without it.
"""

import importlib

_EXPORTS = {
    "cosine_similarity_target": "targets", "mse_target": "targets",
    "vector_sum_target": "targets",
    "grad_cam": "gradcam", "grad_cam_matrix": "gradcam",
    "psnr": "iqa", "psnr_map": "iqa", "ssim": "iqa", "ssim_map": "iqa",
    "binarize_top_percent": "overlap", "overlap_metrics": "overlap",
    "similarity_matrix": "overlap",
    "EmbedderSuite": "embedders", "RamProjector": "embedders",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
