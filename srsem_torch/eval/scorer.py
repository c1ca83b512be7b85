"""Batched pair scoring — the port of srsem/eval/scorer.py::PairScorer:
``model_kind="global"`` gives one score a pair, ``"local"`` a CLU
fidelity map.

* host threads decode JPEG/PNG and do the antialiased resize + crop to
  uint8 (srsem_torch/data/preprocess.py: PIL, or the native C++ decoder
  with ``decode_backend="native"``);
* uint8 batches go to the device (3 bytes a pixel), where normalize →
  tower → head run;
* double-buffering: batch i+1 decodes while batch i computes;
* failed decodes give NaN rows (reference:
  datasets/SRdatasetPseudolabelGen/1_compute_image_metrics.py:119-134).

``fused_tower`` on runs the tower's interior blocks through the Hopper
bottleneck kernel (srsem_torch/backbones/fused_resnet.py); ``False`` runs
the module's plain ``F.conv2d`` chain, the counterpart of the JAX
package's dense XLA tower.  The default, None, turns it on for the frozen
base ResNet tower, that is unless the configuration sets ``lora_rank`` (a
LoRA or fully fine-tuned CLU tower scores through the module, as in JAX);
an explicit ``True`` there, or with the ViT (which has no bottleneck),
raises JAX's ``ValueError`` (srsem/eval/scorer.py:53-63).  The CLIP ViT
runs as its module, in the compute dtype with float32 token taps.  Both
towers run as two passes (a, then b).  After the tower, by model:

* the conv heads (stages_cnn, wperlay_cnn) and the ViT's token heads
  (single_lin_vit, stages_vit, wperlay_vit) go through
  ``fused_global_score``: one launch of the CUDA head kernel a scored
  batch on the card, with the head packed once (``pack_head``);
* the MLP heads (stages_cnn_pooling, emb_lin) run the module's
  ``score_from_taps``, whose small matrix products stay ``torch.matmul``
  (the JAX package leaves them to XLA too);
* a CluUnet (the CLU map model, or head="unet_global") decodes through
  ``fused_serving_decode`` (the decoder kernel on the card) when
  ``fused_decoder`` is on (the default, None, turns it on for a CluUnet),
  else through the module's ``decode_from_diffs``.

One card, no mesh: multi-GPU waits for ROADMAP A9b.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from srsem_torch.backbones.fused_resnet import (
    fold_tower,
    fused_apply,
    resolve_fused_tower,
)
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.models.global_models import KERNEL_HEADS
from srsem_torch.models.local_models import (
    CluUnet,
    fold_decoder,
    fused_serving_decode,
    pixel_sq_error,
    squared_diff_pyramid,
)
from srsem_torch.ops.fused_head import fused_global_score, pack_head


class PairScorer:
    """Batched scorer for (GT, SR) image pairs: one scalar per pair
    (``model_kind="global"``, a GlobalPairScorer) or one (H, W) map
    (``"local"``, a CluUnet; or ``"global"`` with head="unet_global").

    The BN-folded weights of the fused tower and decoder, and a linear
    head's packed weights, are computed once, here, from the model's
    weights at construction: load weights before building it."""

    def __init__(
        self,
        cfg,
        model,
        batch_size: int = 64,
        model_kind: str = "global",
        num_workers: int = 16,
        decode_backend: str = "pil",
        fused_tower: Optional[bool] = None,
        fused_decoder: Optional[bool] = None,
        fast_jpeg: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model_kind not in ("global", "local"):
            raise ValueError(f"model_kind must be 'global' or 'local', got "
                             f"{model_kind!r}")
        if decode_backend not in ("pil", "native"):
            raise ValueError(f"decode_backend must be 'pil' or 'native', got "
                             f"{decode_backend!r}")
        if decode_backend == "native":
            # Fail fast on the config error: decode_uint8_native returns
            # None both for "library not built" and "file undecodable", so
            # without this check a missing library would surface as an
            # all-NaN result set.
            from srsem_torch import native

            if not native.available():
                raise RuntimeError(
                    "decode_backend='native' but the native decoder is "
                    "unavailable — build srsem_torch/native (see `python -m "
                    "srsem_torch info --native`) or use the default PIL "
                    "backend")
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.model_kind = model_kind
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.decode_backend = decode_backend
        self.fused_tower = resolve_fused_tower(
            fused_tower, getattr(cfg, "lora_rank", None) is None,
            cfg.backbone.kind)
        self.is_clu = isinstance(model, CluUnet)
        if model_kind == "local" and not self.is_clu:
            raise ValueError(f"model_kind='local' scores a CluUnet, got "
                             f"{type(model).__name__}")
        if fused_decoder and not self.is_clu:
            raise ValueError(
                "fused_decoder applies to the CLU UNet decoder — use "
                "model_kind='local' (or the head='unet_global' copy)")
        self.fused_decoder = self.is_clu and fused_decoder is not False
        self.dtype = getattr(torch, cfg.backbone.compute_dtype)
        self.preprocess = Preprocess.for_backbone(
            cfg.backbone.kind, cfg.backbone.image_size, fast_jpeg=fast_jpeg)
        # The model is frozen: fold BN into the kernel weights once.
        with torch.no_grad():
            self._tower_folded = (fold_tower(self.model.backbone, self.dtype)
                                  if self.fused_tower else None)
            self._decoder_folded = (fold_decoder(self.model)
                                    if self.fused_decoder else None)
            self.head = (pack_head(self.model.aggregator)
                         if not self.is_clu and cfg.head in KERNEL_HEADS
                         else None)

    # ---- device path ----------------------------------------------------

    def normalize(self, x_u8) -> torch.Tensor:
        """uint8 NHWC host array → normalized float32 on the device."""
        x = torch.as_tensor(np.asarray(x_u8)).to(self.device)
        return self.preprocess.device_normalize(x)

    def tower(self, x: torch.Tensor):
        """``(embedding, taps)`` of normalized NHWC images."""
        if self.fused_tower:
            return fused_apply(self.cfg.backbone.kind, self.model.backbone, x,
                               self.dtype, folded=self._tower_folded)
        return self.model.backbone(x)

    def decode(self, diffs, img_sq=None) -> torch.Tensor:
        """CLU maps from the decoder-dtype diff pyramid (and v2's pixel
        error): the fused serving decode, or the module's decoder."""
        if self.fused_decoder:
            return fused_serving_decode(self.model, diffs, img_sq,
                                        folded=self._decoder_folded)
        return self.model.decode_from_diffs(diffs, img_sq)

    @torch.inference_mode()
    def score_arrays(self, a_u8: np.ndarray, b_u8: np.ndarray) -> torch.Tensor:
        """Score a uint8 NHWC batch pair; returns (N,) float32 scores or
        (N, H, W) maps on the scorer's device."""
        a, b = self.normalize(a_u8), self.normalize(b_u8)
        emb_a, taps_a = self.tower(a)
        emb_b, taps_b = self.tower(b)
        model = self.model
        if self.head is not None:
            return fused_global_score(taps_a, taps_b, self.head,
                                      model.tap_names)
        if not self.is_clu:
            return model.score_from_taps(emb_a, emb_b, taps_a, taps_b)
        diffs = squared_diff_pyramid(taps_a, taps_b, model.tap_names,
                                     model.decoder_dtype)
        return self.decode(diffs, pixel_sq_error(a, b) if model.v2 else None)

    # ---- end-to-end path -------------------------------------------------

    def _decode_one(self, path: str) -> np.ndarray:
        if self.decode_backend == "native":
            # C++ decode (GIL-free inside the thread pool; srsem_torch/native).
            img = self.preprocess.decode_uint8_native(path)
            if img is None:
                raise IOError(f"native decode failed: {path}")
            return img
        return self.preprocess.decode_uint8(path)

    def _decode_pair(self, pair: Tuple[str, str]):
        return self._decode_one(pair[0]), self._decode_one(pair[1])

    def _safe_decode(self, pair):
        try:
            return self._decode_pair(pair)
        except Exception:  # per-item failure contract: the row becomes NaN
            return None

    def score_paths(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Decode + score (path_a, path_b) pairs; one score (or map) per
        pair, NaN (the whole map) where a file failed to decode."""
        bs = self.batch_size
        results: List[np.ndarray] = []
        chunks = [pairs[i: i + bs] for i in range(0, len(pairs), bs)]
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            submit = lambda chunk: [  # noqa: E731
                pool.submit(self._safe_decode, p) for p in chunk]
            pending = submit(chunks[0]) if chunks else None
            for i in range(len(chunks)):
                # Double-buffer: chunk i+1 decodes while chunk i scores.
                nxt = submit(chunks[i + 1]) if i + 1 < len(chunks) else None
                results.append(self._finish_chunk(pending))
                pending = nxt
        out = (np.concatenate(results, axis=0) if results
               else np.zeros((0,), np.float32))
        return out[: len(pairs)]

    def _finish_chunk(self, futures) -> np.ndarray:
        decoded = [f.result() for f in futures]
        n = len(decoded)
        size = self.preprocess.size
        a = np.zeros((self.batch_size, size, size, 3), np.uint8)
        b = np.zeros_like(a)
        ok = np.zeros((self.batch_size,), bool)
        for i, d in enumerate(decoded):
            if d is not None:
                a[i], b[i] = d
                ok[i] = True
        scores = self.score_arrays(a, b).float().cpu().numpy()
        scores = scores[:n]
        scores[~ok[:n]] = np.nan
        return scores
