"""Full SR-outputs dataset sweep: global scores + CLU maps in one pass — the
port of srsem/eval/dataset_sweep.py (the JAX package's BASELINE config #5).

Scoring the GT/SR pair set with both the global regressor and the CLU map
model would otherwise be two jobs, each with two frozen-tower passes a
pair.  Here the frozen tower runs ONCE per image a batch and its taps feed
both models:

* the global head through ``fused_global_score`` (one head-kernel launch
  a batch; the grouped form ``fused_grouped_score``);
* the decoder-dtype squared-diff pyramid (stem tap and four stage taps)
  through ``fused_serving_decode`` (the decoder kernel on the card; the
  grouped form builds it with ``grouped_diff_pyramid``).

The global model's tower is the shared one (folded once, as PairScorer
folds it); of the CLU model only the decoder is used, and only it moves to
the card.  Folder convention as the reference's KonIQ SR layout
(reference: qwen_caps_embedding_script.py:59-76): a GT folder and an SR
folder with matching stems.  ``score_folders`` returns a list of row dicts
(the card's machine has no pandas).

Over a mesh (``mesh=None``: ``create_mesh()``) the batch rounds up to a
multiple of the data axis, each rank scores its slice of the pairs (or
of the groups, padded with zero rows) and both results are gathered on
every rank and trimmed.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from srsem_torch.core.meshes import Mesh, replicate, sharded_call
from srsem_torch.device import DeviceLike
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import CONV_HEADS, grouped_diff_pyramid
from srsem_torch.models.local_models import (
    fold_decoder,
    fused_serving_decode,
    pixel_sq_error,
    squared_diff_pyramid,
)
from srsem_torch.ops.fused_head import fused_global_score, fused_grouped_score

Tensor = torch.Tensor


class DualScorer:
    """Shared-tower global + CLU scoring.

    Both models must use the same backbone kind and size, so one tower pass
    serves both (the flagship pairing: resnet50_clip).  ``global_model``
    carries the tower and a conv head (stages_cnn, wperlay_cnn);
    ``local_model`` is a CluUnet whose decoder reads the same taps.
    ``fused_tower`` and ``fused_decoder`` run the Hopper kernels (the
    default, as in the port's other scorers)."""

    def __init__(self, global_cfg, local_cfg, global_model, local_model,
                 batch_size: int = 32, num_workers: int = 16,
                 decode_backend: str = "pil",
                 fused_tower: Optional[bool] = None,
                 fused_decoder: bool = True, fast_jpeg: bool = False,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        gb, lb = global_cfg.backbone, local_cfg.backbone
        if (gb.kind, gb.image_size) != (lb.kind, lb.image_size):
            raise ValueError(
                f"global/local backbones must match to share taps: "
                f"{gb.kind}@{gb.image_size} vs {lb.kind}@{lb.image_size}")
        if global_cfg.head not in CONV_HEADS:
            raise ValueError(f"DualScorer scores the conv heads {CONV_HEADS}, "
                             f"got {global_cfg.head!r}")
        self.num_workers = num_workers
        self.decode_backend = decode_backend
        # The shared core: folded tower, packed head, preprocess, decode.
        self.pairs = PairScorer(global_cfg, global_model,
                                batch_size=batch_size,
                                num_workers=num_workers,
                                decode_backend=decode_backend,
                                fused_tower=fused_tower, fast_jpeg=fast_jpeg,
                                device=device, mesh=mesh)
        self.mesh = self.pairs.mesh
        self.batch_size = self.pairs.batch_size
        self.device = self.pairs.device
        self.preprocess = self.pairs.preprocess
        self.local = local_model.eval()
        replicate(self.mesh, self.local.decoder.to(self.device))
        self.fused_decoder = fused_decoder
        with torch.no_grad():
            self._decoder_folded = (fold_decoder(self.local)
                                    if fused_decoder else None)

    # ---- device path ----------------------------------------------------

    def _decode_maps(self, diffs, img_sq) -> Tensor:
        if self.fused_decoder:
            return fused_serving_decode(self.local, diffs, img_sq,
                                        folded=self._decoder_folded)
        return self.local.decode_from_diffs(diffs, img_sq)

    @torch.inference_mode()
    def score_both(self, a_u8: np.ndarray, b_u8: np.ndarray
                   ) -> Tuple[Tensor, Tensor]:
        """uint8 NHWC batch pair → ((N,) float32 scores, (N, H, W) maps) on
        the device, from one tower pass of each image."""
        return sharded_call(self.mesh, self._score_both, a_u8, b_u8)

    def _score_both(self, a_u8: np.ndarray, b_u8: np.ndarray
                    ) -> Tuple[Tensor, Tensor]:
        sc, lm = self.pairs, self.local
        a, b = sc.normalize(a_u8), sc.normalize(b_u8)
        _, taps_a = sc.tower(a)
        _, taps_b = sc.tower(b)
        scores = fused_global_score(taps_a, taps_b, sc.head,
                                    sc.model.tap_names)
        diffs = squared_diff_pyramid(taps_a, taps_b, lm.tap_names,
                                     lm.decoder_dtype)
        maps = self._decode_maps(diffs, pixel_sq_error(a, b) if lm.v2
                                 else None)
        return scores, maps

    @torch.inference_mode()
    def score_group_arrays(self, gt_u8: np.ndarray, sr_u8: np.ndarray
                           ) -> Tuple[Tensor, Tensor]:
        """(G,H,W,3) GT + (G,K,H,W,3) SR uint8 → ((G,K) scores, (G,K,H,W)
        maps) on the device, with one shared GT tower pass per group."""
        return sharded_call(self.mesh, self._score_groups, gt_u8, sr_u8)

    def _score_groups(self, gt_u8: np.ndarray, sr_u8: np.ndarray
                      ) -> Tuple[Tensor, Tensor]:
        sc, lm = self.pairs, self.local
        g, k = sr_u8.shape[:2]
        gt = sc.normalize(gt_u8)
        sr = sc.normalize(np.asarray(sr_u8).reshape(g * k, *sr_u8.shape[2:]))
        _, taps_g = sc.tower(gt)
        _, taps_s = sc.tower(sr)
        scores = fused_grouped_score(taps_g, taps_s, sc.head,
                                     sc.model.tap_names)
        diffs = grouped_diff_pyramid(taps_g, taps_s, lm.tap_names,
                                     lm.decoder_dtype)
        img_sq = None
        if lm.v2:
            diff = gt[:, None] - sr.reshape(g, k, *sr.shape[1:])
            img_sq = (diff ** 2).mean(dim=-1, keepdim=True).reshape(
                g * k, *sr.shape[1:3], 1)
        maps = self._decode_maps(diffs, img_sq)
        return scores, maps.reshape(g, k, *maps.shape[1:])

    # ---- end-to-end path -------------------------------------------------

    def score_folders(self, gt_folder: str, sr_folder: str,
                      exts=(".jpg", ".png")) -> List[dict]:
        """Match stems, score every pair → one row dict a stem, ``image``,
        ``score``, ``map_mean``, ``map_min``, NaN where a decode failed.
        Host decode runs in a ``num_workers`` thread pool through
        ``decode_backend``, and chunk i+1 decodes while chunk i runs on the
        device."""
        gt = {os.path.splitext(f)[0]: os.path.join(gt_folder, f)
              for f in sorted(os.listdir(gt_folder)) if f.endswith(exts)}
        sr = {os.path.splitext(f)[0]: os.path.join(sr_folder, f)
              for f in sorted(os.listdir(sr_folder)) if f.endswith(exts)}
        names = sorted(set(gt) & set(sr))
        bs = self.batch_size
        size = self.preprocess.size
        decode = self.pairs._decode_one

        def safe_pair(name) -> Optional[tuple]:
            try:
                return decode(gt[name]), decode(sr[name])
            except Exception:  # per-item failure contract: the row is NaN
                return None

        rows: List[dict] = []
        chunks = [names[i: i + bs] for i in range(0, len(names), bs)]
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            submit = lambda chunk: [  # noqa: E731
                pool.submit(safe_pair, n) for n in chunk]
            pending = submit(chunks[0]) if chunks else None
            for ci, chunk in enumerate(chunks):
                futures, pending = pending, (
                    submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None)
                a = np.zeros((bs, size, size, 3), np.uint8)
                b = np.zeros_like(a)
                ok = np.zeros((bs,), bool)
                for i, fut in enumerate(futures):
                    d = fut.result()
                    if d is not None:
                        a[i], b[i] = d
                        ok[i] = True
                scores, maps = self.score_both(a, b)
                scores = scores.float().cpu().numpy()
                maps = maps.float().cpu().numpy()
                for i, name in enumerate(chunk):
                    nan = float("nan")
                    rows.append({
                        "image": name,
                        "score": float(scores[i]) if ok[i] else nan,
                        "map_mean": float(maps[i].mean()) if ok[i] else nan,
                        "map_min": float(maps[i].min()) if ok[i] else nan,
                    })
        return rows
