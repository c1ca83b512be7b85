"""Grouped GT-vs-K-SR scoring — the port of srsem/eval/grouped.py's
``GroupedPairScorer`` (global scores) and ``GroupedMapScorer`` (CLU maps).

The 10k-pair KonIQ SR benchmark scores each GT against the outputs of K SR
models (reference: README.md:47-53).  Here the group shares the GT's tower
pass: 1 + K passes instead of 2K.

* ``GroupedPairScorer`` scores the (G, K) pairs with one launch of the head
  kernel (``fused_grouped_score``), which reads each GT tap once against
  its K SR taps: the conv heads, stages_cnn on the ResNet towers and
  wperlay_cnn (up to 12 taps) on the CLIP tower.  The ViT heads wait for
  ROADMAP A10.
* ``GroupedMapScorer``'s decoder still runs once per pair on its own diff
  pyramid, built by broadcasting the shared GT taps against the K SR taps
  (``grouped_diff_pyramid``), so the maps equal the pairwise scorer's.

``score_folder_set`` returns a list of row dicts (the card's machine has no
pandas); the CLI writes them with ``csv``.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from srsem_torch.data.preprocess import IMG_EXTENSIONS
from srsem_torch.device import DeviceLike
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import CONV_HEADS, grouped_diff_pyramid
from srsem_torch.ops.fused_head import fused_grouped_score

# The heads srsem/eval/grouped.py scores in grouped form (its GROUPED_HEADS).
GROUPED_HEADS = ("stages_cnn", "wperlay_cnn", "single_lin_vit", "stages_vit",
                 "wperlay_vit")


def _sr_model_names(sr_folders: Sequence[str]) -> List[str]:
    """One display name per SR folder — score-column keys and map-file
    stems.  Plain basenames collide when two runs share a model dir name
    (``/runA/esrgan`` vs ``/runB/esrgan``); collisions grow parent
    segments (``runA__esrgan``) until names are unique."""
    paths = [Path(str(f).rstrip("/")) for f in sr_folders]
    max_depth = max((len(p.parts) for p in paths), default=1)
    for depth in range(1, max_depth + 1):
        names = ["__".join(p.parts[-depth:]) for p in paths]
        if len(set(names)) == len(names):
            return names
    raise ValueError(
        f"SR folders do not resolve to unique names (duplicate paths?): "
        f"{list(map(str, sr_folders))}")


def _match_stems(gt_folder: str, sr_folders: Sequence[str]
                 ) -> Tuple[List[str], List[Dict[str, Path]]]:
    """Stems common to GT and every SR folder + per-folder stem→path maps.
    When a folder holds one stem under several extensions, the
    lexicographically first filename wins."""
    stems = None
    folder_files: List[Dict[str, Path]] = []
    for folder in [gt_folder, *sr_folders]:
        files: Dict[str, Path] = {}
        for f in sorted(Path(folder).iterdir()):
            if f.suffix.lower() in IMG_EXTENSIONS and f.stem not in files:
                files[f.stem] = f
        folder_files.append(files)
        stems = set(files) if stems is None else stems & set(files)
    out = sorted(stems or ())
    if not out:
        raise ValueError("no stems common to GT and all SR folders")
    return out, folder_files


def _decoded_group_chunks(preprocess, stems: Sequence[str],
                          folder_files: Sequence[Dict[str, Path]],
                          k: int, bs: int, pool: cf.ThreadPoolExecutor):
    """Yield ``(chunk_stems, gt (bs,H,W,3), sr (bs,K,H,W,3), ok (bs,))``
    with chunk i+1's decodes submitted before chunk i is yielded, so host
    decode overlaps the caller's device call.  A failed decode clears
    ``ok`` for that group (the NaN-row contract, reference:
    1_compute_image_metrics.py:119-134)."""
    size = preprocess.size

    def decode_one(path) -> Optional[np.ndarray]:
        try:
            return preprocess.decode_uint8(str(path))
        except Exception:  # per-item failure contract: the row becomes NaN
            return None

    def submit(chunk):
        return [pool.submit(lambda grp: [decode_one(p) for p in grp],
                            [ff[s] for ff in folder_files])
                for s in chunk]

    chunks = [stems[i: i + bs] for i in range(0, len(stems), bs)]
    pending = submit(chunks[0]) if chunks else []
    for ci, chunk in enumerate(chunks):
        futures, pending = pending, (
            submit(chunks[ci + 1]) if ci + 1 < len(chunks) else [])
        gt = np.zeros((bs, size, size, 3), np.uint8)
        sr = np.zeros((bs, k, size, size, 3), np.uint8)
        ok = np.zeros((bs,), bool)
        for i, fut in enumerate(futures):
            imgs = fut.result()
            if all(im is not None for im in imgs):
                gt[i] = imgs[0]
                sr[i] = np.stack(imgs[1:])
                ok[i] = True
        yield chunk, gt, sr, ok


def check_grouped_head(head: str) -> None:
    """Raise unless ``head`` has a grouped form in the port."""
    if head not in GROUPED_HEADS:
        raise ValueError(
            f"grouped scoring supports the linear-to-scalar heads "
            f"{GROUPED_HEADS}, got {head!r} — use PairScorer")
    if head not in CONV_HEADS:
        raise NotImplementedError(
            f"grouped head {head!r} needs the ViT tower, which is not "
            "ported yet (ROADMAP A10)")


def _check_shared(pairs: PairScorer, model, kind: str) -> None:
    """A shared core must score ``model`` in the scorer's kind."""
    if pairs.model is not model or pairs.model_kind != kind:
        raise ValueError(f"the shared PairScorer must be a {kind!r} scorer of "
                         "the same model")


class GroupedPairScorer:
    """Batched scorer for (GT, [SR_1..SR_K]) groups:
    ``score_arrays(gt_u8 (G,H,W,3), sr_u8 (G,K,H,W,3)) -> (G,K)`` float32
    on the scorer's device, the scores of the K pairs scored apart (the
    head's sums run in another order).  Two tower passes (G, then G·K
    images) and one head launch a batch; the tower path (``fused_tower``)
    and the packed head are PairScorer's.  ``pairs``, a PairScorer of the
    same model, lets several grouped scorers (a service's (K, G) buckets)
    share one copy of the folded tower and the packed head on the card."""

    def __init__(self, cfg, model, k: int, batch_size: int = 32,
                 num_workers: int = 16, fused_tower: Optional[bool] = None,
                 fast_jpeg: bool = False, device: DeviceLike = None,
                 pairs: Optional[PairScorer] = None):
        check_grouped_head(cfg.head)
        self.k = k
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.pairs = pairs or PairScorer(
            cfg, model, batch_size=batch_size, fused_tower=fused_tower,
            fast_jpeg=fast_jpeg, device=device)
        _check_shared(self.pairs, model, "global")
        self.preprocess = self.pairs.preprocess
        self.device = self.pairs.device

    @torch.inference_mode()
    def score_arrays(self, gt_u8: np.ndarray, sr_u8: np.ndarray) -> torch.Tensor:
        """(G,H,W,3) GT + (G,K,H,W,3) SR uint8 → (G,K) float32 scores on
        the scorer's device.  G and K come from the input's shape."""
        sc = self.pairs
        g, kk = sr_u8.shape[:2]
        gt = sc.normalize(gt_u8)
        sr = sc.normalize(np.asarray(sr_u8).reshape(g * kk, *sr_u8.shape[2:]))
        _, taps_g = sc.tower(gt)
        _, taps_s = sc.tower(sr)
        return fused_grouped_score(taps_g, taps_s, sc.head,
                                   sc.model.tap_names)

    def score_folder_set(self, gt_folder: str,
                         sr_folders: Sequence[str]) -> List[dict]:
        """Match stems across GT + K SR folders; one row dict per stem,
        ``image_name`` and one score column per SR folder (unique names via
        ``_sr_model_names``), NaN where any decode of the group failed.
        Host decode of chunk i+1 overlaps the device call for chunk i."""
        if len(sr_folders) != self.k:
            raise ValueError(
                f"expected {self.k} SR folders, got {len(sr_folders)}")
        stems, folder_files = _match_stems(gt_folder, sr_folders)
        names = _sr_model_names(sr_folders)
        rows = []
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for chunk, gt, sr, ok in _decoded_group_chunks(
                    self.preprocess, stems, folder_files, self.k,
                    self.batch_size, pool):
                scores = self.score_arrays(gt, sr).float().cpu().numpy()
                scores[~ok] = np.nan
                for i, s in enumerate(chunk):
                    rows.append({"image_name": s,
                                 **{n: float(v) for n, v in
                                    zip(names, scores[i])}})
        return rows


class GroupedMapScorer:
    """Grouped CLU map scoring: (GT, [SR_1..K]) → (G, K, H, W) fidelity maps
    with one shared GT tower pass per group.  The tower and decoder paths
    (``fused_tower``, ``fused_decoder``) are PairScorer's; ``pairs`` shares
    one (``model_kind="local"``) as GroupedPairScorer's does."""

    def __init__(self, cfg, model, k: int, batch_size: int = 8,
                 fused_tower: Optional[bool] = None,
                 fused_decoder: bool = True,
                 fast_jpeg: bool = False, device: DeviceLike = None,
                 pairs: Optional[PairScorer] = None):
        self.k = k
        self.batch_size = batch_size
        self.pairs = pairs or PairScorer(
            cfg, model, batch_size=batch_size, model_kind="local",
            fused_tower=fused_tower, fused_decoder=fused_decoder,
            fast_jpeg=fast_jpeg, device=device)
        _check_shared(self.pairs, model, "local")
        self.preprocess = self.pairs.preprocess
        self.device = self.pairs.device

    @torch.inference_mode()
    def score_arrays(self, gt_u8: np.ndarray, sr_u8: np.ndarray) -> torch.Tensor:
        """(G,H,W,3) GT + (G,K,H,W,3) SR uint8 → (G,K,H,W) maps on the
        scorer's device."""
        sc = self.pairs
        g, kk = sr_u8.shape[:2]
        gt = sc.normalize(gt_u8)
        sr = sc.normalize(np.asarray(sr_u8).reshape(g * kk, *sr_u8.shape[2:]))
        _, taps_g = sc.tower(gt)
        _, taps_s = sc.tower(sr)
        model = sc.model
        diffs = grouped_diff_pyramid(taps_g, taps_s, model.tap_names,
                                     model.decoder_dtype)
        img_sq = None
        if model.v2:
            diff = gt[:, None] - sr.reshape(g, kk, *sr.shape[1:])
            img_sq = (diff ** 2).mean(dim=-1, keepdim=True).reshape(
                g * kk, *sr.shape[1:3], 1)
        maps = sc.decode(diffs, img_sq)
        return maps.reshape(g, kk, *maps.shape[1:])

    def score_folder_set(self, gt_folder: str, sr_folders: Sequence[str],
                         maps_dir: Optional[str] = None,
                         num_workers: int = 16) -> List[dict]:
        """Match stems across GT + K SR folders; per (stem, SR model) the
        ``{model}_map_mean`` / ``{model}_map_min`` columns (NaN where any
        decode of the group failed); with ``maps_dir``, each full map saved
        as ``maps_dir/<stem>__<model>.npy``.  Host decode of chunk i+1
        overlaps the device call for chunk i.  One row dict per stem."""
        if len(sr_folders) != self.k:
            raise ValueError(
                f"expected {self.k} SR folders, got {len(sr_folders)}")
        stems, folder_files = _match_stems(gt_folder, sr_folders)
        model_names = _sr_model_names(sr_folders)
        if maps_dir:
            Path(maps_dir).mkdir(parents=True, exist_ok=True)

        rows = []
        with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
            for chunk, gt, sr, ok in _decoded_group_chunks(
                    self.preprocess, stems, folder_files, self.k,
                    self.batch_size, pool):
                maps = self.score_arrays(gt, sr).float().cpu().numpy()
                for i, s in enumerate(chunk):
                    row = {"image_name": s}
                    for m, name in enumerate(model_names):
                        if ok[i]:
                            row[f"{name}_map_mean"] = float(maps[i, m].mean())
                            row[f"{name}_map_min"] = float(maps[i, m].min())
                            if maps_dir:
                                np.save(os.path.join(
                                    maps_dir, f"{s}__{name}.npy"), maps[i, m])
                        else:
                            row[f"{name}_map_mean"] = float("nan")
                            row[f"{name}_map_min"] = float("nan")
                    rows.append(row)
        return rows
