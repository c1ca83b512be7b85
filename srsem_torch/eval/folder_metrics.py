"""SR-output filtering metrics over image folders — the port of
srsem/eval/folder_metrics.py.

GT and eval files match by stem; each pair gets SSIM, PSNR and LPIPS, and
with a no-reference backend the five KonIQ++ columns; ``metrics.csv`` is
written per folder with NaN cells for failures.  The host side is the JAX
package's: PIL decode and bicubic resize, ``/255``, decode threads, in
bounded windows (``decode_chunk``, default ``max(4*batch, 64)`` pairs).
Full-reference metrics bucket by pair shape; a GT/eval shape mismatch
leaves only the FR columns NaN.  A batched NR backend (``koniqpp.batch``)
buckets by eval shape over every decodable row and rides the decoded eval
batch, ImageNet-normalized on the card.  ``image_size=None`` scores at
native resolution.

Rows are dicts, and ``metrics.csv`` is written and read with ``csv`` (the
card's machine has no pandas); the columns and their order are the JAX
package's.  The resume check compares the CSV's ``image_name`` column, as
strings, with the sorted stems: a CSV the JAX package wrote resumes here.
pandas reads a stem such as ``0001`` as the integer 1, so the JAX package
recomputes such a folder where the port resumes it.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import math
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from srsem_torch.data.preprocess import IMG_EXTENSIONS
from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.explain.iqa import psnr as psnr_fn
from srsem_torch.explain.iqa import ssim as ssim_fn

KONIQPP_COLUMNS = ("Koniq++IQA", "Koniq++blur", "Koniq++artifacts",
                   "Koniq++contrast", "Koniq++color")
METRIC_COLUMNS = ("SSIM", "PSNR", "LPIPS") + KONIQPP_COLUMNS
CSV_COLUMNS = ("image_name", "gt_path", "eval_path") + METRIC_COLUMNS


class ImageQualityMetrics:
    """Batched pair-metric evaluator.

    ``koniqpp``: an optional no-reference backend, a callable path → dict
    of the five KonIQ++ scores or an object with ``batch`` (normalized
    NHWC → (N, 5), :class:`srsem_torch.eval.nr_iqa.NrIqaScorer`);
    ``lpips_fn``: an optional ``(gt, ev) -> (N,)`` distance on NHWC [0,1]
    tensors, by default the real LPIPS (srsem_torch/eval/lpips.py) with
    ``lpips_params`` (a JAX tree, ``convert_lpips``) when given.
    """

    def __init__(self, image_size: Optional[int] = 224, batch_size: int = 32,
                 koniqpp: Optional[Callable] = None,
                 lpips_fn: Optional[Callable] = None,
                 lpips_params: Optional[dict] = None,
                 lpips_net: str = "alex",
                 device: DeviceLike = None):
        self.image_size = image_size
        self.batch_size = batch_size
        self.koniqpp = koniqpp
        self.device = resolve_device(device)
        if lpips_fn is None:
            from srsem_torch.eval.lpips import make_lpips

            lpips_fn = make_lpips(net=lpips_net, params=lpips_params,
                                  device=self.device)
        self.lpips_fn = lpips_fn

    def _load(self, path: str) -> np.ndarray:
        img = Image.open(path).convert("RGB")
        if self.image_size is not None:
            img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(img, np.float32) / 255.0

    def _stack(self, arrays: List[np.ndarray]) -> torch.Tensor:
        return torch.from_numpy(np.stack(arrays)).to(self.device)

    @torch.no_grad()
    def batch(self, gt_paths: Sequence[str], eval_paths: Sequence[str],
              workers: int = 8,
              decode_chunk: Optional[int] = None) -> List[Dict[str, float]]:
        """Metrics for matched path lists; failed rows carry NaNs."""
        from srsem_torch.train.nr_iqa import normalize_imagenet

        def safe_load(pair):
            try:
                return self._load(pair[0]), self._load(pair[1])
            except Exception:
                return None

        n = len(gt_paths)
        window = decode_chunk or max(4 * self.batch_size, 64)
        rows = [{c: math.nan for c in METRIC_COLUMNS} for _ in range(n)]
        batched_nr = getattr(self.koniqpp, "batch", None)
        per_path_nr_idx: List[int] = []

        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            for start in range(0, n, window):
                span = range(start, min(start + window, n))
                decoded = list(pool.map(
                    safe_load, ((gt_paths[i], eval_paths[i]) for i in span)))
                ok = [(i, d) for i, d in zip(span, decoded) if d is not None]
                per_path_nr_idx.extend(i for i, _ in ok)
                fr_buckets: Dict[tuple, List[int]] = {}
                nr_buckets: Dict[tuple, List[int]] = {}
                local = dict(ok)
                for i, (g, e) in ok:
                    if g.shape == e.shape:
                        fr_buckets.setdefault(g.shape, []).append(i)
                    nr_buckets.setdefault(e.shape, []).append(i)

                for idxs in fr_buckets.values():
                    for s in range(0, len(idxs), self.batch_size):
                        chunk = idxs[s: s + self.batch_size]
                        gt = self._stack([local[i][0] for i in chunk])
                        ev = self._stack([local[i][1] for i in chunk])
                        vals = torch.stack([ssim_fn(gt, ev), psnr_fn(gt, ev),
                                            self.lpips_fn(gt, ev).float()],
                                           dim=1).cpu().tolist()
                        for j, i in enumerate(chunk):
                            rows[i].update(zip(("SSIM", "PSNR", "LPIPS"),
                                               vals[j]))
                if batched_nr is not None:
                    for idxs in nr_buckets.values():
                        for s in range(0, len(idxs), self.batch_size):
                            chunk = idxs[s: s + self.batch_size]
                            ev = self._stack([local[i][1] for i in chunk])
                            nr = torch.as_tensor(batched_nr(
                                normalize_imagenet(ev))).cpu().tolist()
                            for j, i in enumerate(chunk):
                                rows[i].update(zip(KONIQPP_COLUMNS, nr[j]))
        if self.koniqpp is not None and batched_nr is None:
            for i in per_path_nr_idx:
                try:
                    rows[i].update(self.koniqpp(eval_paths[i]))
                except Exception:
                    pass
        return rows

    def __call__(self, gt_path: str, eval_path: str) -> Dict[str, float]:
        return self.batch([gt_path], [eval_path])[0]


def make_pyramid_lpips(tower: Optional[torch.nn.Module] = None,
                       device: DeviceLike = None):
    """LPIPS-style distance over a frozen ImageNet ResNet-50 pyramid: both
    images as one 2N tower pass through the fused tower (folded once),
    each tapped stage unit-normalized over channels (the norm clamped at
    1e-9), the mean squared difference per stage, the mean over stages.
    ``tower``: an ``ImageNetResNet50`` (its ``dtype`` the compute dtype),
    such as the JAX package's weights through ``load_backbone_params``;
    by default bf16 weights drawn from a ``torch.Generator`` seeded with 0
    (the JAX package draws its own from ``PRNGKey(0)``)."""
    from srsem_torch.backbones.fused_resnet import (
        fold_tower,
        fused_imagenet_apply,
    )
    from srsem_torch.backbones.resnet import (
        IMAGENET_STAGE_TAPS,
        ImageNetResNet50,
        reset_tower,
    )
    from srsem_torch.train.nr_iqa import normalize_imagenet

    dev = resolve_device(device)
    model = tower
    if model is None:
        model = ImageNetResNet50(dtype=torch.bfloat16)
        reset_tower(model, torch.Generator().manual_seed(0))
    model = model.eval().to(dev)
    folded = fold_tower(model, model.dtype)

    @torch.no_grad()
    def lpips(gt, ev) -> torch.Tensor:
        gt, ev = (torch.as_tensor(t, device=dev) for t in (gt, ev))
        n = gt.shape[0]
        x = normalize_imagenet(torch.cat([gt, ev], dim=0).float())
        _, taps = fused_imagenet_apply(model, x, model.dtype, folded=folded)
        total = 0.0
        for name in IMAGENET_STAGE_TAPS:
            f = taps[name].float()
            f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-9)
            total = total + ((f[:n] - f[n:]) ** 2).mean(dim=(1, 2, 3))
        return total / len(IMAGENET_STAGE_TAPS)

    lpips.model = model
    return lpips


def _cell(value) -> str:
    """A metric cell as pandas' ``to_csv`` writes it (NaN empty)."""
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def read_metrics_csv(path: str) -> List[Dict[str, object]]:
    """A ``metrics.csv`` as row dicts: names and paths as strings, metric
    cells as floats (an empty cell NaN)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for c in METRIC_COLUMNS:
            if c in row:
                row[c] = float(row[c]) if row[c] != "" else math.nan
    return rows


def _stems(folder: str) -> Dict[str, Path]:
    return {f.stem: f for f in Path(folder).iterdir()
            if f.is_file() and f.suffix.lower() in IMG_EXTENSIONS}


def process_image_folders(metrics_calc: ImageQualityMetrics, gt_folder: str,
                          eval_folder: str, output_csv: str
                          ) -> List[Dict[str, object]]:
    """Match by stem, score, write ``output_csv``; returns the rows.  A
    CSV whose ``image_name`` column equals the sorted common stems (order
    included) is returned untouched."""
    gt_files, eval_files = _stems(gt_folder), _stems(eval_folder)
    common = sorted(set(gt_files) & set(eval_files))
    if not common:
        raise ValueError("No matching image pairs found between the two folders")

    if os.path.exists(output_csv):
        existing = read_metrics_csv(output_csv)
        if existing and "image_name" in existing[0] and \
                [r["image_name"] for r in existing] == common:
            return existing

    gt_paths = [str(gt_files[n]) for n in common]
    eval_paths = [str(eval_files[n]) for n in common]
    rows = [{"image_name": n, "gt_path": g, "eval_path": e, **r}
            for n, g, e, r in zip(common, gt_paths, eval_paths,
                                  metrics_calc.batch(gt_paths, eval_paths))]
    with open(output_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        for r in rows:
            writer.writerow([r[c] if c in ("image_name", "gt_path",
                                           "eval_path") else _cell(r[c])
                             for c in CSV_COLUMNS])
    return rows


def run_folder_sweep(gt_folder: str, eval_folders: Sequence[str],
                     metrics_calc: Optional[ImageQualityMetrics] = None,
                     csv_name: str = "metrics.csv"
                     ) -> Dict[str, List[Dict[str, object]]]:
    """Each SR-model output folder against ``gt_folder``, one after the
    other through the same evaluator; ``{folder: rows}``."""
    metrics_calc = metrics_calc or ImageQualityMetrics()
    return {folder: process_image_folders(
        metrics_calc, gt_folder, folder, os.path.join(folder, csv_name))
        for folder in eval_folders}
