"""Index readers and sample builders for the training datasets — the port
of srsem/data/datasets.py (``UserStudyScores``, ``KoniqPairsMapsDataset``,
``ImpaintMapsDataset``, ``seeded_split``, ``Subset``).

Samples are numpy, shaped ``((img_a, img_b), label)`` with HWC float32
images normalized on the host (``Preprocess.__call__``), as in the JAX
package; batching and prefetch live in srsem_torch/data/loader.py, and the
training loop moves batches to the card.  The CSVs are read with ``csv``
(the card's machine has no pandas): every cell is a string, and the
numeric columns are parsed where they are used.
"""

from __future__ import annotations

import csv
import os
import pickle
from itertools import combinations
from typing import List, Optional, Sequence, Tuple

import numpy as np

from srsem_torch.data.loader import Loader
from srsem_torch.data.preprocess import Preprocess
from srsem_torch.ops.npimage import resize_bilinear_np


def _read_csv(path: str) -> Tuple[List[str], List[dict]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or []), list(reader)


class UserStudyScores:
    """User-study pair dataset for the global regressor
    (reference: CLIPLPIPS_REG_training_sweep_example.py:16-39): the HQ
    filename is derived from the SR name (``sr.split("_")[-1]``,
    ``.png``→``.jpg``), images live under ``<root>/SR`` and ``<root>/HQ``,
    and the label is the raw ``userStudyScores`` column when the CSV has
    ``img_names``, else the binarized answer (``Answer == "Yes"`` → 1.0,
    column ``Super Resolution Image``;
    reference: datasets/global_eval_torch_ds.py:4-23).
    """

    def __init__(self, csv_path: str, root: str, preprocess: Preprocess):
        columns, self.rows = _read_csv(csv_path)
        self.root = root
        self.preprocess = preprocess
        if "img_names" in columns:
            self._name_col, self._score_col = "img_names", "userStudyScores"
        else:
            self._name_col, self._score_col = "Super Resolution Image", "Answer"

    def __len__(self) -> int:
        return len(self.rows)

    def paths(self, idx: int) -> Tuple[str, str]:
        sr_name = self.rows[idx][self._name_col]
        hq_name = sr_name.split("_")[-1].replace(".png", ".jpg")
        return (os.path.join(self.root, "SR", sr_name),
                os.path.join(self.root, "HQ", hq_name))

    def label(self, idx: int) -> float:
        value = self.rows[idx][self._score_col]
        if self._score_col == "Answer":
            return 1.0 if value == "Yes" else 0.0
        return float(value)

    def __getitem__(self, idx: int):
        sr, hq = self.paths(idx)
        return ((self.preprocess(sr), self.preprocess(hq)),
                np.float32(self.label(idx)))


class KoniqPairsMapsDataset:
    """Cosine-map pair dataset for CLU training (reference:
    datasets/local_eval_torch_ds.py:10-42, ``KoNiqPairsDataset_maps``):
    keep rows with ``ima_ncaps >= imgamincaps`` and, with ``only_hq``, an
    ``img_a_pth`` holding "HQ"; load the pickled cosine map; binarize it at
    ``threshold`` (when set), then bilinearly resize it (align_corners=False)
    to the model input size.  ``thresholds`` emits one label a threshold,
    stacked (T, H, W), each binarized then resized the same way.
    """

    def __init__(self, csv_path: str, preprocess: Preprocess,
                 only_hq: bool = False, imgamincaps: int = 2,
                 threshold: Optional[float] = None,
                 thresholds: Optional[Sequence[Optional[float]]] = None):
        _, rows = _read_csv(csv_path)
        rows = [r for r in rows if float(r["ima_ncaps"]) >= imgamincaps]
        if only_hq:
            rows = [r for r in rows if "HQ" in r["img_a_pth"]]
        self.rows = rows
        self.preprocess = preprocess
        self.threshold = threshold
        self.thresholds = list(thresholds) if thresholds is not None else None

    def __len__(self) -> int:
        return len(self.rows)

    def _prepare_map(self, cosmap: np.ndarray, t: Optional[float],
                     hw) -> np.ndarray:
        if t is not None:
            cosmap = (cosmap > t).astype(np.float32)
        return resize_bilinear_np(cosmap, hw, align_corners=False)

    def __getitem__(self, idx: int):
        row = self.rows[idx]
        img_a = self.preprocess(row["img_a_pth"])
        img_b = self.preprocess(row["img_b_pth"])
        with open(row["out_paths"], "rb") as f:
            cosmap = np.asarray(pickle.load(f), dtype=np.float32)
        hw = (img_a.shape[0], img_a.shape[1])
        if self.thresholds is not None:
            label = np.stack(
                [self._prepare_map(cosmap, t, hw) for t in self.thresholds])
        else:
            label = self._prepare_map(cosmap, self.threshold, hw)
        return ((img_a, img_b), label)


class ImpaintMapsDataset:
    """COCO-inpainting map dataset (reference: datasets/local_eval_torch_ds.py:
    44-108, ``ImpaintDS_maps``): CSV rows ``(gt_image_path, impainted_pth,
    segmentation_map_path)`` plus every pair (``itertools.combinations``)
    of same-image positives under ``positive_pairs/`` beside the CSV; the
    label map is the inverted normalized segmentation mask, by the
    reference's exact recipe — the mask through the image preprocessor,
    channel 0, divided by its max, inverted (a missing mask is a black
    image of the GT's size)."""

    def __init__(self, csv_path: str, preprocess: Preprocess):
        _, rows = _read_csv(csv_path)
        pos_dir = os.path.join(os.path.dirname(csv_path) or ".",
                               "positive_pairs")
        if os.path.isdir(pos_dir):
            groups: dict = {}
            for im in sorted(os.listdir(pos_dir)):
                key = im.split(".")[0].split("_")[0]
                groups.setdefault(key, []).append(os.path.join(pos_dir, im))
            for ims in groups.values():
                rows += [{"gt_image_path": a, "impainted_pth": b}
                         for a, b in combinations(ims, 2)]
        self.rows = rows
        self.preprocess = preprocess

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int):
        from PIL import Image

        row = self.rows[idx]
        img_a = self.preprocess(row["gt_image_path"])
        img_b = self.preprocess(row["impainted_pth"])
        seg = row.get("segmentation_map_path")
        if not seg:
            with Image.open(row["gt_image_path"]) as ref_im:
                mask_img = Image.new("RGB", ref_im.size, color=(0, 0, 0))
            mask = self.preprocess(mask_img)
        else:
            mask = self.preprocess(seg)
        mask = mask[..., 0]
        mask = mask / mask.max()
        cosmap = 1.0 - mask
        return ((img_a, img_b), cosmap.astype(np.float32))


def seeded_split(n: int, val_fraction: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) indices from a numpy permutation with a fixed seed —
    the reference splits with ``torch.random_split`` seeded 42
    (reference: CLIPLPIPS_REG_training_sweep_example.py:144-156); the JAX
    package's numpy permutation is what both packages share."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


class Subset:
    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[self.indices[i]]


def split_loaders(ds, tcfg) -> Tuple[Loader, Loader]:
    """``ds`` split by ``seeded_split`` at ``tcfg``'s validation fraction
    and seed: a shuffled train Loader and a validation Loader, both of
    ``tcfg.batch_size``."""
    tr, va = seeded_split(len(ds), tcfg.val_fraction, tcfg.seed)
    return (Loader(Subset(ds, tr), tcfg.batch_size, shuffle=True,
                   seed=tcfg.seed),
            Loader(Subset(ds, va), tcfg.batch_size))
