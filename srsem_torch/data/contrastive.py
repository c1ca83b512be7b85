"""COCO-inpainting contrastive dataset for the global scorer — the port of
srsem/data/contrastive.py.

Rebuilds ``ImpaintSDD_contrastive_dataset_clip``
(reference: datasets/global_eval_torch_ds.py:35-186):

* join ``instances.csv`` rows (read with ``csv``) against
  ``impainted_proposals/`` (negatives, keyed by row index prefix) and
  ``positive_pairs/`` (positives, keyed by instance id prefix); skip
  instances missing either side (:40-70);
* per item: load the positives and the GT image bilinearly resized to
  match, CLIP-preprocess with shortest_edge=224 and no center crop
  (:94-101);
* a bbox-centered square crop of side ``IM_WIDTH`` (224) with edge-aware
  growth — grow toward whichever side has more room, spill the remainder
  to the other side (:107-165);
* bilinear-resize the crop to exactly 224 and return
  ``(pixel_vals [N,H,W,3], labels [N]∈{0,1}, idx [N])`` (NHWC).

The bbox string parser mirrors :177-186 (floor x0/y0, ceil w/h).
"""

from __future__ import annotations

import csv
import math
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

from srsem_torch.ops.image import CLIP_MEAN, CLIP_STD
from srsem_torch.ops.npimage import resize_bilinear_np


def parse_bbox_string(bboxs: str) -> List[int]:
    parts = bboxs.split(",")
    parts[0] = parts[0][1:]
    parts[-1] = parts[-1][:-1]
    vals = [float(v) for v in parts]
    return [int(math.floor(vals[0])), int(math.floor(vals[1])),
            int(math.ceil(vals[2])), int(math.ceil(vals[3]))]


def grow_box_to_size(
    x0: float, y0: float, x1: float, y1: float,
    target: int, im_w: int, im_h: int,
) -> Tuple[float, float, float, float]:
    """Edge-aware growth of a box to target×target: grow toward the side
    with more room first, spill the remainder the other way
    (reference :120-165)."""
    width_to_grow = target - (x1 - x0)
    height_to_grow = target - (y1 - y0)

    left, right = x0, im_w - x1
    if left <= right:
        g = min(width_to_grow, right)
        x1 += g
        x0 = max(0, x0 - (width_to_grow - g))
    else:
        g = min(width_to_grow, left)
        x0 -= g
        x1 = min(im_w, x1 + (width_to_grow - g))

    top, bottom = y0, im_h - y1
    if top <= bottom:
        g = min(height_to_grow, bottom)
        y1 += g
        y0 = max(0, y0 - (height_to_grow - g))
    else:
        g = min(height_to_grow, top)
        y0 -= g
        y1 = min(im_h, y1 + (height_to_grow - g))
    return x0, y0, x1, y1


class InpaintContrastiveDataset:
    """Samples: (images [N,224,224,3] float32 normalized, labels [N],
    idx [N])."""

    IM_WIDTH = 224

    def __init__(self, root: str, instances_csv: str = None):
        with open(instances_csv or os.path.join(root, "instances.csv"),
                  newline="") as f:
            instances = list(csv.DictReader(f))

        def indexed(folder: str):
            # Skip bookkeeping files without a numeric id prefix
            # (.gitkeep, Thumbs.db, ...).
            names = [n for n in sorted(os.listdir(os.path.join(root, folder)))
                     if n.split("_")[0].isdigit()]
            return (np.array(names),
                    np.array([int(n.split("_")[0]) for n in names], np.int64))

        negatives, neg_idx = indexed("impainted_proposals")
        positives, pos_ids = indexed("positive_pairs")

        self.samples = []
        for j, row in enumerate(instances):
            neg = negatives[neg_idx == j]
            pos = positives[pos_ids == int(row["id"])]
            if len(neg) == 0 or len(pos) == 0:
                continue
            self.samples.append({
                "id": int(row["id"]),
                "bbox": parse_bbox_string(row["bbox"]),
                "negative_paths": [os.path.join(root, "impainted_proposals", n)
                                   for n in neg],
                "positive_paths": [os.path.join(root, "positive_pairs", p)
                                   for p in pos],
                "gt_im_pth": row["gt_image_path"],
            })

    def __len__(self) -> int:
        return len(self.samples)

    @staticmethod
    def _clip_resize_shortest(img: Image.Image, shortest: int = 224) -> np.ndarray:
        """CLIPProcessor shortest_edge resize, bicubic, no crop → normalized
        HWC float32 (reference :94-101 with do_center_crop=False)."""
        w, h = img.size
        if w <= h:
            nw, nh = shortest, max(1, int(round(h * shortest / w)))
        else:
            nw, nh = max(1, int(round(w * shortest / h))), shortest
        arr = np.asarray(img.convert("RGB").resize((nw, nh), Image.BICUBIC),
                         np.float32) / 255.0
        return ((arr - np.asarray(CLIP_MEAN, np.float32))
                / np.asarray(CLIP_STD, np.float32))

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        positive_ims = [Image.open(p) for p in s["positive_paths"]]
        negative_ims = [Image.open(p) for p in s["negative_paths"]]
        gt = Image.open(s["gt_im_pth"]).resize(positive_ims[0].size,
                                               Image.BILINEAR)
        positive_ims.append(gt)
        labels = [1] * len(positive_ims) + [0] * len(negative_ims)

        orig_h = positive_ims[0].size[1]
        imgs = np.stack([self._clip_resize_shortest(im)
                         for im in positive_ims + negative_ims])
        n, im_h, im_w, _ = imgs.shape

        # Scale the bbox to the resized image, then grow it to a square.
        scale = im_h / orig_h
        x0, y0, w, h = [math.ceil(v * scale) for v in s["bbox"]]
        x0, y0, x1, y1 = grow_box_to_size(
            x0, y0, x0 + w, y0 + h, self.IM_WIDTH, im_w, im_h)
        crop = imgs[:, math.floor(y0):math.ceil(y1),
                    math.floor(x0):math.ceil(x1), :]
        crop = resize_bilinear_np(
            crop, (self.IM_WIDTH, self.IM_WIDTH), align_corners=False)
        return (crop.astype(np.float32), np.asarray(labels, np.int32),
                np.full((len(labels),), idx, np.int32))
