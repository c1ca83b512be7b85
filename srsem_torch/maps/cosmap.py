"""Per-pixel cosine-map assembly — the reference's missing "stage 3".

The reference repo consumes pickled per-pair cosine maps indexed by
``filt_refs.csv`` (columns img_a_pth / img_b_pth / out_paths / ima_ncaps —
reference: CLU_training_sweep_example.py:114-120,
datasets/local_eval_torch_ds.py:10-42) but the script that builds them is
absent (SURVEY.md §2.4, "implied stage 3").  This module implements the
inferred behavior end-to-end:

for a GT/SR pair, take the GT image's post-processed panoptic regions and
the per-region captions of both images (reference's ViP-LLaVA stage writes
one caption per region — caption_generation_vipllava.py:90-127), embed the
captions, and paint each region with the cosine similarity of its two
captions.  ``ima_ncaps`` = number of captioned regions in image A, the
quantity the CLU dataset filters on.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from srsem_torch.maps.panoptic import panoptic_to_masks
from srsem_torch.pseudo.scoring import rowwise_cosine

#: ``filt_refs.csv``'s columns.
_MAP_COLUMNS = ("img_a_pth", "img_b_pth", "out_paths", "ima_ncaps")


def assemble_cosine_map(
    panoptic_map: np.ndarray,
    captions_a: Dict[int, str],
    captions_b: Dict[int, str],
    embedder,
    default: float = 0.0,
) -> Tuple[np.ndarray, int]:
    """Returns (H, W) float32 cosine map and ``ima_ncaps``.

    Regions present in the panoptic map but missing a caption on either
    side keep ``default`` — the NaN-row-style failure contract of the
    reference's batch jobs (SURVEY.md §5 failure detection).
    """
    masks = panoptic_to_masks(panoptic_map)
    region_ids = [i for i in masks if i in captions_a and i in captions_b]
    cosmap = np.full(panoptic_map.shape, default, np.float32)
    if region_ids:
        texts = [captions_a[i] for i in region_ids] + \
                [captions_b[i] for i in region_ids]
        embs = np.asarray(embedder.encode(texts), np.float32)
        n = len(region_ids)
        cos = np.asarray(rowwise_cosine(embs[:n], embs[n:]))
        for rid, c in zip(region_ids, cos):
            cosmap[masks[rid]] = c
    return cosmap, len(captions_a)


def read_region_captions(txt_path: str, region_ids) -> Dict[int, str]:
    """Load per-region captions written one-per-line by the region-caption
    stage (reference: caption_generation_vipllava.py:90-127 writes one
    caption per panoptic mask, in region-id order)."""
    with open(txt_path) as f:
        lines = [l.rstrip("\n") for l in f]
    ids = sorted(int(i) for i in region_ids)
    return {rid: lines[k] for k, rid in enumerate(ids) if k < len(lines)}


def write_cosine_map_dataset(
    records: Sequence[Tuple[str, str, np.ndarray, Dict[int, str], Dict[int, str]]],
    embedder,
    out_dir: str,
    csv_path: str,
) -> None:
    """Build the pickled-map + ``filt_refs.csv`` artifact pair the CLU
    training set reads (reference: datasets/local_eval_torch_ds.py:10-42).

    ``records``: (img_a_pth, img_b_pth, panoptic_of_a, caps_a, caps_b).
    Skips already-written maps so folder jobs are resumable.

    Map filenames carry the parent FOLDER as well as the stem: the KonIQ
    SR layout keeps the same filename in every folder (HQ/123.jpg,
    bsrgan_out/123.png, ...), so bare stems would collide every SR
    variant of one image onto a single .pkl and the skip-existing branch
    would silently alias them all to the first pair's map.  Consumers
    never parse the name — they read ``out_paths`` from the CSV
    (reference: datasets/local_eval_torch_ds.py:10-42).
    """
    os.makedirs(out_dir, exist_ok=True)

    def slug(path: str) -> str:
        stem = os.path.splitext(os.path.basename(path))[0]
        parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
        return f"{parent}_{stem}" if parent else stem

    rows: List[dict] = []
    for img_a, img_b, panoptic, caps_a, caps_b in records:
        out_path = os.path.join(out_dir, f"{slug(img_a)}__{slug(img_b)}.pkl")
        if not os.path.exists(out_path):
            cosmap, ncaps = assemble_cosine_map(
                panoptic, caps_a, caps_b, embedder)
            # Atomic write: skip-existing resume + a non-atomic dump means
            # a kill mid-write (stale-claim hangs / collective SIGABRTs
            # are routine here, CLAUDE.md) would leave a truncated .pkl
            # that every rerun then skips — permanently poisoning the
            # dataset the CSV references.
            tmp = out_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(cosmap, f)
            os.replace(tmp, out_path)
        else:
            ncaps = len(caps_a)
        rows.append({"img_a_pth": img_a, "img_b_pth": img_b,
                     "out_paths": out_path, "ima_ncaps": ncaps})
    # ``csv``, not pandas (the card's machine has none): the same header
    # and rows pandas' ``to_csv(index=False)`` writes.
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(_MAP_COLUMNS))
        writer.writeheader()
        writer.writerows(rows)
