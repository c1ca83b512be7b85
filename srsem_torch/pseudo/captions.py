"""Caption file format + pair enumeration for C2C scoring.

I/O contract kept byte-compatible with the reference so its artifacts are
interchangeable:

* caption files are ``Image: <name>.<ext>\\nCaption: <text>`` records joined
  by ``\\n\\nNEXT_CAPTION\\n\\n`` (written by the Qwen captioner —
  reference: datasets/SRdatasetPseudolabelGen/1_qwen_koniq_captions_run.py:
  95-117 — and parsed by
  datasets/SRdatasetPseudolabelGen/qwen_caps_embedding_script.py:14-41);
* pair enumeration: every (HQ, SR) pair across all SR folders, plus all
  SR×SR combinations that share an HQ image
  (reference: qwen_caps_embedding_script.py:94-111).
"""

from __future__ import annotations

import os
from itertools import combinations
from typing import Dict, Iterable, List, Sequence, Tuple

SEPARATOR = "\n\nNEXT_CAPTION\n\n"

# The reference's 16 KonIQ-10k SR folders: HQ + 5 SR models × 3 degradation
# factors (reference: qwen_caps_embedding_script.py:59-76).
SR_MODELS = ("bsrgan", "swinir", "seesr", "pasd", "stablesr")
DEG_FACTORS = ("0.7", "0.3", None)


def default_folders(root: str = "koniq-10k_sr") -> List[str]:
    folders = [os.path.join(root, "HQ")]
    for deg in DEG_FACTORS:
        for m in SR_MODELS:
            name = (f"LQ_x4_degfac_{deg}_{m}_out" if deg else f"LQ_x4_{m}_out")
            folders.append(os.path.join(root, name))
    return folders


def parse_caption_file(path: str) -> Dict[str, str]:
    """caption txt → {image_stem: caption}.  The stem is the image name up
    to the first dot (reference: qwen_caps_embedding_script.py:38).

    Splitting on every ``"Image: "`` occurrence mirrors the reference's
    ``load_captions`` (:26-29) verbatim — a caption whose TEXT contains
    the marker is truncated there too; kept for byte-identical parsing of
    reference-produced caption files (chunks without ``\\nCaption:`` are
    skipped here where the reference would IndexError)."""
    with open(path) as f:
        raw = f.read()
    out: Dict[str, str] = {}
    for record in raw.split(SEPARATOR):
        for chunk in record.split("Image: "):
            if chunk in ("", "\n") or "\nCaption:" not in chunk:
                continue
            name, caption = chunk.split("\nCaption:", 1)
            out[name.split(".")[0]] = caption
    return out


def write_caption_file(path: str, captions: Dict[str, str],
                       append: bool = True) -> None:
    """Write records in the reference format.  ``append`` mirrors the
    reference's resumable append-mode (reference:
    1_qwen_koniq_captions_run.py:124) — idempotent folder jobs re-run from
    where they stopped."""
    existing = append and os.path.exists(path) and os.path.getsize(path) > 0
    with open(path, "a" if append else "w") as f:
        need_sep = existing
        for name, caption in captions.items():
            if need_sep:
                f.write(SEPARATOR)
            f.write(f"Image: {name}\nCaption:{caption}")
            need_sep = True


def merge_caption_dicts(dicts: Sequence[Dict[str, str]],
                        folders: Sequence[str],
                        exts=(".jpg", ".png")) -> Dict[str, str]:
    """Key each caption by the image's full path (reference:
    qwen_caps_embedding_script.py:43-57).

    The reference infers ONE extension per folder from its first listed
    image, so in a mixed-extension folder every other extension gets a
    wrong key and the scoring lookup KeyErrors.  Here a stem resolves to
    its ACTUAL listed filename when present (matching what
    :func:`enumerate_pairs` emits), with the reference's folder-wide
    inference as the fallback — identical keys in uniform folders."""
    merged: Dict[str, str] = {}
    for d, folder in zip(dicts, folders):
        by_stem: Dict[str, str] = {}
        ext = None
        if os.path.isdir(folder):
            for e in sorted(os.listdir(folder)):
                if e.endswith(exts):
                    by_stem.setdefault(e.split(".")[0], e)
                    if ext is None:
                        ext = "." + e.rsplit(".", 1)[1]
        ext = ext or ".jpg"
        for stem, cap in d.items():
            merged[os.path.join(folder, by_stem.get(stem, stem + ext))] = cap
    return merged


def enumerate_pairs(
    folders: Sequence[str], listings: Dict[str, Sequence[str]],
    hq_folder: str = None,
) -> List[Tuple[str, str]]:
    """All (HQ, SR) pairs + SR×SR combinations per HQ image.

    ``listings`` maps folder → image filenames (injected so tests and
    offline runs need no real folder tree).  The reference also pairs
    HQ with itself via its own listing (reference:
    qwen_caps_embedding_script.py:97-105) — kept.  Because the HQ path
    sits inside its own ``hq_of`` group, the SR×SR combinations re-emit
    every (HQ, SR) pair a second time — the reference's combinations
    over the ``sr`` column (:105-110) do exactly the same, so the output
    CSV matches row-for-row; dedup would silently change the scored set.

    The HQ path uses the HQ folder's OWN listing for the extension
    (merge_caption_dicts keys captions by the actual filename, so a
    hardcoded ``<stem>.jpg`` would KeyError on .png HQ folders); stems
    missing from the HQ listing fall back to ``.jpg``, the reference's
    KonIQ convention (qwen_caps_embedding_script.py:99).
    """
    hq_folder = hq_folder or folders[0]
    hq_names = {im.split(".")[0]: im
                for im in listings.get(hq_folder, [])
                if im.endswith((".jpg", ".png"))}
    hq_of: Dict[str, List[str]] = {}
    pairs: List[Tuple[str, str]] = []
    for folder in folders:
        for im in listings.get(folder, []):
            if not im.endswith((".jpg", ".png")):
                continue
            stem = im.split(".")[0]
            hq = os.path.join(hq_folder, hq_names.get(stem, stem + ".jpg"))
            sr = os.path.join(folder, im)
            pairs.append((hq, sr))
            hq_of.setdefault(hq, []).append(sr)
    for hq in hq_of:
        pairs.extend(combinations(hq_of[hq], 2))
    return pairs
