"""Batched C2C/C2I cosine scoring — the port of srsem/pseudo/scoring.py.

Each unique caption is embedded once, in one batched sweep, and every pair
then gathers its two rows: O(unique captions) encoder passes instead of
two a pair.  The cosines run on the embedder's device (the card for the
MiniLM embedder unless it was built on the CPU; the host for the hashing
embedder, which has none).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _rows(a, device=None) -> Tensor:
    """``a`` as a float32 tensor, on ``device`` when given."""
    if not isinstance(a, Tensor):
        a = torch.from_numpy(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def cosine_similarity_matrix(a, b) -> Tensor:
    """Pairwise cosine matrix between rows of a (n, d) and b (m, d)."""
    a = _rows(a)
    b = _rows(b, a.device)
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    return a @ b.T


def rowwise_cosine(a, b) -> Tensor:
    """Cosine of matching rows of two (n, d) arrays or tensors."""
    a = _rows(a)
    b = _rows(b, a.device)
    num = (a * b).sum(dim=-1)
    return num / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-9)


def _device(embedder) -> torch.device:
    return getattr(embedder, "device", torch.device("cpu"))


def score_caption_pairs(captions: Dict[str, str],
                        pairs: Sequence[Tuple[str, str]], embedder
                        ) -> np.ndarray:
    """cosine(emb(caption[a]), emb(caption[b])) for each (a, b) pair, each
    unique caption embedded exactly once."""
    keys: List[str] = []
    index: Dict[str, int] = {}
    for a, b in pairs:
        for k in (a, b):
            if k not in index:
                index[k] = len(keys)
                keys.append(k)
    dev = _device(embedder)
    embs = _rows(embedder.encode([captions[k] for k in keys]), dev)
    ia = torch.tensor([index[a] for a, _ in pairs], device=dev)
    ib = torch.tensor([index[b] for _, b in pairs], device=dev)
    return rowwise_cosine(embs[ia], embs[ib]).cpu().numpy()


def score_image_caption_pairs(image_embs, caption_embs) -> np.ndarray:
    """C2I scoring: the cosine of matching rows of image and caption
    embeddings (both in CLIP's joint space)."""
    return rowwise_cosine(image_embs, caption_embs).cpu().numpy()


def _safe_decode_norm(preprocess, path):
    try:
        return preprocess(path)
    except Exception:
        return None


def embed_image_folder(dual_encoder, folder: str, preprocess,
                       batch_size: int = 64, exts=(".jpg", ".png"),
                       num_workers: int = 8) -> Dict[str, np.ndarray]:
    """Every image of ``folder`` through the dual encoder's image tower →
    {stem: embedding}.  The device runs full static batches (the last one
    zero-padded); decode runs on host threads; a failed decode gives a NaN
    row."""
    names = [n for n in sorted(os.listdir(folder)) if n.endswith(exts)]
    paths = [os.path.join(folder, n) for n in names]
    size = preprocess.size
    out: Dict[str, np.ndarray] = {}
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(paths), batch_size):
            chunk = paths[start: start + batch_size]
            decoded = list(pool.map(
                lambda p: _safe_decode_norm(preprocess, p), chunk))
            batch = np.zeros((batch_size, size, size, 3), np.float32)
            ok = np.zeros((batch_size,), bool)
            for i, d in enumerate(decoded):
                if d is not None:
                    batch[i] = d
                    ok[i] = True
            embs = dual_encoder.encode_image(batch).float().cpu().numpy()
            for i, name in enumerate(chunk):
                stem = os.path.splitext(os.path.basename(name))[0]
                out[stem] = embs[i] if ok[i] else np.full(
                    embs.shape[-1], np.nan, np.float32)
    return out


def score_c2i(captions: Dict[str, str], image_embs: Dict[str, np.ndarray],
              text_embedder) -> Dict[str, float]:
    """Caption-to-image cosine per stem: the captions embedded once, each
    against its image's embedding.  Stems missing on either side are
    skipped."""
    stems = [s for s in captions if s in image_embs]
    if not stems:
        return {}
    dev = _device(text_embedder)
    text = _rows(text_embedder.encode([captions[s] for s in stems]), dev)
    img = _rows(np.stack([image_embs[s] for s in stems]), dev)
    return dict(zip(stems, rowwise_cosine(img, text).cpu().tolist()))
