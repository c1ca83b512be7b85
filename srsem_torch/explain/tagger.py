"""Image taggers — the port of srsem/explain/tagger.py: native zero-shot
CLIP tagging + RAM++ adapter.

The reference tags images with an external RAM++ Swin-L checkout to pick
"focus" concepts (reference: additional_approaches/src/ram/model_wrapper.py:
9-31, used by eval_utils/embedding_approaches.py:46-62).  RAM++ is itself a
CLIP-aligned open-vocabulary tagger, so the native equivalent scores the
image embedding against a prompt-templated tag vocabulary through any of
the suite's dual encoders (the port's ClipDualEncoder: the CLIP ResNet-50
on the bottleneck kernels, the CLIP text tower).  Embeddings come to the
host as float32 arrays (``to_numpy``: a card tensor explicitly), where the
ranking runs.  ``RamPlusTagger`` is the adapter for environments with the
actual ``ram`` package + checkpoint (the reference's own setup).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from srsem_torch.explain.embedders import to_numpy

# A compact general-purpose tag vocabulary for SR content (RAM's 4,585-tag
# list is checkpoint-specific; callers pass their own vocabulary for parity).
DEFAULT_TAG_VOCABULARY = (
    "person", "man", "woman", "child", "face", "dog", "cat", "bird",
    "horse", "animal", "tree", "flower", "grass", "plant", "sky", "cloud",
    "mountain", "rock", "water", "sea", "lake", "river", "beach", "snow",
    "building", "house", "bridge", "tower", "street", "road", "car",
    "bicycle", "boat", "train", "airplane", "window", "door", "wall",
    "sign", "light", "food", "fruit", "table", "chair", "book", "bottle",
    "sunset", "night", "city", "field",
)


class ClipTagger:
    """Zero-shot tagger over a dual encoder (``encode_image``/``encode_text``).

    Tag embeddings are computed ONCE (batched, prompt-templated) and cached;
    per image: one image-encoder pass + one (vocab, dim)·(dim,) matvec.
    Returns tags sorted by score, filtered by cosine ``threshold`` and
    capped at ``top_k`` — the same contract as the reference's
    ``ram_wrapper.__call__`` (a list of tag strings).
    """

    def __init__(self, dual_encoder, load_img: Callable,
                 vocabulary: Sequence[str] = DEFAULT_TAG_VOCABULARY,
                 template: str = "a photo of a {}",
                 threshold: float = 0.18,
                 top_k: Optional[int] = 10,
                 batch_size: int = 64):
        self.encoder = dual_encoder
        self.load_img = load_img
        self.vocabulary = list(vocabulary)
        self.threshold = threshold
        self.top_k = top_k
        prompts = [template.format(t) for t in self.vocabulary]
        embs = []
        for start in range(0, len(prompts), batch_size):
            embs.append(to_numpy(dual_encoder.encode_text(
                prompts[start: start + batch_size])))
        e = np.concatenate(embs, axis=0)
        self._tag_embs = e / np.linalg.norm(e, axis=-1, keepdims=True).clip(1e-12)

    def _unit_embedding(self, image) -> np.ndarray:
        if isinstance(image, str):
            image = self.load_img(image)
        emb = to_numpy(self.encoder.encode_image(image)).reshape(-1)
        return emb / max(float(np.linalg.norm(emb)), 1e-12)

    def __call__(self, image) -> List[str]:
        """image: path or pixel array accepted by ``load_img``/encoder."""
        scores = self._tag_embs @ self._unit_embedding(image)
        order = np.argsort(-scores)
        tags = [self.vocabulary[i] for i in order if scores[i] >= self.threshold]
        return tags[: self.top_k] if self.top_k else tags

    def scores(self, image) -> np.ndarray:
        return self._tag_embs @ self._unit_embedding(image)


class RamPlusTagger:
    """Adapter for the actual RAM++ model (``ram`` pip package + Swin-L
    checkpoint) — the reference's backend (ram/model_wrapper.py:9-31).
    Lazy import; unavailable environments use :class:`ClipTagger`."""

    def __init__(self, checkpoint_path: str, image_size: int = 384,
                 device: str = "cpu"):
        from ram import get_transform  # type: ignore
        from ram.models import ram_plus  # type: ignore
        import torch

        self._torch = torch
        self.transform = get_transform(image_size=image_size)
        self.model = ram_plus(pretrained=checkpoint_path,
                              image_size=image_size, vit="swin_l")
        self.model.eval().to(device)
        self.device = device

    def __call__(self, image) -> List[str]:
        from PIL import Image
        from ram import inference_ram  # type: ignore

        if isinstance(image, str):
            image = Image.open(image).convert("RGB")
        x = self.transform(image).unsqueeze(0).to(self.device)
        with self._torch.no_grad():
            tags, _ = inference_ram(x, self.model)
        return [t.strip() for t in tags.split("|")]
