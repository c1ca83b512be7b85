"""VLM adapter contracts for the pseudo-label pipelines.

The reference drives three 7B-class vision models host-side: Qwen2-VL
whole-image captioning (reference: datasets/SRdatasetPseudolabelGen/
1_qwen_koniq_captions_run.py), ViP-LLaVA region captioning
(caption_generation_vipllava.py) and OneFormer panoptic segmentation
(oneformer_panoptic.py).  Per SURVEY.md §7 step 7 these stay *pipeline
stages with pluggable backends*: this module fixes the I/O contracts (the
prompts, the caption file format, the magenta-contour region marking, the
pickle layout) and the post-VLM math lives natively elsewhere
(srsem_torch.pseudo.captions, srsem_torch.maps).  A transformers-backed
implementation is provided behind a lazy import for environments with
local weights.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Iterable, List, Optional, Protocol, Sequence

import numpy as np

from srsem_torch.maps.panoptic import panoptic_to_masks, postprocess_panoptic
from srsem_torch.pseudo.captions import write_caption_file

# The reference prompts, verbatim.
WHOLE_IMAGE_PROMPT = "Describe this image."  # 1_qwen_koniq_captions_run.py:36
REGION_PROMPT = ("Please describe the object outlined in magenta.")
# caption_generation_vipllava.py:53; temp 0.2, max_new_tokens 512 (:62)
REGION_TEMPERATURE = 0.2
REGION_MAX_NEW_TOKENS = 512

MAGENTA = (255, 0, 255)


class Captioner(Protocol):
    def caption(self, images: Sequence, prompt: str) -> List[str]: ...


class PanopticSegmenter(Protocol):
    def segment(self, image) -> np.ndarray: ...


def draw_mask_contour(image_rgb: np.ndarray, mask: np.ndarray,
                      color=MAGENTA, thickness: int = 2) -> np.ndarray:
    """Paint the mask boundary in magenta — the reference uses
    cv2.findContours/drawContours (caption_generation_vipllava.py:20-45);
    here the boundary is mask XOR 4-neighbor erosion, dilated ``thickness``
    times.  No cv2 dependency."""
    mask = mask.astype(bool)
    eroded = mask.copy()
    eroded[1:, :] &= mask[:-1, :]
    eroded[:-1, :] &= mask[1:, :]
    eroded[:, 1:] &= mask[:, :-1]
    eroded[:, :-1] &= mask[:, 1:]
    boundary = mask & ~eroded
    for _ in range(max(0, thickness - 1)):
        grown = boundary.copy()
        grown[1:, :] |= boundary[:-1, :]
        grown[:-1, :] |= boundary[1:, :]
        grown[:, 1:] |= boundary[:, :-1]
        grown[:, :-1] |= boundary[:, 1:]
        boundary = grown
    out = image_rgb.copy()
    out[boundary] = np.asarray(color, out.dtype)
    return out


def caption_folder_batch(
    captioner: Captioner,
    folder: str,
    out_name: str = "wholeim_captions_batch.txt",
    batch_size: int = 10,
    exts=(".jpg", ".png"),
) -> int:
    """Whole-image captioning over a folder, batched, append-resumable
    (reference: 1_qwen_koniq_captions_run.py:80-117; append at :124).
    Returns the number of newly captioned images."""
    from PIL import Image

    from srsem_torch.pseudo.captions import parse_caption_file

    out_path = os.path.join(folder, out_name)
    done = set(parse_caption_file(out_path)) if os.path.exists(out_path) else set()
    names = [n for n in sorted(os.listdir(folder))
             if n.endswith(exts) and n.split(".")[0] not in done]
    written = 0
    for start in range(0, len(names), batch_size):
        chunk = names[start: start + batch_size]
        images = [Image.open(os.path.join(folder, n)).convert("RGB")
                  for n in chunk]
        captions = captioner.caption(images, WHOLE_IMAGE_PROMPT)
        write_caption_file(out_path, {n: " " + c for n, c in zip(chunk, captions)})
        written += len(chunk)
    return written


def generate_panoptic_pickles(
    segmenter: PanopticSegmenter,
    folder: str,
    out_dir_name: str = "general_panoptic",
    area_threshold_percent: float = 0.5,
    exts=(".jpg", ".png"),
) -> int:
    """Per-image post-processed panoptic pickles
    (reference: oneformer_panoptic.py:115-141), skip-existing resumable."""
    from PIL import Image

    out_dir = os.path.join(folder, out_dir_name)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(folder)):
        if not name.endswith(exts):
            continue
        out_path = os.path.join(out_dir, name.split(".")[0] + ".pkl")
        if os.path.exists(out_path):
            continue
        img = Image.open(os.path.join(folder, name)).convert("RGB")
        panoptic = postprocess_panoptic(
            segmenter.segment(img), area_threshold_percent)
        with open(out_path, "wb") as f:
            pickle.dump(panoptic, f)
        n += 1
    return n


def caption_regions(
    captioner: Captioner,
    image_rgb: np.ndarray,
    panoptic: np.ndarray,
    prompt: str = REGION_PROMPT,
) -> Dict[int, str]:
    """One caption per panoptic region, the region outlined in magenta
    (reference: caption_generation_vipllava.py:90-127)."""
    from PIL import Image

    out: Dict[int, str] = {}
    for rid, mask in panoptic_to_masks(panoptic).items():
        marked = Image.fromarray(draw_mask_contour(image_rgb, mask))
        out[rid] = captioner.caption([marked], prompt)[0]
    return out


class TransformersCaptioner:
    """HF-transformers captioner backend (Qwen2-VL / ViP-LLaVA class
    models).  Requires local weights — this container has no egress, so
    construction fails cleanly when the model is absent."""

    def __init__(self, model_name: str, device_map: str = "auto",
                 max_new_tokens: int = REGION_MAX_NEW_TOKENS,
                 temperature: Optional[float] = None):
        from transformers import AutoModelForVision2Seq, AutoProcessor

        self.processor = AutoProcessor.from_pretrained(model_name)
        self.model = AutoModelForVision2Seq.from_pretrained(
            model_name, device_map=device_map)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature

    def caption(self, images: Sequence, prompt: str) -> List[str]:
        msgs = [[{"role": "user",
                  "content": [{"type": "image"},
                              {"type": "text", "text": prompt}]}]
                for _ in images]
        texts = [self.processor.apply_chat_template(
            m, add_generation_prompt=True, tokenize=False) for m in msgs]
        inputs = self.processor(text=texts, images=list(images),
                                padding=True, return_tensors="pt")
        kwargs = {"max_new_tokens": self.max_new_tokens}
        if self.temperature is not None:
            kwargs.update(do_sample=True, temperature=self.temperature)
        out = self.model.generate(**inputs, **kwargs)
        trimmed = out[:, inputs["input_ids"].shape[1]:]
        return self.processor.batch_decode(trimmed, skip_special_tokens=True)


class StaticCaptioner:
    """Offline test double: returns canned captions (hash-keyed)."""

    def __init__(self, fn: Callable[[object, str], str] = None):
        self.fn = fn or (lambda img, prompt: f"caption[{prompt[:16]}]")

    def caption(self, images: Sequence, prompt: str) -> List[str]:
        return [self.fn(im, prompt) for im in images]
