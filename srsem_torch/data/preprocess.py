"""Image decode + preprocessing — the port of srsem/data/preprocess.py.

timm's eval transform (reference: models/global_eval_models.py:331-333):
resize the shortest edge to ``size / crop_pct`` with bicubic
interpolation, center-crop ``size``, scale to [0,1], normalize.  CLIP
backbones use crop_pct 1.0 and CLIP mean/std; the ImageNet backbone uses
crop_pct 0.875 and ImageNet mean/std.

Decode + resize + crop run on host threads and produce HWC uint8 (PIL, the
same code as the JAX package, so the bytes are identical; or the native
C++ decoder, srsem_torch/native, with ``decode_uint8_native``); the
scale+normalize step runs on the device (``device_normalize``), so only 3
bytes a pixel cross PCIe.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from srsem_torch.ops.image import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD

#: Canonical image-file extensions for folder jobs.
IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


@dataclasses.dataclass(frozen=True)
class Preprocess:
    """timm-eval-equivalent preprocessing pipeline."""

    size: int = 224
    crop_pct: float = 1.0
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    interpolation: int = Image.BICUBIC
    # DCT-scaled JPEG decode (PIL Image.draft): decode at the largest M/8
    # downscale whose shortest edge still covers the resize target.
    # ~LSB-scale differences vs the full decode; off by default.
    fast_jpeg: bool = False

    @staticmethod
    def for_backbone(kind: str, size: int = 224,
                     fast_jpeg: bool = False) -> "Preprocess":
        if kind in ("resnet50_clip", "vit_clip"):
            return Preprocess(size=size, crop_pct=1.0, mean=CLIP_MEAN,
                              std=CLIP_STD, fast_jpeg=fast_jpeg)
        if kind == "resnet50":
            # Classic ImageNet eval crop_pct (timm's a1_in1k weights use
            # 0.95 — construct Preprocess(crop_pct=0.95, ...) for those).
            return Preprocess(size=size, crop_pct=0.875,
                              mean=IMAGENET_MEAN, std=IMAGENET_STD,
                              fast_jpeg=fast_jpeg)
        raise ValueError(f"unknown backbone kind {kind!r}")

    def decode_uint8_native(self, path: str) -> Optional[np.ndarray]:
        """The C++ decoder (srsem_torch/native): libjpeg/libpng decode +
        bicubic resample, within ~0.2 LSB mean of PIL.  Returns None when
        the native library is unavailable or the file fails to decode."""
        from srsem_torch import native

        if not native.available():
            return None
        return native.decode(path, self.size, self.crop_pct,
                             fast_jpeg=self.fast_jpeg)

    def decode_batch_native(self, paths, n_threads: int = 16):
        """Batch C++ decode → (N, size, size, 3) uint8 + ok mask."""
        from srsem_torch import native

        return native.decode_batch(paths, self.size, self.crop_pct,
                                   n_threads, fast_jpeg=self.fast_jpeg)

    def decode_uint8(self, path_or_img) -> np.ndarray:
        """Host path: decode → shortest-edge bicubic resize → center crop.
        Returns HWC uint8."""
        img = path_or_img
        if not isinstance(img, Image.Image):
            img = Image.open(img)
        if self.fast_jpeg and getattr(img, "format", None) == "JPEG":
            t = int(round(self.size / self.crop_pct))
            img.draft("RGB", (t, t))
        img = img.convert("RGB")
        scale_size = int(round(self.size / self.crop_pct))
        w, h = img.size
        if w <= h:
            new_w, new_h = scale_size, max(1, int(round(h * scale_size / w)))
        else:
            new_w, new_h = max(1, int(round(w * scale_size / h))), scale_size
        img = img.resize((new_w, new_h), self.interpolation)
        left = (new_w - self.size) // 2
        top = (new_h - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        return np.asarray(img, dtype=np.uint8)

    def __call__(self, path_or_img) -> np.ndarray:
        """Full host path: HWC float32, normalized."""
        x = self.decode_uint8(path_or_img).astype(np.float32) / 255.0
        return ((x - np.asarray(self.mean, np.float32))
                / np.asarray(self.std, np.float32))

    def device_normalize(self, batch_u8: torch.Tensor) -> torch.Tensor:
        """NHWC uint8 tensor → normalized float32 NHWC on the same device."""
        x = batch_u8.to(torch.float32) / 255.0
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return (x - mean) / std


def decode_image(path, size: int = 224, kind: str = "resnet50_clip") -> np.ndarray:
    return Preprocess.for_backbone(kind, size).decode_uint8(path)
