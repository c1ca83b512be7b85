"""Image constants — the preprocessing means/stds of srsem/ops/image.py
(:153-156), matching the reference's timm/CLIP transforms."""

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
