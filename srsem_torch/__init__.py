"""srsem_torch — the PyTorch/CUDA port of srsem for NVIDIA Hopper (H100).

A second package beside ``srsem/`` (the JAX reference, which stays as it
is).  It imports torch, numpy and PIL only — never jax, flax or srsem — and
mirrors the JAX package's module paths so each counterpart is easy to find:

* ``config``                 — srsem/core/config.py (copied)
* ``data.preprocess``        — srsem/data/preprocess.py
* ``backbones.resnet``       — srsem/backbones/resnet.py (ImageNet tower)
* ``backbones.fused_resnet`` — srsem/backbones/fused_resnet.py
* ``ops.fused_bottleneck``   — srsem/ops/fused_bottleneck.py (CUDA kernel)
* ``ops.fused_head``         — srsem/ops/fused_head.py (Triton kernel)
* ``models.global_models``   — srsem/models/global_models.py (stages_cnn)
* ``eval.scorer``            — srsem/eval/scorer.py (PairScorer)
* ``utils.convert``          — weights from JAX params / torchvision

Public functions keep the JAX layout (NHWC).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from srsem_torch.config import (  # noqa: F401
    BackboneConfig,
    GlobalModelConfig,
    LocalModelConfig,
    MeshConfig,
    TrainConfig,
)
