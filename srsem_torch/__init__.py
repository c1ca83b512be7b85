"""srsem_torch — the PyTorch/CUDA port of srsem for NVIDIA Hopper (H100).

A second package beside ``srsem/`` (the JAX reference, which stays as it
is).  It imports torch, numpy and PIL only — never jax, flax or srsem — and
mirrors the JAX package's module paths so each counterpart is easy to find:

* ``config``                 — srsem/core/config.py (copied)
* ``data.preprocess``        — srsem/data/preprocess.py
* ``ops.image``              — srsem/ops/image.py (resizes, pos-embed)
* ``backbones.resnet``       — srsem/backbones/resnet.py (ImageNet, CLIP)
* ``backbones.fused_resnet`` — srsem/backbones/fused_resnet.py
* ``ops.fused_bottleneck``   — srsem/ops/fused_bottleneck.py (CUDA kernel)
* ``ops.fused_decoder``      — srsem/ops/fused_decoder.py (CUDA kernel)
* ``ops.fused_head``         — srsem/ops/fused_head.py (CUDA kernel)
* ``models.global_models``   — srsem/models/global_models.py (CNN heads)
* ``models.local_models``    — srsem/models/local_models.py (CluUnet)
* ``eval.scorer``            — srsem/eval/scorer.py (PairScorer)
* ``eval.grouped``           — srsem/eval/grouped.py (GroupedPairScorer,
  GroupedMapScorer)
* ``eval.dataset_sweep``     — srsem/eval/dataset_sweep.py (DualScorer)
* ``cli.serve``              — srsem/cli/serve.py (ScoreService, serve)
* ``native``                 — srsem/native (C++ JPEG/PNG decoder, g++)
* ``utils.profiling``        — srsem/utils/profiling.py (torch.profiler)
* ``train.checkpoint``       — srsem/train/checkpoint.py (flax msgpack)
* ``train.partition``        — srsem/train/partition.py
* ``utils.convert``          — weights from JAX params / torchvision / CLIP

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
