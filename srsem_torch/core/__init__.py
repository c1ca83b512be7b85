"""Core: the device mesh over ``torch.distributed`` ranks (the port of
srsem/core; the configuration dataclasses are srsem_torch/config.py)."""

from srsem_torch.core.meshes import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    gather_batch,
    replicate,
    shard_batch,
)
