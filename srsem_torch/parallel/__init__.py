"""Parallelism: column-parallel tower convs over the mesh's model axis."""

from srsem_torch.parallel.sharding import (  # noqa: F401
    param_pspecs,
    param_shardings,
)
