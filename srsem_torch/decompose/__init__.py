"""Sparse concept decomposition: SpLiCE (ADMM/Lasso) + greedy text-span —
the port of srsem/decompose."""

from srsem_torch.decompose.admm import admm_lasso  # noqa: F401
from srsem_torch.decompose.splice import SpliceDecomposer  # noqa: F401
from srsem_torch.decompose.greedy import GreedyDecomposer  # noqa: F401
