"""tpu_sparse_lu_torch: the PyTorch and CUDA port of ``tpu_sparse_lu``.

Same lifecycle as the JAX package — factor once on the host, solve many
times on a torch device, refactor in place — with the solve running
through hand-written Hopper kernels on a CUDA device
(``csrc/*.cu``, built with ``nvcc`` at first use) and through their
plain PyTorch versions on the CPU. Imports no JAX.

* :class:`ParallelSparseLU` — factor once, solve many, refactor in place.
* :func:`cleanup_ParallelSparseLU` — buffer release (reference export).
* :class:`SolverConfig` — static configuration.
* :mod:`models` — the test and benchmark matrix families.
"""

from . import models
from .api import ParallelSparseLU, cleanup_ParallelSparseLU
from .utils.config import SolverConfig

__all__ = [
    "ParallelSparseLU",
    "SolverConfig",
    "cleanup_ParallelSparseLU",
    "models",
]

__version__ = "0.1.0"
