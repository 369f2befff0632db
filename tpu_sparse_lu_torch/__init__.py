"""tpu_sparse_lu_torch: the PyTorch and CUDA port of ``tpu_sparse_lu``.

Same lifecycle as the JAX package — factor once on the host, solve many
times on a torch device, refactor in place — with the solve running
through hand-written Hopper kernels on a CUDA device
(``csrc/*.cu``, built with ``nvcc`` at first use) and through their
plain PyTorch versions on the CPU. Imports no JAX.

* :class:`ParallelSparseLU` — factor once, solve many, refactor in place.
* :func:`cleanup_ParallelSparseLU` — buffer release (reference export).
* :func:`allocate_shared` — a zero tensor shared over a device mesh
  (``DTensor``), the counterpart of the reference's MPI shared-memory
  window export; the mesh engines are :mod:`.parallel`.
* Symbolic layer: :func:`factorize_host`, :class:`SymbolicPlan`,
  :func:`plan_triangular` (with the native planner core of
  ``utils/_symcore.cpp`` when it builds).
* :class:`SolverConfig` — static configuration.
* :mod:`models` — the test and benchmark matrix families.
"""

from . import models
from .api import ParallelSparseLU, cleanup_ParallelSparseLU
from .parallel.mesh import allocate_shared
from .symbolic import (
    HostFactors,
    SymbolicPlan,
    TriPlan,
    build_symbolic_plan,
    factorize_host,
    plan_triangular,
)
from .utils.config import SolverConfig, default_chunk_size

__all__ = [
    "ParallelSparseLU",
    "cleanup_ParallelSparseLU",
    "allocate_shared",
    "HostFactors",
    "SymbolicPlan",
    "TriPlan",
    "build_symbolic_plan",
    "factorize_host",
    "plan_triangular",
    "SolverConfig",
    "default_chunk_size",
    "models",
]

__version__ = "0.1.0"
