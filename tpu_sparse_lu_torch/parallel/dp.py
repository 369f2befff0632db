"""Data-parallel multi-RHS solves: counterpart of
``tpu_sparse_lu/parallel/dp.py``. The ``(n, R)`` panel is split by
columns over the ranks; the factors are replicated (every rank holds its
solver). No collective runs in the solve itself.
"""

from __future__ import annotations

import torch

from ._comm import Collectives, check_device
from .mesh import mesh_axis

__all__ = ["make_dp_ldiv"]


def make_dp_ldiv(F, mesh, axis: str = "chunks"):
    """Returns ``solve(b)`` for ``b: (n, R)`` given on every rank, ``R``
    divisible by the mesh size ``D``: each rank solves its ``R/D``
    columns with its own ``F.ldiv`` (on a card one ``ldiv_fused`` launch,
    on the rank's current stream) and returns a ``DTensor`` of the whole
    ``(n, R)`` solution sharded by columns (``Shard(1)``, the JAX
    ``out_shardings=P(None, axis)``): ``.to_local()`` is the rank's
    columns, ``.full_tensor()`` gathers the panel with one all-gather.
    """
    from torch.distributed.tensor import DTensor, Shard

    group, D, d = mesh_axis(mesh, axis)
    check_device(F, group)
    comm = Collectives(group, D, d)

    def solve(b):
        b = torch.as_tensor(b, dtype=F.dtype, device=F.device)
        if b.dim() != 2:
            raise ValueError("dp ldiv expects an (n, R) panel")
        n, R = b.shape
        if R % D:
            raise ValueError(f"R={R} is not divisible by the mesh size {D}")
        comm.reset()
        w = R // D
        x = F.ldiv(b[:, d * w:(d + 1) * w])
        return DTensor.from_local(x, mesh, [Shard(1)], run_check=False,
                                  shape=torch.Size((n, R)), stride=(R, 1))

    solve.collectives = comm
    return solve
