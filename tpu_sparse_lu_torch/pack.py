"""Numeric pack: scatter factor nonzeros into dense tiles.

Counterpart of ``tpu_sparse_lu/pack.py`` and of the reference's
``fill_chunks!`` (reference src/SharedMemSparseLU.jl:180-243): the
host plan (:func:`~tpu_sparse_lu_torch.symbolic.plan_triangular`) gives
every CSC nonzero a flat destination, and the pack is two ``index_add_``
calls onto flat tile buffers.

Sign convention matches the reference: diagonal-tile entries are stored
as-is (the padding diagonal is 1), off-diagonal tiles are stored
**negated** so the per-level update is a pure accumulate
(src:204-208, :235-239). Tile ``K`` / ``T`` is the dummy slot (identity /
zero).
"""

from __future__ import annotations

import torch

from .symbolic import TriPlan

__all__ = ["pack_factor"]


def pack_factor(plan: TriPlan, nzval: torch.Tensor):
    """Pack a factor's CSC ``nzval`` (CSC order, on the target device) into
    ``(diag_tiles (K+1, cs, cs), offdiag_tiles (T+1, cs, cs))``."""
    K, T, cs = plan.K, plan.T, plan.cs
    dev, dt = nzval.device, nzval.dtype
    # one spare slot past the end takes the nonzeros that belong to the
    # other buffer (the plan points them one past the end)
    diag = torch.zeros((K + 1) * cs * cs + 1, dtype=dt, device=dev)
    off = torch.zeros((T + 1) * cs * cs + 1, dtype=dt, device=dev)
    diag.index_add_(0, torch.as_tensor(plan.diag_dest, device=dev), nzval)
    off.index_add_(0, torch.as_tensor(plan.offdiag_dest, device=dev), -nzval)
    diag[torch.as_tensor(plan.pad_idx, device=dev)] += 1.0
    return (diag[:-1].view(K + 1, cs, cs), off[:-1].view(T + 1, cs, cs))
