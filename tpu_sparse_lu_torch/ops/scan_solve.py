"""Bidiagonal factors (1-D chain matrices): detection and the affine
coefficient planes of the chain solve. Counterpart of the host half of
``tpu_sparse_lu/ops/scan_solve.py``.

For a chain matrix under a no-pivot ordering (BASELINE config 1) SuperLU's
L and U are bidiagonal, and forward/backward substitution is the
first-order linear recurrence ``y_i = a_i·y_{i∓1} + s_i·b_i``. Its affine
maps compose associatively, so the solve is a prefix scan
(:func:`~tpu_sparse_lu_torch.ops.bidiag_ldiv.bidiag_ldiv`) instead of one
level per chunk of the tile waves — a chain's chunk DAG has no width.

The planes are flat ``(n,)`` vectors. The JAX package packs them into the
TPU's ``(S, 128)`` lane layout (``pack_bands_2d``); the port does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

__all__ = ["bidiag_bands", "chain_planes"]


def bidiag_bands(M: sp.csc_matrix, *, lower: bool) -> Optional[dict]:
    """Extract (diag, off) bands when ``M`` is bidiagonal, else None.

    ``lower=True`` expects nonzeros only on the diagonal and first
    subdiagonal (SuperLU's L, unit diagonal stored explicitly —
    reference src:359 trsv 'U' flag); ``lower=False`` the first
    superdiagonal (U, non-unit diagonal).
    """
    M = sp.csc_matrix(M)
    n = M.shape[0]
    # a bidiagonal factor has at most 2n-1 nonzeros: bail before building
    # any nnz-length temporaries (this probe runs on EVERY factorization,
    # including 58M-nnz ones where the full check costs seconds)
    if M.nnz > 2 * n - 1:
        return None
    rows = M.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(M.indptr))
    d = rows - cols if lower else cols - rows
    if d.min(initial=0) < 0 or d.max(initial=0) > 1:
        return None
    diag = np.ones(n, dtype=M.dtype)
    off = np.zeros(n, dtype=M.dtype)
    on_diag = d == 0
    diag[rows[on_diag]] = M.data[on_diag]
    # off[i]: coefficient coupling y_i to its already-solved neighbour —
    # L[i, i-1] for lower (entries at row i, col i-1), U[i, i+1] for upper
    # (entries at row i, col i+1) — both index by their ROW
    osel = d == 1
    off[rows[osel]] = M.data[osel]
    return {"diag": diag, "off": off}


def chain_planes(lb: dict, ub: dict, rs: Optional[np.ndarray],
                 dtype) -> dict:
    """The coefficient planes of the chain solves, as NumPy arrays of
    ``dtype`` (the JAX package's expressions, bit for bit):

    * ``aL = -lo/ld``, ``iL = 1/ld`` — ``lsolve``: ``y_i = aL_i·y_{i-1} +
      iL_i·b_i`` (``aL_0 = 0``: L has no entry left of row 0);
    * ``aU = -uo/ud``, ``sU = 1/ud`` — ``rsolve`` and the backward sweep
      of ``ldiv``: ``x_i = aU_i·x_{i+1} + sU_i·y_i``;
    * ``sL = rs/ld`` — the forward sweep of ``ldiv``, with the row
      scaling ``Rs`` folded in; only when ``rs`` is given.
    """
    ld = np.asarray(lb["diag"], dtype)
    lo = np.asarray(lb["off"], dtype)
    ud = np.asarray(ub["diag"], dtype)
    uo = np.asarray(ub["off"], dtype)
    planes = {"aL": -lo / ld, "iL": 1.0 / ld, "aU": -uo / ud,
              "sU": 1.0 / ud}
    if rs is not None:
        planes["sL"] = np.asarray(rs, dtype) / ld
    return planes
