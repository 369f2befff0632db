"""The reference solve of a banded matrix: a block-tridiagonal LU in
float64, partial pivoting inside each diagonal block.

For deployments too large for a dense LU (n = 102,400 is 84 GB dense). A
matrix whose nonzeros lie within ``w`` of the diagonal is block
tridiagonal in blocks of ``w``: the solve is the block Thomas algorithm,
a ``w x w`` LU and two products a block, on the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from h100_bench.reference.dense_f64 import backward_errors, forward_errors

__all__ = ["solve", "forward_errors", "backward_errors", "blocks"]


def blocks(A: sp.csc_matrix, device, dtype=torch.float64):
    """``A`` as three stacks of ``w x w`` blocks, ``w`` its bandwidth:
    the diagonal blocks, the blocks left of them and the blocks right of
    them (block k's neighbours k-1 and k+1). The last block is padded
    with the identity."""
    coo = sp.coo_matrix(A)
    n = A.shape[0]
    w = max(1, int(np.abs(coo.row.astype(np.int64) - coo.col).max()))
    nb = -(-n // w)
    r = torch.as_tensor(coo.row, dtype=torch.int64, device=device)
    c = torch.as_tensor(coo.col, dtype=torch.int64, device=device)
    T = torch.zeros((3, nb, w, w), dtype=dtype, device=device)
    T.index_put_((c // w - r // w + 1, r // w, r % w, c % w),
                 torch.as_tensor(coo.data, dtype=dtype, device=device),
                 accumulate=True)
    pad = torch.arange(n, nb * w, device=device)
    T[1, pad // w, pad % w, pad % w] = 1.0
    return T[0], T[1], T[2], w


def thomas(A: sp.csc_matrix, B: np.ndarray, device, dtype, factor, mm):
    """``A⁻¹ B`` by the block Thomas algorithm: ``factor(M)`` returns a
    function that applies ``M⁻¹``, ``mm`` is the product."""
    Lo, D, Up, w = blocks(A, device, dtype)
    n, m = B.shape
    nb = D.shape[0]
    Bp = torch.zeros((nb * w, m), dtype=dtype, device=device)
    Bp[:n] = torch.as_tensor(B, dtype=dtype, device=device)
    Bp = Bp.view(nb, w, m)
    Cp = torch.empty_like(D)
    dp = torch.empty_like(Bp)
    for k in range(nb):
        M, rhs = D[k], Bp[k]
        if k:
            M = M - mm(Lo[k], Cp[k - 1])
            rhs = rhs - mm(Lo[k], dp[k - 1])
        inv = factor(M)
        if k + 1 < nb:
            Cp[k] = inv(Up[k])
        dp[k] = inv(rhs)
    X = torch.empty_like(dp)
    X[nb - 1] = dp[nb - 1]
    for k in range(nb - 2, -1, -1):
        X[k] = dp[k] - mm(Cp[k], X[k + 1])
    return X.reshape(nb * w, m)[:n].double().cpu().numpy()


def _lu(M: torch.Tensor):
    LU, piv = torch.linalg.lu_factor(M)
    return lambda R: torch.linalg.lu_solve(LU, piv, R)


def solve(A: sp.csc_matrix, B: np.ndarray, device) -> np.ndarray:
    """``A⁻¹ B`` in float64, ``B`` of shape (n, m)."""
    return thomas(A, B, device, torch.float64, _lu, torch.matmul)
