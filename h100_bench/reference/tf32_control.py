"""The control: the reference solve computed in TF32.

The deployments state float32 with TF32 off (the program never rounds to
TF32), so the nearest precision below is TF32. The control factors the
dense matrix as the tensor cores would in TF32: a right-looking blocked
LU whose products round their operands to TF32 (10 mantissa bits, round
to nearest even) and accumulate in float32, and the same for the blocked
substitutions. Rounding is explicit, so the control reads the same on a
card and on the CPU, whatever ``torch.backends.cuda.matmul.allow_tf32``
says. No pivoting: the deployments it serves are diagonally dominant.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from h100_bench.reference.dense_f64 import dense

BLOCK = 32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _lu_unblocked(D: torch.Tensor) -> None:
    """In place, no pivoting: D = L\\U, L unit lower."""
    for k in range(D.shape[0] - 1):
        D[k + 1:, k] /= D[k, k]
        D[k + 1:, k + 1:] -= torch.outer(D[k + 1:, k], D[k, k + 1:])


def lu_tf32(M: torch.Tensor) -> torch.Tensor:
    """Blocked LU of a float32 matrix, in place, products in TF32."""
    n = M.shape[0]
    for k in range(0, n, BLOCK):
        e = min(k + BLOCK, n)
        _lu_unblocked(M[k:e, k:e])
        if e < n:
            Lkk = torch.tril(M[k:e, k:e], -1) + torch.eye(
                e - k, dtype=M.dtype, device=M.device)
            Ukk = torch.triu(M[k:e, k:e])
            M[k:e, e:] = torch.linalg.solve_triangular(
                Lkk, M[k:e, e:], upper=False, unitriangular=True)
            M[e:, k:e] = torch.linalg.solve_triangular(
                Ukk, M[e:, k:e], upper=True, left=False)
            M[e:, e:] -= mm(M[e:, k:e], M[k:e, e:])
    return M


def substitute(LU: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``U⁻¹ L⁻¹ X`` by blocks, the off-diagonal products in TF32."""
    n = LU.shape[0]
    starts = list(range(0, n, BLOCK))
    for k in starts:  # forward, unit lower
        e = min(k + BLOCK, n)
        if k:
            X[k:e] -= mm(LU[k:e, :k], X[:k])
        X[k:e] = torch.linalg.solve_triangular(
            LU[k:e, k:e], X[k:e], upper=False, unitriangular=True)
    for k in reversed(starts):  # backward, upper
        e = min(k + BLOCK, n)
        if e < n:
            X[k:e] -= mm(LU[k:e, e:], X[e:])
        X[k:e] = torch.linalg.solve_triangular(
            LU[k:e, k:e], X[k:e], upper=True)
    return X


def solve(A: sp.csc_matrix, B: np.ndarray, device) -> np.ndarray:
    """``A⁻¹ B`` as a TF32 computation would give it, ``B`` (n, m)."""
    M = dense(A, device).to(torch.float32)
    lu_tf32(M)
    X = torch.as_tensor(B, dtype=torch.float32, device=device).clone()
    return substitute(M, X).double().cpu().numpy()
