"""The reference solve: a dense float64 LU with partial pivoting.

n is at most some tens of thousands in the cells this serves, so the
dense matrix fits a card (0.8 GB at n = 10,000) and its LU takes some
tens of milliseconds there.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def dense(A: sp.csc_matrix, device) -> torch.Tensor:
    """``A`` as a dense float64 tensor on ``device``."""
    coo = sp.coo_matrix(A)
    M = torch.zeros(A.shape, dtype=torch.float64, device=device)
    idx = (torch.as_tensor(coo.row, dtype=torch.int64, device=device),
           torch.as_tensor(coo.col, dtype=torch.int64, device=device))
    M.index_put_(idx, torch.as_tensor(coo.data, dtype=torch.float64,
                                      device=device), accumulate=True)
    return M


def solve(A: sp.csc_matrix, B: np.ndarray, device) -> np.ndarray:
    """``A⁻¹ B`` in float64, ``B`` of shape (n, m)."""
    M = dense(A, device)
    LU, piv = torch.linalg.lu_factor(M)
    del M
    X = torch.linalg.lu_solve(LU, piv, torch.as_tensor(
        B, dtype=torch.float64, device=device))
    return X.cpu().numpy()


def forward_errors(X: np.ndarray, Xref: np.ndarray) -> np.ndarray:
    """Per column, ``‖x − x_ref‖_∞ / ‖x_ref‖_∞``."""
    X = np.asarray(X, dtype=np.float64).reshape(Xref.shape)
    err = np.abs(X - Xref).max(axis=0)
    return err / np.maximum(np.abs(Xref).max(axis=0), 1e-300)


def backward_errors(A: sp.csc_matrix, X: np.ndarray, B: np.ndarray,
                    device) -> np.ndarray:
    """Per column, ``‖b − A x‖ / (‖A‖_F ‖x‖ + ‖b‖)`` in float64
    (``chip_smoke._backward_error``), the product on ``device``."""
    csr = sp.csr_matrix(A)
    M = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64),
        torch.as_tensor(csr.indices, dtype=torch.int64),
        torch.as_tensor(csr.data, dtype=torch.float64),
        size=A.shape, check_invariants=False).to(device)
    X = torch.as_tensor(np.asarray(X, dtype=np.float64).reshape(
        A.shape[0], -1), device=device)
    B = torch.as_tensor(np.asarray(B, dtype=np.float64).reshape(
        A.shape[0], -1), device=device)
    nr = torch.linalg.vector_norm(M @ X - B, dim=0)
    den = (float(spla.norm(A)) * torch.linalg.vector_norm(X, dim=0)
           + torch.linalg.vector_norm(B, dim=0))
    return (nr / den).cpu().numpy()
