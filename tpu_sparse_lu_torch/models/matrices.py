"""Test/benchmark matrix families.

Covers the reference's generators plus the BASELINE.md benchmark matrix:

* :func:`fe_block_matrix` — the reference's ``test_matrix``
  (reference test/runtests.jl:12-21): ``nelement`` dense
  ``ngrid x ngrid`` random blocks overlapping by one row/col on the
  diagonal, so ``n = nelement*(ngrid-1) + 1``.
* :func:`laplacian_1d` — tridiagonal 1D Laplacian (BASELINE config 1).
* :func:`poisson_2d` — 5-point 2D Poisson stencil (BASELINE config 4).
* :func:`block_banded` — large block-banded PDE-style matrix
  (BASELINE config 5).
* :func:`random_sparse` — well-conditioned random sparse matrices
  (BASELINE config 3).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "fe_block_matrix",
    "laplacian_1d",
    "poisson_2d",
    "block_banded",
    "random_sparse",
    "dense_random",
]


def fe_block_matrix(rng: np.random.Generator, nelement: int, ngrid: int) -> sp.csc_matrix:
    """FE-style block-overlap matrix (reference ``test_matrix``,
    test/runtests.jl:12-21)."""
    n = nelement * (ngrid - 1) + 1
    A = sp.lil_matrix((n, n))
    for el in range(nelement):
        imin = el * (ngrid - 1)
        A[imin : imin + ngrid, imin : imin + ngrid] += rng.random((ngrid, ngrid))
    return A.tocsc()


def laplacian_1d(n: int, dtype=np.float64) -> sp.csc_matrix:
    """Tridiagonal [-1, 2, -1] Laplacian."""
    main = 2.0 * np.ones(n, dtype=dtype)
    off = -1.0 * np.ones(n - 1, dtype=dtype)
    return sp.diags([off, main, off], [-1, 0, 1], format="csc", dtype=dtype)


def poisson_2d(nx: int, ny: int, dtype=np.float64) -> sp.csc_matrix:
    """5-point 2D Poisson stencil on an nx x ny grid (n = nx*ny)."""
    Ix = sp.identity(nx, dtype=dtype)
    Iy = sp.identity(ny, dtype=dtype)
    Lx = laplacian_1d(nx, dtype)
    Ly = laplacian_1d(ny, dtype)
    return (sp.kron(Iy, Lx) + sp.kron(Ly, Ix)).tocsc()


def block_banded(
    rng: np.random.Generator,
    nblocks: int,
    bs: int,
    *,
    coupling: float = 0.1,
    dtype=np.float64,
) -> sp.csc_matrix:
    """Block-tridiagonal PDE-style matrix: ``nblocks`` dense ``bs x bs``
    diagonal blocks (diagonally dominant) with random sub/super coupling
    blocks scaled by ``coupling``."""
    n = nblocks * bs
    blocks = []
    rowsidx = []
    colsidx = []
    for k in range(nblocks):
        D = rng.random((bs, bs)).astype(dtype) + bs * np.eye(bs, dtype=dtype)
        blocks.append(D)
        rowsidx.append(k)
        colsidx.append(k)
        if k + 1 < nblocks:
            blocks.append(coupling * rng.random((bs, bs)).astype(dtype))
            rowsidx.append(k + 1)
            colsidx.append(k)
            blocks.append(coupling * rng.random((bs, bs)).astype(dtype))
            rowsidx.append(k)
            colsidx.append(k + 1)
    data = np.stack(blocks)
    coo_r = np.concatenate(
        [np.repeat(np.arange(bs) + r * bs, bs) for r in rowsidx]
    )
    coo_c = np.concatenate([np.tile(np.arange(bs) + c * bs, bs) for c in colsidx])
    return sp.coo_matrix(
        (data.reshape(len(blocks), -1).ravel(), (coo_r, coo_c)), shape=(n, n)
    ).tocsc()


def random_sparse(
    rng: np.random.Generator, n: int, density: float = 0.05, dtype=np.float64
) -> sp.csc_matrix:
    """Random sparse matrix made nonsingular by a dominant diagonal."""
    nnz = max(1, int(density * n * n))
    r = rng.integers(0, n, size=nnz)
    c = rng.integers(0, n, size=nnz)
    v = rng.standard_normal(nnz).astype(dtype)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsc()
    return (A + sp.diags(np.full(n, 2.0 * np.sqrt(max(nnz / n, 1.0)), dtype=dtype))).tocsc()


def dense_random(rng: np.random.Generator, n: int, dtype=np.float64) -> sp.csc_matrix:
    """Dense random matrix stored sparse (reference dense testsets,
    test/runtests.jl:41-42)."""
    return sp.csc_matrix(rng.random((n, n)).astype(dtype))
