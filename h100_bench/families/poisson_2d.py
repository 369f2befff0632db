"""5-point 2-D Poisson stencil, frozen.

A copy of the program's ``models.matrices.poisson_2d`` (and of the 1-D
Laplacian it is built from) as it stood when the benchmark was defined,
so an edit to the program's generators does not move the matrix measured.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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


def build(nx: int, ny: int) -> sp.csc_matrix:
    return poisson_2d(nx, ny)
