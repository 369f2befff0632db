"""Tridiagonal [-1, 2, -1] 1-D Laplacian, frozen.

A copy of the program's ``models.matrices.laplacian_1d`` as it stood when
the deployment was added to the benchmark, so an edit to the program's
generators does not move the matrix measured.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_1d(n: int, dtype=np.float64) -> sp.csc_matrix:
    """Tridiagonal [-1, 2, -1] Laplacian."""
    main = 2.0 * np.ones(n, dtype=dtype)
    off = -1.0 * np.ones(n - 1, dtype=dtype)
    return sp.diags([off, main, off], [-1, 0, 1], format="csc", dtype=dtype)


def build(n: int) -> sp.csc_matrix:
    return laplacian_1d(n)
