"""Block-tridiagonal PDE-style matrix, frozen.

A copy of the program's ``models.matrices.block_banded`` as it stood when
the benchmark was defined, so an edit to the program's generators does
not move the matrix measured.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def block_banded(rng: np.random.Generator, nblocks: int, bs: int, *,
                 coupling: float = 0.1, dtype=np.float64) -> sp.csc_matrix:
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


def build(nblocks: int, bs: int, matrix_seed: int) -> sp.csc_matrix:
    """The matrix of ``block_banded(np.random.default_rng(matrix_seed),
    nblocks, bs)``: fixed by the configuration, not by a run's seed."""
    return block_banded(np.random.default_rng(matrix_seed), nblocks, bs)
