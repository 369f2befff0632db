"""The work a step needs, counted from sparsity patterns, and the card's
peaks: the yardstick of every roofline share.

Counts come from the pattern of ``A`` and of the host factors ``L`` and
``U`` of the deployment's ordering, never from the program's tile store,
so a share reads the same whatever implements the kernel. A kernel's
least time is the larger of its operations over the peak operation rate
and its bytes over the memory rate; its roofline share is that least time
over its measured device time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

# NVIDIA H100 SXM (data sheet, dense rates, 700 W): HBM3 bandwidth, and the
# highest rate at which each type is computed in full precision (float32 on
# the CUDA cores; float64 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 67e12}
INDEX_BYTES = 4  # int32 row or column indices


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations and bytes of a step's parts.

    ``nnz_lu`` counts the factors' stored entries: L below its unit
    diagonal, and U with its diagonal. ``ldiv``: the factors' values and
    their indices read once, ``b`` read once, ``x`` written once, and two
    operations per factor entry and right-hand side. ``elim``: the no-pivot
    LU over the filled pattern, ``2·|L(k+1:, k)|·|U(k, k+1:)|`` plus
    ``|L(k+1:, k)|`` divisions over the pivots ``k``; the filled pattern's
    values read and written once. ``assembly``: ``A``'s values read once,
    the filled pattern's values written once.
    """

    dtype: str
    n: int
    rhs: int
    nnz_a: int
    nnz_lu: int
    elim_flop: int

    @property
    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize

    @property
    def ldiv_flop(self) -> int:
        return 2 * self.rhs * self.nnz_lu

    @property
    def ldiv_bytes(self) -> int:
        return (self.nnz_lu * (self.itemsize + INDEX_BYTES)
                + 2 * self.n * self.rhs * self.itemsize)

    @property
    def elim_bytes(self) -> int:
        return 2 * self.nnz_lu * self.itemsize

    @property
    def assembly_bytes(self) -> int:
        return (self.nnz_a + self.nnz_lu) * self.itemsize

    def least_s(self, flop: int, nbytes: int) -> float:
        """The least time of ``flop`` operations and ``nbytes`` bytes."""
        return max(flop / PEAK_FLOP_PER_S[self.dtype],
                   nbytes / HBM_BYTES_PER_S)

    @property
    def ldiv_s(self) -> float:
        return self.least_s(self.ldiv_flop, self.ldiv_bytes)

    @property
    def elim_s(self) -> float:
        return self.least_s(self.elim_flop, self.elim_bytes)

    @property
    def assembly_s(self) -> float:
        return self.least_s(0, self.assembly_bytes)


def count(A: sp.spmatrix, L: sp.spmatrix, U: sp.spmatrix, rhs: int,
          dtype: str) -> Work:
    """The :class:`Work` of a deployment from the patterns of ``A`` and of
    its host factors ``L`` (unit lower) and ``U`` (upper)."""
    Ls = sp.csc_matrix(sp.tril(L, -1))  # entries of column k below k
    Us = sp.csr_matrix(sp.triu(U, 1))   # entries of row k right of k
    l_k = np.diff(Ls.indptr).astype(np.int64)
    u_k = np.diff(Us.indptr).astype(np.int64)
    return Work(
        dtype=dtype, n=A.shape[0], rhs=rhs, nnz_a=int(A.nnz),
        nnz_lu=int(Ls.nnz + sp.csr_matrix(U).nnz),
        elim_flop=int(np.sum(2 * l_k * u_k + l_k)),
    )
