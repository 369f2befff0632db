"""The work of the float64 tier's refinement (``make_f64_ldiv``), counted
from the pattern of ``A``, ``n``, ``R`` and the sweeps, never from the
program's CSR tensor, and the device time it took in a traced window.

A sweep reads ``A``'s float64 values and int32 column indices once and its
``n + 1`` int32 row pointers; reads ``x`` and ``b`` (float64), writes the
float32 residual, reads the float32 correction, and reads and writes
``x`` (float64): 40 bytes an entry of the ``(n, R)`` panel. It computes
``2·nnz(A)·R`` operations in the product and ``3·n·R`` in the
subtraction, the casts and the update. The direct solves are not counted
here: ``work.Work.ldiv_s`` is theirs.
"""

from __future__ import annotations

import dataclasses

from h100_bench import work

# the direct solve's kernel; every other device operation of the step is
# the refinement (with the right-hand side's conversion to float64)
SOLVE_KERNEL = r"\bldiv_fused_kernel\b"
PANEL_BYTES = 8 + 8 + 4 + 4 + 8 + 8  # x, b, residual, correction, x, x
VALUE_BYTES = 8 + work.INDEX_BYTES    # a float64 value and its index


@dataclasses.dataclass(frozen=True)
class RefineWork:
    n: int
    rhs: int
    nnz_a: int
    sweeps: int

    @property
    def flop(self) -> int:
        return self.sweeps * (2 * self.nnz_a * self.rhs
                              + 3 * self.n * self.rhs)

    @property
    def bytes(self) -> int:
        return self.sweeps * (VALUE_BYTES * self.nnz_a
                              + work.INDEX_BYTES * (self.n + 1)
                              + PANEL_BYTES * self.n * self.rhs)

    @property
    def least_s(self) -> float:
        return max(self.flop / work.PEAK_FLOP_PER_S["float64"],
                   self.bytes / work.HBM_BYTES_PER_S)


def count(w: "work.Work", sweeps: int) -> RefineWork:
    """The refinement's work at the deployment of ``w`` (``n``, ``R``,
    ``nnz(A)``) over ``sweeps`` sweeps."""
    return RefineWork(n=w.n, rhs=w.rhs, nnz_a=w.nnz_a, sweeps=sweeps)


def step_s(trace):
    """Device seconds a traced step of every operation but the direct
    solve's kernel, or None when the window has no device operation."""
    if trace is None or not trace.steps or not trace.ops:
        return None
    return (trace.op_s("") - trace.op_s(SOLVE_KERNEL)) / trace.steps
