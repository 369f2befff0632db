"""Solver configuration: the PyTorch counterpart of ``tpu_sparse_lu.utils.config``.

Same frozen dataclass and the same defaults, minus the TPU knobs
(``use_pallas``, ``schedule``, ``matmul_precision``): the port always
computes float32 in full float32 (never TF32) and runs one level executor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for a :class:`ParallelSparseLU` factorization.

    Attributes:
      chunk_size: dense tile edge of the block decomposition of L and U.
        ``None`` → :func:`default_chunk_size` for the solver's device.
      tri_mode: how each level's diagonal tiles are solved. ``"inv"``
        (``"auto"``, the default, resolves to it): the tiles are
        pre-inverted, so a solve is tile products only, one launch on a
        card; its float64 results are held to 1e-9, the JAX package's bar
        for plain inverses. ``"trsm"``: a batched triangular solve per
        level (exact substitution), the off-diagonal waves as in
        ``"inv"``. ``"inv_refine"``: the inverse, then one correction
        ``y += Dinv·(r − D·y)`` per level. Both meet the reference's
        float64 bar of 1e-12.
      dtype: ``"float32"`` or ``"float64"``; ``None`` inherits the input
        matrix's dtype (float64 matrices solve in float64).
      ordering: ``"colamd"`` (SuperLU default), ``"natural"``, ``"mmd"`` or
        ``"nd"`` — the chunk-aligned staged nested-dissection embedding
        (ordering.py), factored without row pivoting by default.
      pivot_threshold: SuperLU ``DiagPivotThresh``; ``None`` keeps its
        default (0.0 under ``"nd"``).
      nd_cutoff: nd base-subdomain size: ``None`` (= cs), an int, or
        ``"auto"`` (tries {cs, 2cs, 4cs} under the tile-count cost model,
        one trial factorization each).
      stream_dtype: dtype of the L/U tiles ``ldiv`` reads: ``"float32"``
        (the bank itself) or ``"bfloat16"`` (a half-width copy of the bank,
        widened to float32 as the waves read it; needs ``dtype="float32"``;
        pair it with ``make_f64_ldiv`` or ``refine_steps``). The bank that
        ``F.L``/``F.U``, ``lsolve`` and ``rsolve`` read stays at ``dtype``.
        Only ``tri_mode="inv"`` reads the half-width stream; the other
        modes ignore it and solve on the bank, as the JAX package does.
      factorize: first-factorization backend. ``"host"`` (default):
        SuperLU. ``"device"``: no numeric host factorization; the first
        factorization is the blocked device elimination of
        ``refactor.py``, which needs a static-diagonal-pivot ordering
        (``"nd"``, or ``"natural"`` with ``pivot_threshold=0.0``).
        ``"auto"``: ``"device"`` under such an ordering, else ``"host"``.
      refactor_store_budget: working-set ceiling in bytes for
        ``enable_device_refactor``'s memory guard; ``None`` takes the free
        memory of the solver's device.
    """

    chunk_size: Optional[int] = None
    tri_mode: str = "auto"
    dtype: Optional[str] = None
    ordering: str = "colamd"
    pivot_threshold: Optional[float] = None
    nd_cutoff: object = None  # None | int | "auto"
    stream_dtype: str = "float32"
    factorize: str = "host"
    refactor_store_budget: Optional[int] = None

    def __post_init__(self):
        if self.tri_mode not in ("auto", "trsm", "inv", "inv_refine"):
            raise ValueError(f"unknown tri_mode: {self.tri_mode!r}")
        if self.dtype not in (None, "float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.ordering not in ("colamd", "nd", "natural", "mmd"):
            raise ValueError(f"unknown ordering: {self.ordering!r}")
        if not (self.nd_cutoff is None or self.nd_cutoff == "auto"
                or isinstance(self.nd_cutoff, int)):
            raise ValueError(f"unknown nd_cutoff: {self.nd_cutoff!r}")
        if self.stream_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown stream_dtype: {self.stream_dtype!r}")
        if self.factorize not in ("host", "device", "auto"):
            raise ValueError(f"unknown factorize: {self.factorize!r}")


def resolve_tri_mode(tri_mode: str) -> str:
    """Resolve ``tri_mode="auto"``: ``"inv"`` on every device, the mode the
    one-launch ldiv kernel serves (the JAX package picks it on TPU only)."""
    return "inv" if tri_mode == "auto" else tri_mode


def default_chunk_size(n: int, device_type: str = "cpu") -> int:
    """Chunk-size policy when the user does not pass one.

    The reference defaults to 8 and clamps to n (src:67-72). On CUDA the
    ldiv kernel is built for tiles of up to 128 rows, and the widest tile
    moves the most bytes per launch, so the default there is 128 whenever
    the problem fills a tile. Elsewhere smaller tiles scale with problem
    size, as in the JAX package.
    """
    if device_type == "cuda":
        return max(1, min(128, n))
    if n <= 256:
        cs = 8
    elif n <= 4096:
        cs = 32
    else:
        cs = 64
    return max(1, min(cs, n))
