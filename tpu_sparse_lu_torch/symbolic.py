"""Host-side symbolic layer: factorization backend + chunk/tile planner +
level scheduler.

This is the TPU-native replacement for two things in the reference:

* the UMFPACK factorization backend (C8 in SURVEY.md §2 —
  reference src/SharedMemSparseLU.jl:74,:247): we delegate the *first*
  numeric factorization to SuperLU (scipy ``splu``) on the host, normalised
  to the reference's convention ``L @ U == (Rs .* A)[p, q]``
  (src:292-316), with row equilibration ``Rs`` computed by us so it is
  exposed (SuperLU hides its own);

* the chunk planner ``get_chunking_parameters`` (C2, src:101-149): instead
  of one bounding-box rectangular block per chunk (quadratic blow-up for
  scattered fill — SURVEY.md §7 hard part 3), we tile each factor into
  chunk-aligned ``cs x cs`` dense tiles and compute an Anderson–Saad level
  schedule over the chunk dependency DAG, so that independent chunks within
  a level execute as one batched device op instead of the reference's
  strictly serial chunk loop (src:355-364).

Everything produced here is static host data (NumPy): shapes, index maps and
schedules. The numeric path (pack / solve) is PyTorch over these static
plans — the same symbolic/numeric split the reference uses to make ``lu!``
cheap (src:245-279).

This is a copy of ``tpu_sparse_lu/symbolic.py`` (importing that module
would import JAX through its package ``__init__``). As there, the level
recurrence and the per-nonzero pass of :func:`plan_triangular` run in the
native core (``utils/_symcore.cpp``, built with ``g++`` at first use)
when it builds, else in NumPy; the plans are identical either way and to
the JAX package's, and :meth:`SymbolicPlan.save` writes its file.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .utils import _symcore_build

__all__ = [
    "HostFactors",
    "TriPlan",
    "SymbolicPlan",
    "factorize_host",
    "plan_triangular",
    "build_symbolic_plan",
    "dataclass_arrays",
    "dataclass_from_arrays",
]


# ---------------------------------------------------------------------------
# Factorization backend (reference C8: UMFPACK → SuperLU, normalised)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostFactors:
    """Normalised LU factors satisfying ``L @ U == (Rs[:,None] * A)[p][:, q]``.

    Mirrors the five UMFPACK outputs the reference consumes
    (src/SharedMemSparseLU.jl:75-79, :292-316): ``L`` lower triangular with
    explicit unit diagonal, ``U`` upper triangular (non-unit), ``p``/``q``
    row/column permutations, ``Rs`` row scaling.
    """

    m: int
    n: int
    L: sp.csc_matrix
    U: sp.csc_matrix
    p: np.ndarray
    q: np.ndarray
    Rs: np.ndarray

    def pattern_signature(self) -> Tuple:
        """Hashable sparsity signature of (L, U) for the pattern-change check
        the reference runs on every ``lu!`` (src:252-258)."""
        return (
            self.L.indptr.tobytes(),
            self.L.indices.tobytes(),
            self.U.indptr.tobytes(),
            self.U.indices.tobytes(),
        )


def _row_equilibration(A: sp.csc_matrix) -> np.ndarray:
    """Row scaling Rs with Rs[i] = 1 / max_j |A[i, j]| (UMFPACK-style).

    The reference's ``Rs`` comes out of UMFPACK (src:307-316); SuperLU does
    not expose its equilibration vector, so we equilibrate ourselves and
    factor the scaled matrix with SuperLU equilibration off.
    """
    absA = abs(A)
    rowmax = np.asarray(absA.max(axis=1).todense()).ravel()
    rowmax = np.where(rowmax > 0, rowmax, 1.0)
    return 1.0 / rowmax


def factorize_host(
    A: sp.spmatrix,
    *,
    equilibrate: bool = True,
    permc_spec: str = "COLAMD",
    diag_pivot_thresh: Optional[float] = None,
) -> HostFactors:
    """Factor ``A`` on the host, normalised to the reference convention.

    scipy's SuperLU returns ``L @ U == A[argsort(perm_r)][:, argsort(perm_c)]``
    (verified empirically; see tests/test_symbolic.py), so the reference-style
    permutations are ``p = argsort(perm_r)``, ``q = argsort(perm_c)``.
    """
    A = sp.csc_matrix(A)
    m, n = A.shape
    if m != n:
        raise ValueError(f"matrix must be square, got {m}x{n}")
    if equilibrate:
        Rs = _row_equilibration(A)
        A_s = sp.diags(Rs).tocsc() @ A
    else:
        Rs = np.ones(m, dtype=A.dtype if np.issubdtype(A.dtype, np.floating) else np.float64)
        A_s = A
    options = dict(Equil=False)
    if diag_pivot_thresh is not None:
        options["DiagPivotThresh"] = diag_pivot_thresh
    lu = spla.splu(A_s.tocsc(), permc_spec=permc_spec, options=options)
    p = np.argsort(lu.perm_r).astype(np.int64)
    q = np.argsort(lu.perm_c).astype(np.int64)
    # Canonicalize: SuperLU's factors come out index-UNSORTED when pivots
    # move, which would make the byte-level pattern signature (the
    # reference's lu! pattern-change check, src:252-258) spuriously differ
    # for identical patterns and force a needless reallocation.
    L = lu.L.tocsc()
    L.sort_indices()
    U = lu.U.tocsc()
    U.sort_indices()
    return HostFactors(
        m=m,
        n=n,
        L=L,
        U=U,
        p=p,
        q=q,
        Rs=np.asarray(Rs, dtype=np.float64),
    )


# ---------------------------------------------------------------------------
# Chunk/tile planner + level scheduler (reference C2 → TPU tiles + levels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TriPlan:
    """Static plan for one triangular factor (L or U).

    The factor is partitioned into ``K = ceil(n / cs)`` column chunks of
    width ``cs`` (the reference's chunking, src:108-114). Each nonzero block
    ``(brow, bcol)`` of the chunk grid becomes either:

    * the *diagonal tile* of chunk ``k`` (``brow == bcol == k``) — the
      reference's triangular chunk (src:160, :171), padded to ``cs x cs``
      with unit diagonal in the padding rows; or
    * an *off-diagonal tile* — the reference's rectangular chunk
      (src:163, :174) split into chunk-aligned ``cs x cs`` tiles instead of
      one bounding box, and stored **negated** so the level update is a pure
      accumulate (the reference's sign trick, src:204-208, :235-239).

    ``lower=True`` plans the forward solve (chunk k depends on chunks c < k
    with a tile (k, c)); ``lower=False`` the backward solve (deps c > k).
    The level schedule is the longest-path layering of that DAG; each level
    runs as two waves, its diagonal tiles and then the off-diagonal tiles
    whose source chunk lies in it.

    All arrays are host NumPy int32; tile/chunk id ``K`` (resp. ``T``) is a
    dummy padding slot.
    """

    n: int
    cs: int
    K: int  # number of real chunks
    T: int  # number of real off-diagonal tiles
    lower: bool
    # tile -> chunk-grid coordinates, length T+1 (last = dummy -> K)
    tile_brow: np.ndarray
    tile_bcol: np.ndarray
    # schedule: (NL, MC) chunk ids and (NL, MT) tile ids, padded with K / T
    level_chunks: np.ndarray
    level_tiles: np.ndarray
    # pack scatter maps: for each nonzero of the factor's CSC data,
    # a destination in the flattened (K+1, cs, cs) diag-tile buffer or the
    # flattened (T+1, cs, cs) off-diag buffer (exactly one is real; the other
    # points at the dummy tile), following fill_chunks! (src:180-243).
    diag_dest: np.ndarray
    offdiag_dest: np.ndarray
    # flat indices (into the (K+1)*cs*cs diag buffer) of padding diagonal
    # positions that receive an implicit 1.0 (tail rows of the last real
    # chunk + the whole dummy tile) — kept as indices, not a dense mask
    pad_idx: np.ndarray
    # per-level real widths: the waves read only these entries
    level_chunk_counts: np.ndarray
    level_tile_counts: np.ndarray

    @property
    def num_levels(self) -> int:
        return self.level_chunks.shape[0]


def _level_schedule(ub: np.ndarray, uc: np.ndarray, K: int, lower: bool) -> np.ndarray:
    """Longest-path level of each chunk in the tile DAG.

    ``ub``/``uc`` are tile (brow, bcol) sorted by brow, so each chunk's
    dependency list is a contiguous run. Uses the native core when it
    built (``utils/_symcore_build.native``), else the NumPy recurrence.
    """
    level = np.zeros(K, dtype=np.int64)
    if K == 0 or ub.size == 0:
        return level
    core = _symcore_build.native()
    if core is not None:
        return core.level_schedule(ub, uc, K, lower)
    starts = np.searchsorted(ub, np.arange(K + 1))
    order = range(K) if lower else range(K - 1, -1, -1)
    for k in order:
        s, e = starts[k], starts[k + 1]
        if e > s:
            level[k] = level[uc[s:e]].max() + 1
    return level


def plan_triangular(
    M: sp.csc_matrix, cs: int, *, lower: bool, extra_tiles=None
) -> TriPlan:
    """Build the tile plan + level schedule for one triangular factor.

    ``extra_tiles`` — optional iterable of (brow, bcol) chunk-grid
    coordinates to include beyond the factor's own nonzero tiles. The
    device refactorization (``refactor.closure_solve_plans``) passes the
    blocked-fill closure, so the solve plans cover every tile the
    elimination produces and consume its tiles directly.
    """
    M = sp.csc_matrix(M)
    n = M.shape[0]
    if M.shape[0] != M.shape[1]:
        raise ValueError("factor must be square")
    cs = max(1, min(cs, n))
    K = -(-n // cs)

    indptr, rows = M.indptr, M.indices
    nnz = rows.shape[0]

    extra_keys = np.zeros(0, dtype=np.int64)
    if extra_tiles is not None:
        extra = np.asarray(sorted(set(map(tuple, extra_tiles))),
                           dtype=np.int64)
        if extra.size:
            bad = (extra[:, 0] <= extra[:, 1] if lower
                   else extra[:, 0] >= extra[:, 1])
            if np.any(bad):
                raise ValueError("extra_tiles on the wrong side of the "
                                 "diagonal")
            extra_keys = extra[:, 0] * np.int64(K) + extra[:, 1]

    # --- tile keys + pack scatter maps (one native pass when built) -----
    # the O(nnz) middle (unique tile keys and per-nonzero pack
    # destinations, the reference's fill_chunks! dest computation,
    # src:180-243): the NumPy version below materializes several
    # nnz-length temporaries
    core = _symcore_build.native()
    if core is not None:
        uniq_keys, diag_dest, offdiag_dest = core.plan_maps(
            indptr, rows, cs, K, lower, extra_keys)
        T = uniq_keys.shape[0]
        ub = uniq_keys // K
        uc = uniq_keys % K
    else:
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        brow = rows // cs
        bcol = cols // cs

        offdiag_mask = brow > bcol if lower else brow < bcol
        diag_mask = brow == bcol
        # Sanity: a triangular factor has no entries on the wrong side.
        if not np.all(offdiag_mask | diag_mask):
            bad = np.count_nonzero(~(offdiag_mask | diag_mask))
            raise ValueError(
                f"{bad} entries on the wrong side of the diagonal for "
                f"{'lower' if lower else 'upper'} factor"
            )

        # Tiles are keyed as brow*K + bcol; np.unique on keys replaces any
        # per-nonzero Python loop (23s -> ms at n=250k).
        od_keys = brow[offdiag_mask] * np.int64(K) + bcol[offdiag_mask]
        if extra_keys.size:
            od_keys = np.concatenate([od_keys, extra_keys])
        uniq_keys = np.unique(od_keys)
        T = uniq_keys.shape[0]
        ub = uniq_keys // K
        uc = uniq_keys % K

        # --- pack scatter maps (reference fill_chunks!, src:180-243) ---
        lr = rows % cs
        lc = cols % cs
        # Destinations for the "other" buffer are one-past-the-end: the
        # packer drops them, so they vanish instead of polluting the dummy
        # tiles.
        diag_dest = np.full(nnz, (K + 1) * cs * cs, dtype=np.int64)
        offdiag_dest = np.full(nnz, (T + 1) * cs * cs, dtype=np.int64)
        dsel = diag_mask
        diag_dest[dsel] = (brow[dsel] * cs + lr[dsel]) * cs + lc[dsel]
        osel = offdiag_mask
        if np.any(osel):
            # tile id of each nonzero = position of its key in uniq_keys
            t_of_nz = np.searchsorted(
                uniq_keys, brow[osel] * np.int64(K) + bcol[osel]
            )
            offdiag_dest[osel] = (t_of_nz * cs + lr[osel]) * cs + lc[osel]

    # pack maps are per-NONZERO: at n ~ 1e5 they are the plan's dominant
    # memory (and the dominant bytes of ParallelSparseLU.save). int32
    # whenever the one-past-the-end sentinel fits — the gather/scatter
    # consumers are indifferent, and it halves plan RAM/disk/load time.
    if (K + 1) * cs * cs + 1 < 2**31:
        diag_dest = diag_dest.astype(np.int32)
    if (T + 1) * cs * cs + 1 < 2**31:
        offdiag_dest = offdiag_dest.astype(np.int32)

    tile_brow = np.concatenate([ub, [K]]).astype(np.int32)
    tile_bcol = np.concatenate([uc, [K]]).astype(np.int32)

    # --- level schedule over the chunk DAG ---------------------------------
    # deps[k] = {bcol of tiles with brow == k} for lower (sources solved
    # earlier); for upper, same formula (sources have larger index) but the
    # longest-path recurrence walks chunks in reverse. uniq_keys is sorted
    # by brow, so per-chunk dep lists are contiguous runs.
    level = _level_schedule(ub, uc, K, lower)
    NL = int(level.max()) + 1 if K else 1

    chunks_at = [np.nonzero(level == l)[0] for l in range(NL)]
    # tiles grouped by the level of their *source* chunk (push-style: a
    # chunk's outgoing updates apply right after its tri-solve, the
    # reference's gemm step, src:362-363, batched per level).
    src_level = level[uc] if T else np.zeros(0, dtype=np.int64)
    tiles_at = [np.nonzero(src_level == l)[0] for l in range(NL)]

    MC = max((len(c) for c in chunks_at), default=1) or 1
    MT = max((len(t) for t in tiles_at), default=1) or 1
    level_chunks = np.full((NL, MC), K, dtype=np.int32)
    level_tiles = np.full((NL, MT), T, dtype=np.int32)
    for l in range(NL):
        level_chunks[l, : len(chunks_at[l])] = chunks_at[l]
        level_tiles[l, : len(tiles_at[l])] = tiles_at[l]
    level_chunk_counts = np.array([len(c) for c in chunks_at], dtype=np.int32)
    level_tile_counts = np.array([len(t) for t in tiles_at], dtype=np.int32)

    # --- padding identity for diagonal tiles --------------------------------
    tail = n % cs
    pads = []
    if tail:
        idx = np.arange(tail, cs, dtype=np.int64)
        pads.append(((K - 1) * cs + idx) * cs + idx)
    idx = np.arange(cs, dtype=np.int64)
    pads.append((np.int64(K) * cs + idx) * cs + idx)  # dummy tile = I
    pad_idx = np.concatenate(pads)

    return TriPlan(
        n=n,
        cs=cs,
        K=K,
        T=T,
        lower=lower,
        tile_brow=tile_brow,
        tile_bcol=tile_bcol,
        level_chunks=level_chunks,
        level_tiles=level_tiles,
        diag_dest=diag_dest,
        offdiag_dest=offdiag_dest,
        pad_idx=pad_idx,
        level_chunk_counts=level_chunk_counts,
        level_tile_counts=level_tile_counts,
    )


# ---------------------------------------------------------------------------
# Whole-solve symbolic plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SymbolicPlan:
    """Everything static needed to run pack + ldiv on device.

    The analogue of keeping the UMFPACK object alive for reuse
    (src:53-54, :247).
    """

    n: int
    cs: int
    lplan: TriPlan
    uplan: TriPlan
    # permutation/scaling prep for ldiv (src:324-339):
    # wrk = (Rs * b)[p]  -> gather index p, premultiplied scale Rs[p]
    p: np.ndarray
    q: np.ndarray
    Rs: np.ndarray
    qinv: np.ndarray  # x = wrk[qinv], qinv = argsort(q)

    def arrays(self, top: str = "") -> dict:
        """The plan as ``np.savez`` entries: ``n, cs, p, q, Rs, qinv``
        (each behind the prefix ``top``) and ``l_*``/``u_*``, one per
        field of each factor's :class:`TriPlan`."""
        flat = dataclass_arrays(self, top, skip=("lplan", "uplan"))
        flat.update(dataclass_arrays(self.lplan, "l_"))
        flat.update(dataclass_arrays(self.uplan, "u_"))
        return flat

    @classmethod
    def from_arrays(cls, z: Mapping, top: str = "") -> "SymbolicPlan":
        """The inverse of :meth:`arrays` on any mapping of arrays (an
        ``np.load`` of a file)."""
        return dataclass_from_arrays(
            cls, z, top, lplan=dataclass_from_arrays(TriPlan, z, "l_"),
            uplan=dataclass_from_arrays(TriPlan, z, "u_"))

    def save(self, path) -> None:
        """Write the plan to ``path`` (compressed ``.npz``), in the JAX
        package's format (``tpu_sparse_lu/symbolic.py:434-445``)."""
        np.savez_compressed(path, **self.arrays())

    @classmethod
    def load(cls, path) -> "SymbolicPlan":
        """Read a plan :meth:`save` (or the JAX package's) wrote."""
        with np.load(path) as z:
            return cls.from_arrays(z)


def dataclass_arrays(obj, prefix: str, skip=()) -> dict:
    """The fields of a dataclass of NumPy arrays and scalars as
    ``np.savez`` entries named ``prefix + field``; the arrays keep their
    dtypes (int32 and int64 alike)."""
    return {prefix + f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def dataclass_from_arrays(cls, z: Mapping, prefix: str, **given):
    """The inverse of :func:`dataclass_arrays`: ``cls`` from the entries
    ``prefix + field`` of ``z``, except the fields ``given``. A 0-d entry
    comes back as the Python scalar of its value (an int, a bool, a
    float), whatever the field's annotation says; every other entry as
    the array that was saved."""
    kw = dict(given)
    for f in dataclasses.fields(cls):
        if f.name not in kw:
            v = np.asarray(z[prefix + f.name])
            kw[f.name] = v.item() if v.ndim == 0 else v
    return cls(**kw)


def build_symbolic_plan(factors: HostFactors, cs: int) -> SymbolicPlan:
    lplan = plan_triangular(factors.L, cs, lower=True)
    uplan = plan_triangular(factors.U, cs, lower=False)
    return SymbolicPlan(
        n=factors.n,
        cs=lplan.cs,
        lplan=lplan,
        uplan=uplan,
        p=factors.p.astype(np.int32),
        q=factors.q.astype(np.int32),
        Rs=factors.Rs,
        qinv=np.argsort(factors.q).astype(np.int32),
    )
