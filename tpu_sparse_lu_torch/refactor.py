"""Device-side same-pattern numeric refactorization (static pivots):
counterpart of ``tpu_sparse_lu/refactor.py``.

The reference's ``lu!(F, A)`` re-runs UMFPACK's numeric phase on its
symbolic analysis (reference src/SharedMemSparseLU.jl:245-279). Here the
whole numeric phase runs on the solver's device:

* Host, once: the pivot order ``p, q`` of the first factorization is
  frozen; the tile pattern of ``(Rs·A)[p, q]`` is closed under blocked
  elimination (:func:`blocked_fill`) and every per-level tile list
  (diagonal tiles, row panels, column panels, Schur updates) is planned
  (:func:`build_refactor_plan`), together with the assembly
  (``assemble.plan_assembly``). The solve plans are rebuilt on the same
  closure (:func:`closure_solve_plans`), so the eliminated tiles feed the
  solve directly.
* Device, every refactorization (:func:`refactor_pipeline`): assemble the
  store with the assembly kernels (B4), eliminate in one launch (B3,
  ``ops/elim_fused.py``: the tile LU of B2 and the tile products as its
  tasks), then extract the solve banks — reusing the diagonal inverses
  the elimination computed — with no host synchronisation.

No numerical pivoting happens here (the point of the static-pivot
design). ``refactor_same_pattern(check=True)`` detects value changes that
broke the frozen pivots and falls back to the host ``refactor``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .assemble import (
    AssemblyPlan,
    assemble,
    assembly_device_arrays,
    plan_assembly,
)
from .ops.elimination import ElimSchedule, build_elim_schedule, eliminate
from .symbolic import (
    TriPlan,
    dataclass_arrays,
    dataclass_from_arrays,
    plan_triangular,
)
from .utils import _symcore_build

__all__ = [
    "blocked_fill",
    "RefactorPlan",
    "build_refactor_plan",
    "closure_solve_plans",
    "RefactorDevice",
    "upload_refactor_plan",
    "refactor_pipeline",
    "refactor_numeric_values",
    "refactor_same_pattern",
]


# ---------------------------------------------------------------------------
# Host-side symbolic closure + schedule
# ---------------------------------------------------------------------------


def blocked_fill(tiles: set, K: int) -> set:
    """Close a tile pattern under blocked elimination:
    (i,k) and (k,j) present with i,j > k  ⇒  (i,j) present.
    Also guarantees every diagonal tile. Uses the native core when it
    built (``utils/_symcore_build.native``, as the JAX package's
    ``_symcore``), else the Python closure below; both give the same set.
    """
    core = _symcore_build.native()
    if core is not None:
        if tiles:
            br, bc = map(np.asarray, zip(*tiles))
        else:
            br = bc = np.zeros(0, dtype=np.int64)
        r, c = core.blocked_fill(br, bc, K)
        return set(zip(r.tolist(), c.tolist()))
    S = set(tiles)
    for k in range(K):
        S.add((k, k))
    # per-step adjacency so each step is O(|rows_k| * |cols_k|), not O(|S|)
    col_of = [[] for _ in range(K)]
    row_of = [[] for _ in range(K)]
    for (i, j) in S:
        if i > j:
            col_of[j].append(i)
        elif i < j:
            row_of[i].append(j)
    for k in range(K):
        rows = list(col_of[k])
        cols = list(row_of[k])
        for i in rows:
            for j in cols:
                if (i, j) not in S:
                    S.add((i, j))
                    if i > j:
                        col_of[j].append(i)
                    else:
                        row_of[i].append(j)
    return S


@dataclasses.dataclass
class RefactorPlan:
    """Static schedule of the device refactorization.

    Elimination steps are grouped by LEVEL of the (symmetric) closure
    dependency DAG: chunks of one level share no closure tile, so their
    diagonal LUs, panels and Schur updates each run batched. The padded
    ``(NL, ·)`` arrays equal the JAX package's (padding = dummy tile id
    ``TF``, owner slot ``BL``); the device schedule skips the padding.
    """

    n: int
    cs: int
    K: int
    NL: int  # elimination levels
    TF: int  # number of merged fill tiles (dummy id = TF)
    diag_ids: np.ndarray     # (NL, BL) merged ids of the level's diag tiles
    diag_cnt: np.ndarray     # (NL,) real diag count per level
    row_ids: np.ndarray      # (NL, MR) merged ids of L-panel tiles (i, k)
    row_owner: np.ndarray    # (NL, MR) slot of k in the level's diag batch
    col_ids: np.ndarray      # (NL, MU) merged ids of U-panel tiles (k, j)
    col_owner: np.ndarray    # (NL, MU)
    schur: np.ndarray        # (NL, MS, 3) (dst, l_tile, u_tile) merged ids
    asm: AssemblyPlan
    # extraction maps into the solve plans (built on the same closure)
    l_off_src: np.ndarray    # (TL+1,) merged id per L-solve offdiag tile
    u_off_src: np.ndarray    # (TU+1,) merged id per U-solve offdiag tile
    diag_src: np.ndarray     # (K+1,) merged id per chunk's diagonal tile
    # (K+1,) flattened (level*BL + slot) of each chunk's diag in the
    # elimination schedule; entry K = NL*BL (identity pad)
    diag_lvlslot: np.ndarray
    # per level, the real Schur entries grouped by destination tile (CSR):
    # (dst (G,), ptr (G+1,), l_tile (E,), u_tile (E,)), entries of one
    # destination in schedule order. One group per destination lets one
    # block own each destination tile: no atomics, a fixed summation order.
    schur_groups: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]

    def arrays(self) -> dict:
        """The plan as ``np.savez`` entries: ``rp_*`` its own fields,
        ``asm_*`` the assembly's, and ``sg_*`` the Schur groups, each of
        the four per-level CSR arrays concatenated over the levels with
        its offsets (``sg_<name>_off``, NL+1)."""
        flat = dataclass_arrays(self, "rp_", skip=("asm", "schur_groups"))
        flat.update(dataclass_arrays(self.asm, "asm_"))
        for j, name in enumerate(_SCHUR_GROUP_FIELDS):
            parts = [g[j] for g in self.schur_groups]
            flat[f"sg_{name}"] = np.concatenate(parts)
            flat[f"sg_{name}_off"] = np.cumsum([0] + [len(a) for a in parts])
        return flat

    @classmethod
    def from_arrays(cls, z: Mapping) -> "RefactorPlan":
        """The inverse of :meth:`arrays` on any mapping of arrays (an
        ``np.load`` of a light save)."""
        cols = []
        for name in _SCHUR_GROUP_FIELDS:
            flat, off = z[f"sg_{name}"], z[f"sg_{name}_off"]
            cols.append([flat[off[l]:off[l + 1]]
                         for l in range(len(off) - 1)])
        return dataclass_from_arrays(
            cls, z, "rp_", asm=dataclass_from_arrays(AssemblyPlan, z, "asm_"),
            schur_groups=list(zip(*cols)))


_SCHUR_GROUP_FIELDS = ("dst", "ptr", "l_tile", "u_tile")


def _tile_pattern_of_permuted(
    A: sp.csc_matrix, p: np.ndarray, q: np.ndarray, cs: int
) -> Tuple[set, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile pattern of B = A[p][:, q] plus per-nonzero block coordinates."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    pinv = np.argsort(p)
    qinv = np.argsort(q)
    rows = A.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    bi = pinv[rows]  # row in B
    bj = qinv[cols]  # col in B
    ti = bi // cs
    tj = bj // cs
    tiles = set(zip(ti.tolist(), tj.tolist()))
    return tiles, bi, bj, rows, cols


def _group_schur(schur_l: np.ndarray, TF: int):
    """One level's real Schur entries grouped by destination (CSR)."""
    real = schur_l[:, 0] != TF
    ent = schur_l[real].astype(np.int64)
    order = np.argsort(ent[:, 0], kind="stable")
    ent = ent[order]
    dst, counts = np.unique(ent[:, 0], return_counts=True)
    ptr = np.zeros(len(dst) + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(counts)
    return (dst.astype(np.int32), ptr, ent[:, 1].astype(np.int32),
            ent[:, 2].astype(np.int32))


def build_refactor_plan(
    A_pattern: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
    solve_lplan: TriPlan,
    solve_uplan: TriPlan,
    data_src: np.ndarray | None = None,
) -> RefactorPlan:
    """Build the static refactorization schedule.

    ``solve_lplan``/``solve_uplan`` must have been planned on the *same*
    closure pattern (see :func:`closure_solve_plans`), so extraction maps
    line up tile-for-tile.
    """
    n = A_pattern.shape[0]
    K = -(-n // cs)
    tiles, _, _, _, _ = _tile_pattern_of_permuted(A_pattern, p, q, cs)
    S = blocked_fill(tiles, K)

    order = sorted(S)
    tile_id: Dict[Tuple[int, int], int] = {t: i for i, t in enumerate(order)}
    TF = len(order)

    rows_at = [[] for _ in range(K)]  # (i, k), i > k
    cols_at = [[] for _ in range(K)]  # (k, j), j > k
    for (i, j) in order:
        if i > j:
            rows_at[j].append(i)
        elif i < j:
            cols_at[i].append(j)

    # elimination levels: longest path over the symmetric closure deps;
    # all edges point from smaller to larger chunk index
    level = np.zeros(K, dtype=np.int64)
    for c in range(K):
        for i in rows_at[c]:
            level[i] = max(level[i], level[c] + 1)
        for j in cols_at[c]:
            level[j] = max(level[j], level[c] + 1)
    NL = int(level.max()) + 1 if K else 1
    chunks_at = [np.nonzero(level == l)[0] for l in range(NL)]
    BL = max((len(c) for c in chunks_at), default=1) or 1

    diag_ids = np.full((NL, BL), TF, dtype=np.int32)
    diag_cnt = np.zeros(NL, dtype=np.int32)
    slot_of = np.zeros(K, dtype=np.int64)
    for l in range(NL):
        for a, k in enumerate(chunks_at[l]):
            diag_ids[l, a] = tile_id[(int(k), int(k))]
            slot_of[k] = a
        diag_cnt[l] = len(chunks_at[l])

    MR = max(
        (sum(len(rows_at[k]) for k in chunks_at[l]) for l in range(NL)),
        default=1,
    ) or 1
    MU = max(
        (sum(len(cols_at[k]) for k in chunks_at[l]) for l in range(NL)),
        default=1,
    ) or 1
    MS = max(
        (sum(len(rows_at[k]) * len(cols_at[k]) for k in chunks_at[l])
         for l in range(NL)),
        default=1,
    ) or 1
    row_ids = np.full((NL, MR), TF, dtype=np.int32)
    row_owner = np.full((NL, MR), BL, dtype=np.int32)  # BL = identity slot
    col_ids = np.full((NL, MU), TF, dtype=np.int32)
    col_owner = np.full((NL, MU), BL, dtype=np.int32)
    schur = np.full((NL, MS, 3), TF, dtype=np.int32)
    for l in range(NL):
        a = b = s = 0
        for k in chunks_at[l]:
            for i in rows_at[k]:
                row_ids[l, a] = tile_id[(i, int(k))]
                row_owner[l, a] = slot_of[k]
                a += 1
            for j in cols_at[k]:
                col_ids[l, b] = tile_id[(int(k), j)]
                col_owner[l, b] = slot_of[k]
                b += 1
            for i in rows_at[k]:
                for j in cols_at[k]:
                    schur[l, s] = (
                        tile_id[(i, j)],
                        tile_id[(i, int(k))],
                        tile_id[(int(k), j)],
                    )
                    s += 1

    # identity pads: tail rows of the last chunk + dummy-tile diagonal, as
    # flat positions in the final permuted store
    pads = []
    tail = n % cs
    if tail:
        kd = tile_id[(K - 1, K - 1)]
        idx = np.arange(tail, cs, dtype=np.int64)
        pads.append((np.int64(kd) * cs + idx) * cs + idx)
    idx = np.arange(cs, dtype=np.int64)
    pads.append((np.int64(TF) * cs + idx) * cs + idx)
    asm = plan_assembly(
        A_pattern, p, q, cs, order, TF, np.concatenate(pads),
        data_src=data_src,
    )

    def off_src(plan: TriPlan) -> np.ndarray:
        src = np.full(plan.T + 1, TF, dtype=np.int32)
        for t in range(plan.T):
            src[t] = tile_id[(int(plan.tile_brow[t]), int(plan.tile_bcol[t]))]
        return src

    diag_src = np.array(
        [tile_id[(k, k)] for k in range(K)] + [TF], dtype=np.int32
    )
    diag_lvlslot = np.array(
        [int(level[k]) * BL + int(slot_of[k]) for k in range(K)] + [NL * BL],
        dtype=np.int32,
    )
    return RefactorPlan(
        n=n, cs=cs, K=K, NL=NL, TF=TF,
        diag_ids=diag_ids, diag_cnt=diag_cnt,
        row_ids=row_ids, row_owner=row_owner,
        col_ids=col_ids, col_owner=col_owner,
        schur=schur, asm=asm,
        l_off_src=off_src(solve_lplan), u_off_src=off_src(solve_uplan),
        diag_src=diag_src, diag_lvlslot=diag_lvlslot,
        schur_groups=[_group_schur(schur[l], TF) for l in range(NL)],
    )


def closure_solve_plans(
    A_pattern: sp.csc_matrix,
    factors_L: sp.csc_matrix,
    factors_U: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
) -> Tuple[TriPlan, TriPlan]:
    """Solve plans whose tile sets are the blocked closure of the permuted
    input pattern — a superset of the factors' own tile patterns, so both
    the host pack path and the device refactor path feed the same plans."""
    n = A_pattern.shape[0]
    K = -(-n // cs)
    tiles, _, _, _, _ = _tile_pattern_of_permuted(A_pattern, p, q, cs)
    S = blocked_fill(tiles, K)
    extra_lower = [(i, j) for (i, j) in S if i > j]
    extra_upper = [(i, j) for (i, j) in S if i < j]
    lplan = plan_triangular(factors_L, cs, lower=True, extra_tiles=extra_lower)
    uplan = plan_triangular(factors_U, cs, lower=False, extra_tiles=extra_upper)
    return lplan, uplan


# ---------------------------------------------------------------------------
# Device-side numeric phase
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RefactorDevice:
    """A :class:`RefactorPlan`'s device-resident schedule, uploaded once."""

    n: int
    cs: int
    TF: int
    TF2: int
    asm: dict            # assembly index tensors
    elim: ElimSchedule
    diag_src: torch.Tensor
    l_off_src: torch.Tensor
    u_off_src: torch.Tensor
    diag_lvlslot: torch.Tensor


def upload_refactor_plan(rp: RefactorPlan, device) -> RefactorDevice:
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    return RefactorDevice(
        n=rp.n, cs=rp.cs, TF=rp.TF, TF2=rp.asm.TF2,
        asm=assembly_device_arrays(rp.asm, rp.cs, rp.TF, device),
        elim=build_elim_schedule(rp, device),
        diag_src=t(rp.diag_src[: rp.K]),
        l_off_src=t(rp.l_off_src[:-1]),
        u_off_src=t(rp.u_off_src[:-1]),
        diag_lvlslot=t(rp.diag_lvlslot[: rp.K]),
    )


def _bank(dinv_real: torch.Tensor, off_real: torch.Tensor) -> torch.Tensor:
    """The solve's transposed tile bank ``[diag_inv (K+1); −offdiag (T+1)]``
    from the real tiles, with the dummy slots scrubbed to identity / zero
    (the elimination never writes the dummy tile, but the solve bank's
    layout has one slot of each kind)."""
    cs = dinv_real.shape[-1]
    eye = torch.eye(cs, dtype=dinv_real.dtype, device=dinv_real.device)[None]
    zero = torch.zeros_like(eye)
    return torch.cat([dinv_real, eye, -off_real, zero]).transpose(1, 2) \
        .contiguous()


def refactor_pipeline(a_data: torch.Tensor, dev: RefactorDevice, *,
                      plain: bool = False) -> dict:
    """The whole numeric refactorization: assemble → blocked elimination →
    solve-bank extraction, reusing the elimination's diagonal inverses.
    Returns device tensors only (no host synchronisation):

    ``lbank``/``ubank`` (the solve banks), ``ldiag``/``udiag``
    ``(K+1, cs, cs)`` (the diagonal tiles, identity at K), ``rs`` (length
    n, factor row order), ``min_pivot`` and ``growth`` (0-d).

    ``plain=True`` runs the plain PyTorch version of every kernel.
    """
    cs = dev.cs
    store, rs = assemble(a_data, dev.asm, n=dev.n, cs=cs, TF=dev.TF,
                         TF2=dev.TF2, plain=plain)
    store, min_piv, linv, uinv = eliminate(store, dev.elim, plain=plain)
    eye = torch.eye(cs, dtype=store.dtype, device=store.device)
    diag = store[dev.diag_src]
    ldiag = torch.cat([torch.tril(diag, -1) + eye, eye[None]])
    udiag = torch.cat([torch.triu(diag), eye[None]])
    loff = store[dev.l_off_src]
    uoff = store[dev.u_off_src]
    # pivot growth: rows of (Rs·A)[p,q] have max |entry| == 1 after the
    # equilibration, so max |factor entry| is the growth factor
    parts = [udiag.abs().amax()]
    parts += [t.abs().amax() for t in (loff, uoff) if t.numel()]
    growth = torch.stack(parts).amax()
    ls = dev.diag_lvlslot
    lbank = _bank(linv.reshape(-1, cs, cs)[ls], loff)
    ubank = _bank(uinv.reshape(-1, cs, cs)[ls], uoff)
    return {"lbank": lbank, "ubank": ubank, "ldiag": ldiag, "udiag": udiag,
            "rs": rs, "min_pivot": min_piv, "growth": growth}


def refactor_numeric_values(F, a_data: torch.Tensor, *,
                            plain: bool = False) -> None:
    """Refactorize from new nonzero values of A (a tensor on F's device,
    original CSC order, float64 or F's dtype). Updates F's device solve
    state in place without synchronising the device."""
    from .solve import tri_kernel_from_bank

    out = refactor_pipeline(a_data.to(F.dtype), F._refactor_dev,
                            plain=plain)
    F.ldata = tri_kernel_from_bank(F.ldata, out["lbank"], out["ldiag"])
    F.udata = tri_kernel_from_bank(F.udata, out["ubank"], out["udiag"])
    # new numeric state: a make_f64_ldiv callable made before is stale
    F._generation += 1
    # the host csc factor values (F.L/F.U) materialize lazily from these
    F._factors_stale = True
    # the chain path (api._prepare_scan_path) holds factor values from the
    # last re-pack: stale now, so the tile solve serves until the next one
    F._scan_bands = F._scan_planes = None
    F._scan_perm_id = False
    F.refactor_diagnostics = {"min_pivot": out["min_pivot"],
                              "growth": out["growth"]}
    rs = out["rs"]
    # Rs in input row order: the perm-in scales before it permutes
    F._rs = rs if F._ext is None else rs[F._ext_pos_dev]
    F._factors.Rs = rs  # converted to NumPy when F.Rs is read
    F._set_matrix_values(a_data)


def refactor_same_pattern(F, A: sp.csc_matrix, *, check: bool = False,
                          growth_limit: float = 1e7,
                          plain: bool = False) -> bool:
    """Entry point of :meth:`ParallelSparseLU.refactor_numeric`.

    With ``check=True`` the static-pivot diagnostics (min |pivot|, pivot
    growth) are synced after the device refactorization; if the new values
    broke the frozen pivot order (non-finite growth, growth beyond
    ``growth_limit``, or a zero pivot) it falls back to the host
    ``refactor``, which re-pivots. Returns True when the device
    factorization was kept."""
    A = sp.csc_matrix(A)
    A.sort_indices()
    if (A.indptr.tobytes(), A.indices.tobytes()) != F._a_pattern_sig:
        raise ValueError(
            "refactor_numeric requires the same sparsity pattern as the "
            "matrix this factorization was built from; use refactor() for "
            "pattern changes (reference src:265-273 reallocate path)"
        )
    if not F.has_device_refactor:
        F.enable_device_refactor()
    # the nd value mapping is folded into the assembly plan (data_src), so
    # the original values go straight in (in float64: F keeps them for
    # make_f64_ldiv's residual)
    a_data = torch.as_tensor(A.data, dtype=torch.float64, device=F.device)
    refactor_numeric_values(F, a_data, plain=plain)
    if check:
        d = F.refactor_diagnostics
        growth = float(d["growth"])
        min_piv = float(d["min_pivot"])
        if not np.isfinite(growth) or growth > growth_limit or min_piv == 0.0:
            F.refactor(A)  # host path: re-pivots
            return False
    return True
