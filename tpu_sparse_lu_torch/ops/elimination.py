"""The blocked elimination (B3): counterpart of
``tpu_sparse_lu/ops/pallas_elim.py`` and ``refactor._blocked_elimination``.

Right-looking blocked LU without pivoting over the merged tile store,
one dependency level at a time. The TPU kernel keeps the whole store in
VMEM across a sequential grid; on the H100 the store lives in device
memory and each level is up to four launches:

1. :func:`~tpu_sparse_lu_torch.ops.lu_tile.lu_tile` on the level's
   diagonal tiles, which also writes their ``L⁻¹`` and ``U⁻¹`` into the
   per-level inverse stacks;
2. :func:`tile_mm` row panels ``A_ik ← A_ik · U_kk⁻¹``;
3. :func:`tile_mm` column panels ``A_kj ← L_kk⁻¹ · A_kj``;
4. :func:`tile_mm` Schur updates ``A_ij ← A_ij − Σ L_ik · U_kj``, one group
   per destination tile (``RefactorPlan.schur_groups``), so no two blocks
   write one tile.

The padded slots of the JAX schedules are skipped, so the dummy tile is
never read or written. :func:`tile_mm` launches ``csrc/elim.cu`` on a CUDA
tensor and runs :func:`tile_mm_plain` (``bmm`` and ``index_add_``) on a
CPU tensor; ``tile_mm.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from ._launch import KERNEL_DTYPES, check, device_kind, lib, require, stream
from .lu_tile import lu_tile, lu_tile_plain

__all__ = [
    "TileGroups",
    "make_groups",
    "ElimLevel",
    "ElimSchedule",
    "build_elim_schedule",
    "TILE_SHAPES",
    "pick_tile",
    "tile_mm",
    "tile_mm_plain",
    "eliminate",
]


@dataclasses.dataclass
class TileGroups:
    """Tile products grouped by destination (CSR), like ``Wave``.

    Group ``d`` writes tile ``dst[d]`` from the entries ``ptr[d]:ptr[d+1]``,
    each the product ``a[a_idx[e]] @ b[b_idx[e]]``; ``ent_row[e]`` is the
    entry's group. All int32 on one device. ``out_tiles``, ``a_tiles`` and
    ``b_tiles`` (one past the largest index of each kind) are found on the
    host when the groups are made, so a launch checks its operands without
    reading the device; so are ``dst_in_a`` and ``dst_in_b``, whether some
    destination index is also an ``a`` (``b``) index of the launch.
    """

    dst: torch.Tensor
    ptr: torch.Tensor
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    ent_row: torch.Tensor
    out_tiles: int
    a_tiles: int
    b_tiles: int
    dst_in_a: bool
    dst_in_b: bool


def make_groups(dst, groups, device) -> TileGroups:
    """:class:`TileGroups` from destination tiles ``dst`` and, for each,
    its list of ``(a, b)`` operand indices."""
    dst = np.asarray(dst, dtype=np.int64)
    if len(groups) != len(dst) or any(len(g) == 0 for g in groups):
        raise ValueError("every destination needs at least one entry")
    if len(np.unique(dst)) != len(dst):
        raise ValueError("a destination tile appears in two groups")
    ptr = np.zeros(len(dst) + 1, dtype=np.int64)
    ptr[1:] = np.cumsum([len(g) for g in groups])
    a = np.asarray([x for g in groups for x, _ in g], dtype=np.int64)
    b = np.asarray([y for g in groups for _, y in g], dtype=np.int64)
    if min(dst.min(initial=0), a.min(initial=0), b.min(initial=0)) < 0:
        raise ValueError("negative tile index in a group")

    def as_t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)

    return TileGroups(
        dst=as_t(dst), ptr=as_t(ptr), a_idx=as_t(a), b_idx=as_t(b),
        ent_row=as_t(np.repeat(np.arange(len(dst)), np.diff(ptr))),
        out_tiles=int(dst.max(initial=-1)) + 1,
        a_tiles=int(a.max(initial=-1)) + 1,
        b_tiles=int(b.max(initial=-1)) + 1,
        dst_in_a=bool(np.isin(dst, a).any()),
        dst_in_b=bool(np.isin(dst, b).any()),
    )


@dataclasses.dataclass
class ElimLevel:
    """One elimination level: its diagonal tiles (``diag``, int32, the
    tiles' slots in the inverse stacks start at ``slot0``) and its three
    products (``None`` when empty)."""

    diag: torch.Tensor
    slot0: int
    rows: Optional[TileGroups]
    cols: Optional[TileGroups]
    schur: Optional[TileGroups]


@dataclasses.dataclass
class ElimSchedule:
    """Device schedule of the whole elimination; ``n_diag`` is the number
    of real diagonal tiles (the chunk count K)."""

    cs: int
    NL: int
    BL: int
    n_diag: int
    n_tiles: int  # the store's tile count, TF + 2
    levels: List[ElimLevel]


def build_elim_schedule(rp, device) -> ElimSchedule:
    """The per-level launches of a ``refactor.RefactorPlan``, padded slots
    dropped, uploaded once."""
    TF, BL = rp.TF, rp.diag_ids.shape[1]
    levels = []
    for l in range(rp.NL):
        cnt = int(rp.diag_cnt[l])
        slot0 = l * BL
        rr = rp.row_ids[l][rp.row_ids[l] != TF]
        ro = rp.row_owner[l][: len(rr)]
        cc = rp.col_ids[l][rp.col_ids[l] != TF]
        co = rp.col_owner[l][: len(cc)]
        rows = cols = schur = None
        if len(rr):
            # A_ik <- A_ik . Uinv[slot]: a = store, b = U inverse stack
            rows = make_groups(rr, [[(i, slot0 + o)] for i, o in zip(rr, ro)],
                               device)
        if len(cc):
            # A_kj <- Linv[slot] . A_kj: a = L inverse stack, b = store
            cols = make_groups(cc, [[(slot0 + o, j)] for j, o in zip(cc, co)],
                               device)
        dst, ptr, lt, ut = rp.schur_groups[l]
        if len(dst):
            schur = make_groups(
                dst, [list(zip(lt[ptr[d]:ptr[d + 1]], ut[ptr[d]:ptr[d + 1]]))
                      for d in range(len(dst))], device)
        levels.append(ElimLevel(
            diag=torch.as_tensor(rp.diag_ids[l, :cnt].astype(np.int32),
                                 device=device),
            slot0=slot0, rows=rows, cols=cols, schur=schur))
    return ElimSchedule(cs=rp.cs, NL=rp.NL, BL=BL,
                        n_diag=int(rp.diag_cnt.sum()), n_tiles=TF + 2,
                        levels=levels)


# ---------------------------------------------------------------------------
# tile_mm
# ---------------------------------------------------------------------------


def tile_mm_plain(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  groups: TileGroups, *, side: str,
                  subtract: bool) -> torch.Tensor:
    """:func:`tile_mm` with ``bmm`` and ``index_add_``."""
    del side  # a kernel layout choice; the plain version reads whole tiles
    prod = torch.bmm(a[groups.a_idx], b[groups.b_idx])
    acc = torch.zeros((groups.dst.shape[0],) + tuple(out.shape[1:]),
                      dtype=out.dtype, device=out.device)
    acc.index_add_(0, groups.ent_row, prod)
    out[groups.dst] = out[groups.dst] - acc if subtract else acc
    return out


# The sub-tiles (rows, cols) of a destination that one block of the
# kernel computes, largest first, by what a block must own: "rows" when a
# destination is its own ``a`` operand (a row panel), "cols" when it is
# its own ``b`` (a column panel), None when no destination is an operand
# (Schur). Each thread holds (rows / 16) x (cols / 16) of the sub-tile.
TILE_SHAPES = {
    "rows": ((64, 128), (32, 128), (16, 128)),
    "cols": ((128, 64), (128, 32), (128, 16)),
    None: ((64, 128), (64, 64), (32, 64), (32, 32)),
}
_SIDE_CODE = {"rows": 0, "cols": 1, None: 2}


@functools.lru_cache(maxsize=None)
def pick_tile(n_groups: int, cs: int, owner: Optional[str], n_sm: int):
    """The largest sub-tile of ``TILE_SHAPES[owner]`` that gives the
    launch at least one block per SM, else the smallest: a launch of one
    product still spreads over ≥ 8 blocks at cs = 128."""
    shapes = TILE_SHAPES[owner]
    for bm, bn in shapes:
        if n_groups * (-(-cs // bm)) * (-(-cs // bn)) >= n_sm:
            return bm, bn
    return shapes[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _same_storage(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()


def tile_mm(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            groups: TileGroups, *, side: str, subtract: bool) -> torch.Tensor:
    """``out[dst[d]] = (out[dst[d]] −)? Σ_e a[a_idx[e]] @ b[b_idx[e]]`` for
    every group ``d``, in place; returns ``out``.

    ``out``, ``a``, ``b`` contiguous ``(·, cs, cs)`` tile banks of one
    dtype; ``a`` or ``b`` may be ``out`` itself. ``side="row"`` lets a
    group's output tile be its own ``a`` operand (a block then owns whole
    rows), ``side="col"`` its own ``b`` operand (whole columns); otherwise
    no destination may be an operand of the launch, and a block may own
    any sub-tile (:func:`pick_tile`).
    """
    require(side in ("row", "col"), f"side must be 'row' or 'col', "
                                    f"got {side!r}")
    require(groups.out_tiles <= out.shape[0]
            and groups.a_tiles <= a.shape[0]
            and groups.b_tiles <= b.shape[0],
            "tile groups index past a tile bank")
    kind = device_kind(out, a, b, groups.dst)
    in_a = groups.dst_in_a and _same_storage(a, out)
    in_b = groups.dst_in_b and _same_storage(b, out)
    require(not (in_b if side == "row" else in_a),
            f"side={side!r}: a destination is the launch's "
            f"{'b' if side == 'row' else 'a'} operand")
    if kind == "cpu":
        return tile_mm_plain(out, a, b, groups, side=side, subtract=subtract)
    require(out.dtype in KERNEL_DTYPES and a.dtype == out.dtype
            and b.dtype == out.dtype,
            f"unsupported dtypes {out.dtype}/{a.dtype}/{b.dtype}")
    cs = out.shape[1]
    for t in (out, a, b):
        require(t.dim() == 3 and t.shape[1:] == (cs, cs)
                and t.is_contiguous(),
                "tile banks must be contiguous (N, cs, cs)")
    L = lib()
    require(cs <= L.max_chunk,
            f"the CUDA tile_mm kernel takes cs <= {L.max_chunk}, got {cs}")
    owner = "rows" if in_a else "cols" if in_b else None
    n = groups.dst.shape[0]
    bm, bn = pick_tile(n, cs, owner, _sm_count(out.device.index))
    fn = getattr(L, f"tile_mm_{KERNEL_DTYPES[out.dtype]}")
    rc = fn(out.data_ptr(), a.data_ptr(), b.data_ptr(), groups.dst.data_ptr(),
            groups.ptr.data_ptr(), groups.a_idx.data_ptr(),
            groups.b_idx.data_ptr(), n, cs, _SIDE_CODE[owner], int(subtract),
            bm, bn, stream(out))
    check(rc, "tile_mm")
    tile_mm.LAUNCHES += 1
    return out


tile_mm.LAUNCHES = 0


# ---------------------------------------------------------------------------
# the whole elimination
# ---------------------------------------------------------------------------


def eliminate(store: torch.Tensor, sched: ElimSchedule, *,
              plain: bool = False):
    """Blocked LU of the merged store ``(TF+2, cs, cs)``, in place.

    Returns ``(store, min_piv, linv, uinv)``: ``min_piv`` the smallest
    |pivot| over the real diagonal tiles (a 0-d tensor, not synced), and
    the per-level inverse stacks ``(NL, BL, cs, cs)`` whose padded slots
    are zero. ``plain=True`` runs the plain PyTorch version of every
    kernel on any device; on a CPU tensor the wrappers do so anyway.
    """
    cs, NL, BL = sched.cs, sched.NL, sched.BL
    require(store.shape == (sched.n_tiles, cs, cs),
            f"store {tuple(store.shape)} does not match the schedule "
            f"({sched.n_tiles}, {cs}, {cs})")
    lu = lu_tile_plain if plain else lu_tile
    mm = tile_mm_plain if plain else tile_mm
    linv = torch.zeros((NL * BL, cs, cs), dtype=store.dtype,
                       device=store.device)
    uinv = torch.zeros_like(linv)
    piv = torch.full((max(sched.n_diag, 1),), float("inf"),
                     dtype=store.dtype, device=store.device)
    off = 0
    for lvl in sched.levels:
        n = lvl.diag.shape[0]
        s = slice(lvl.slot0, lvl.slot0 + n)
        lu(store, lvl.diag, piv=piv[off:off + n], linv=linv[s], uinv=uinv[s])
        off += n
        if lvl.rows is not None:
            mm(store, store, uinv, lvl.rows, side="row", subtract=False)
        if lvl.cols is not None:
            mm(store, linv, store, lvl.cols, side="col", subtract=False)
        if lvl.schur is not None:
            mm(store, store, store, lvl.schur, side="row", subtract=True)
    # NaN-propagating min, as the JAX package's jnp.min
    min_piv = piv.amin()
    return (store, min_piv, linv.view(NL, BL, cs, cs),
            uinv.view(NL, BL, cs, cs))
