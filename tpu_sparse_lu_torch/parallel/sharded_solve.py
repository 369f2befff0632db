"""Mesh-sharded level-scheduled triangular solves: counterpart of
``tpu_sparse_lu/parallel/sharded_solve.py`` on ``torch.distributed``.

The reference's intended parallel design is MPI shared-memory windows
with the chunk loop rank-striped across a node (declared, never
implemented: its ``allocate_shared`` export). Mapping, as in the JAX
package:

  MPI shared-memory window  →  every rank holds the whole factor and the
                               whole solution carrier
  rank-striped chunk loop   →  chunks of a level striped over the ranks
  window barriers           →  one ``all_reduce`` per level

Within a level every chunk is independent, so each rank solves its stripe
of diagonal tiles and applies exactly the off-diagonal tiles *sourced* at
its own chunks (owner-computes); one ``all_reduce`` of the level's compact
delta buffer then merges every rank's writes into each rank's carrier. The
collective count is ``num_levels`` per factor, as JAX's ``psum`` count.

The plans (:func:`build_sharded_tri_plan`) are copies of the JAX
package's and equal its arrays. The per-level products are ``torch.bmm``
and ``index_add_`` (JAX computes them outside any Pallas kernel), the
diagonal step follows ``tri_mode``, and the perm-in and perm-out are the
port's ``perm_gather`` (B1's gather kernel on a CUDA tensor) as in
``ParallelSparseLU``'s own solve.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..ops.fused_ldiv import perm_gather
from ..solve import TriKernelData
from ..symbolic import TriPlan
from ._comm import Collectives, check_device
from .mesh import mesh_axis

__all__ = ["ShardedTriPlan", "TriPlanSegment", "build_sharded_tri_plan",
           "rank_levels", "sharded_blocked_tri_solve", "sharded_ldiv",
           "make_sharded_ldiv"]


@dataclasses.dataclass
class TriPlanSegment:
    """One contiguous run of levels sharing a psum-buffer width.

    The compact exchange pads every level's buffer to the widest level's
    touched count; under nested-dissection schedules ONE wide leaf level
    (hundreds of chunks) would force every narrow separator level to psum
    the same wide buffer. Segmenting the level sequence (optimal 1-D
    partition DP over ``len(seg) * (maxW(seg)+1)`` + a per-segment
    overhead) lets narrow levels exchange narrow buffers — per-solve
    collective bytes drop to near the sum of ACTUAL touched rows."""

    MW: int
    level_chunks: np.ndarray   # (NLs, D, MCd)
    level_tiles: np.ndarray    # (NLs, D, MTd)
    tile_src_slot: np.ndarray  # (NLs, D, MTd)
    chunk_cslot: np.ndarray    # (NLs, D, MCd), padding -> MW (this segment's)
    tile_cslot: np.ndarray     # (NLs, D, MTd), padding -> MW
    level_touched: np.ndarray  # (NLs, MW)


@dataclasses.dataclass
class ShardedTriPlan:
    """Per-device level schedule: chunks striped round-robin, tiles placed
    with the device that owns their source chunk (owner-computes).

    The exchange is COMPACT: the set of carrier rows
    a level writes — its own chunks plus the destination chunks of its
    off-diagonal tiles — is static, so instead of psum-ing the whole
    ``(K+1, cs, R)`` carrier each level, ranks scatter their deltas into
    a ``(MW+1, cs, R)`` buffer laid out by ``level_touched`` and reduce
    only that; the level sequence is additionally SEGMENTED by width (see
    :class:`TriPlanSegment`) so narrow levels exchange narrow buffers.
    Per-level collective bytes drop from ``O(n·R)`` to
    ``O(touched·cs·R)`` — the quantity that actually has to move for the
    level's writes to become globally visible."""

    D: int  # mesh size
    # (NL, D, MCd): chunk ids, padded with K (dummy)
    level_chunks: np.ndarray
    # (NL, D, MTd): tile ids, padded with T (dummy)
    level_tiles: np.ndarray
    # (NL, D, MTd): local slot (into this device's chunk stripe) of each
    # tile's source chunk; dummy tiles point at slot 0
    tile_src_slot: np.ndarray
    # compact-exchange layout (GLOBAL padding — the per-segment views in
    # ``segments`` are what the engine executes):
    # (NL, MW): chunk ids this level writes (its chunks + tile dst
    # chunks), padded with K — the psum buffer's row map
    level_touched: np.ndarray
    # (NL, D, MCd): compact slot of each of this device's chunks
    # (padding -> MW, the buffer's garbage row)
    chunk_cslot: np.ndarray
    # (NL, D, MTd): compact slot of each tile's DST chunk (padding -> MW)
    tile_cslot: np.ndarray
    # width-bucketed contiguous level runs, in execution order
    segments: list

    @property
    def MW(self) -> int:
        return self.level_touched.shape[1]

    def psum_bytes_per_solve(self, cs: int, R: int, itemsize: int = 4) -> int:
        """Total per-level-collective payload of one solve (all levels,
        segment-exact) — the checkable 'measured per-level collective
        bytes' figure."""
        return int(sum(
            s.level_touched.shape[0] * (s.MW + 1) * cs * R * itemsize
            for s in self.segments
        ))


_SEG_OVERHEAD_ROWS = 16  # per-segment cost (the JAX package's value)
_MAX_SEGMENTS = 12


def _segment_levels(widths) -> list:
    """Optimal contiguous partition of the level sequence minimizing
    ``sum(len(seg) * (max_width(seg) + 1)) + overhead * n_segments``
    (classic 1-D partition DP), capped at ``_MAX_SEGMENTS`` segments (the
    JAX package bounds its compiled scan bodies so; the same cap keeps
    the plans equal). Returns [(lo, hi), ...]."""
    NL = len(widths)
    if NL == 0:
        return []
    S = min(_MAX_SEGMENTS, NL)
    INF = float("inf")
    # dp[s][i] = min cost of covering levels [0, i) with s segments
    dp = [[INF] * (NL + 1) for _ in range(S + 1)]
    back = [[0] * (NL + 1) for _ in range(S + 1)]
    dp[0][0] = 0.0
    for s in range(1, S + 1):
        for i in range(1, NL + 1):
            w = 0
            best, bj = INF, 0
            for j in range(i - 1, -1, -1):  # segment [j, i)
                if widths[j] > w:
                    w = widths[j]
                prev = dp[s - 1][j]
                if prev < INF:
                    c = prev + (i - j) * (w + 1) + _SEG_OVERHEAD_ROWS
                    if c < best:
                        best, bj = c, j
            dp[s][i] = best
            back[s][i] = bj
    s_best = min(range(1, S + 1), key=lambda s: dp[s][NL])
    bounds = []
    i = NL
    for s in range(s_best, 0, -1):
        j = back[s][i]
        bounds.append((j, i))
        i = j
    return bounds[::-1]


def build_sharded_tri_plan(plan: TriPlan, D: int) -> ShardedTriPlan:
    NL = plan.num_levels
    K, T = plan.K, plan.T
    # distribute chunks of each level round-robin over devices
    per_dev_chunks = [[[] for _ in range(D)] for _ in range(NL)]
    owner = {}
    slot = {}
    # compact slot map: level chunks first, then tile dst chunks
    touched_at = []  # list of dict chunk -> compact slot, one per level
    for l in range(NL):
        cnt = int(plan.level_chunk_counts[l])
        tl = {}
        for a in range(cnt):
            k = int(plan.level_chunks[l, a])
            d = a % D
            owner[k] = d
            slot[k] = len(per_dev_chunks[l][d])
            per_dev_chunks[l][d].append(k)
            tl[k] = len(tl)
        touched_at.append(tl)
    # tiles go to the owner of their source chunk
    per_dev_tiles = [[[] for _ in range(D)] for _ in range(NL)]
    for l in range(NL):
        cnt = int(plan.level_tile_counts[l])
        tl = touched_at[l]
        for a in range(cnt):
            t = int(plan.level_tiles[l, a])
            src = int(plan.tile_bcol[t])
            dst = int(plan.tile_brow[t])
            d = owner[src]
            if dst not in tl:
                tl[dst] = len(tl)
            per_dev_tiles[l][d].append((t, slot[src], tl[dst]))

    MCd = max((len(c) for lvl in per_dev_chunks for c in lvl), default=1) or 1
    MTd = max((len(t) for lvl in per_dev_tiles for t in lvl), default=1) or 1
    MW = max((len(tl) for tl in touched_at), default=1) or 1
    level_chunks = np.full((NL, D, MCd), K, dtype=np.int32)
    level_tiles = np.full((NL, D, MTd), T, dtype=np.int32)
    tile_src_slot = np.zeros((NL, D, MTd), dtype=np.int32)
    level_touched = np.full((NL, MW), K, dtype=np.int32)
    chunk_cslot = np.full((NL, D, MCd), MW, dtype=np.int32)
    tile_cslot = np.full((NL, D, MTd), MW, dtype=np.int32)
    for l in range(NL):
        for k, c in touched_at[l].items():
            level_touched[l, c] = k
        for d in range(D):
            for a, k in enumerate(per_dev_chunks[l][d]):
                level_chunks[l, d, a] = k
                chunk_cslot[l, d, a] = touched_at[l][k]
            for a, (t, s, c) in enumerate(per_dev_tiles[l][d]):
                level_tiles[l, d, a] = t
                tile_src_slot[l, d, a] = s
                tile_cslot[l, d, a] = c
    # width-bucketed segments: per-level slot values already fit any
    # segment MW >= the level's own width, so the per-segment views just
    # remap the garbage row MW -> MW_s and truncate the touched map
    widths = [len(tl) for tl in touched_at]
    segments = []
    for lo, hi in _segment_levels(widths):
        MW_s = max(widths[lo:hi] or [1]) or 1
        segments.append(TriPlanSegment(
            MW=MW_s,
            level_chunks=level_chunks[lo:hi],
            level_tiles=level_tiles[lo:hi],
            tile_src_slot=tile_src_slot[lo:hi],
            chunk_cslot=np.where(
                chunk_cslot[lo:hi] == MW, MW_s, chunk_cslot[lo:hi]
            ).astype(np.int32),
            tile_cslot=np.where(
                tile_cslot[lo:hi] == MW, MW_s, tile_cslot[lo:hi]
            ).astype(np.int32),
            level_touched=level_touched[lo:hi, :MW_s],
        ))
    return ShardedTriPlan(
        D=D,
        level_chunks=level_chunks,
        level_tiles=level_tiles,
        tile_src_slot=tile_src_slot,
        level_touched=level_touched,
        chunk_cslot=chunk_cslot,
        tile_cslot=tile_cslot,
        segments=segments,
    )



@dataclasses.dataclass
class RankLevel:
    """One level of one rank's share of a :class:`ShardedTriPlan`, padding
    dropped: the rank's chunks and their compact slots, its tiles (as bank
    rows ``K+1+t``), each tile's source slot among the rank's chunks and
    its destination's compact slot, and the level's touched chunks (the
    buffer's row map) — int64 views on the solver's device."""

    MW: int
    chunks: torch.Tensor
    cslot: torch.Tensor
    tiles: torch.Tensor
    src: torch.Tensor
    tslot: torch.Tensor
    touched: torch.Tensor


def rank_levels(plan: TriPlan, splan: ShardedTriPlan, d: int,
                device) -> List[RankLevel]:
    """Rank ``d``'s levels of ``splan``, in execution order, from one
    upload per index kind."""
    K, T = plan.K, plan.T
    rows = {k: [] for k in ("chunks", "cslot", "tiles", "src", "tslot",
                            "touched")}
    shape = []  # (MW, n_chunks, n_tiles, width) per level
    for s in splan.segments:
        for i in range(s.level_chunks.shape[0]):
            cm = s.level_chunks[i, d] < K
            tm = s.level_tiles[i, d] < T
            touched = s.level_touched[i]
            width = int(np.count_nonzero(touched < K))
            rows["chunks"].append(s.level_chunks[i, d][cm])
            rows["cslot"].append(s.chunk_cslot[i, d][cm])
            rows["tiles"].append(K + 1 + s.level_tiles[i, d][tm])
            rows["src"].append(s.tile_src_slot[i, d][tm])
            rows["tslot"].append(s.tile_cslot[i, d][tm])
            rows["touched"].append(touched[:width])
            shape.append((s.MW, int(cm.sum()), int(tm.sum()), width))
    flat = {k: torch.as_tensor(np.concatenate(v).astype(np.int64),
                               device=device) if v else None
            for k, v in rows.items()}
    out, at = [], {k: 0 for k in rows}
    for MW, nc, nt, w in shape:
        size = {"chunks": nc, "cslot": nc, "tiles": nt, "src": nt,
                "tslot": nt, "touched": w}
        views = {}
        for k, m in size.items():
            views[k] = flat[k][at[k]: at[k] + m]
            at[k] += m
        out.append(RankLevel(MW=MW, **views))
    return out


def diag_step(data: TriKernelData, r: torch.Tensor, ids: torch.Tensor,
              tri_mode: str) -> torch.Tensor:
    """The diagonal step on the chunks ``ids`` (``r``: their rows), read
    from the bank (``tiles_t`` holds each inverse transposed) or, at
    ``"trsm"``, from the diagonal tiles themselves."""
    if tri_mode == "trsm":
        return torch.linalg.solve_triangular(
            data.diag.index_select(0, ids), r, upper=not data.lower)
    tinv = data.tiles_t.index_select(0, ids).transpose(1, 2)
    y = torch.bmm(tinv, r)
    if tri_mode == "inv_refine":
        resid = r - torch.bmm(data.diag.index_select(0, ids), y)
        y = y + torch.bmm(tinv, resid)
    elif tri_mode != "inv":
        raise ValueError(f"unknown tri_mode: {tri_mode!r}")
    return y


def sharded_blocked_tri_solve(comm: Collectives, levels: List[RankLevel],
                              data: TriKernelData, xw: torch.Tensor, *,
                              tri_mode: str = "trsm") -> torch.Tensor:
    """Solve ``T x = b`` in place on the replicated chunk-blocked carrier
    ``xw (K+1, cs, R)``, rank-striped: per level, this rank's diagonal
    step and its off-diagonal tiles write a compact ``(MW+1, cs, R)``
    delta buffer (row ``MW`` the garbage row of the JAX layout), one
    ``all_reduce`` sums the ranks' buffers, and every rank adds it to its
    carrier. Every rank reads the whole bank ``data`` (the shared
    window)."""
    _, cs, R = xw.shape
    bank = data.tiles_t
    for lv in levels:
        dc = xw.new_zeros((lv.MW + 1, cs, R))
        if lv.chunks.numel():
            r = xw.index_select(0, lv.chunks)
            y = diag_step(data, r, lv.chunks, tri_mode)
            dc.index_add_(0, lv.cslot, y - r)
            if lv.tiles.numel():
                # owner-computes: this rank solved every tile's source
                off = bank.index_select(0, lv.tiles).transpose(1, 2)
                dc.index_add_(0, lv.tslot,
                              torch.bmm(off, y.index_select(0, lv.src)))
        comm.all_reduce(dc)
        xw.index_add_(0, lv.touched, dc[: lv.touched.numel()])
    return xw


def sharded_ldiv(comm: Collectives, plan, llevels: List[RankLevel],
                 ulevels: List[RankLevel], ldata: TriKernelData,
                 udata: TriKernelData, pidx: torch.Tensor,
                 qidx: torch.Tensor, rs: torch.Tensor, b: torch.Tensor, *,
                 tri_mode: str = "trsm") -> torch.Tensor:
    """Perm-in with the row scaling, the L and U level sweeps across the
    ranks, perm-out (reference ``ldiv!``, src:286-342) for a contiguous
    ``(n, R)`` ``b``. The perms are ``ParallelSparseLU``'s own gathers
    (``pidx``, ``qidx``: the nd embedding composed in), run on every rank;
    the level sweeps run on the factor-space carrier."""
    R = b.shape[1]
    xw = perm_gather(b, pidx, rs).view(plan.lplan.K + 1, plan.cs, R)
    sharded_blocked_tri_solve(comm, llevels, ldata, xw, tri_mode=tri_mode)
    sharded_blocked_tri_solve(comm, ulevels, udata, xw, tri_mode=tri_mode)
    return perm_gather(xw.view(-1, R), qidx)


def make_sharded_ldiv(F, mesh, axis: str = "chunks", *,
                      shard_output: bool = False):
    """A mesh-parallel ``ldiv`` for a ``ParallelSparseLU``: every rank of
    ``mesh`` calls ``solve(b)`` with the same ``b``, ``(n,)`` or ``(n,
    R)``; the solve runs level-striped over the ranks. Composes with
    every ordering, the nd embedding included. Reads ``F``'s numeric
    state (``F._numeric``) at each call, so it serves after a
    refactorization of the same plan.

    Returns the solution on every rank, or with ``shard_output=True`` a
    ``DTensor`` sharded by rows over the mesh (``Shard(0)``, the JAX
    ``out_specs=P(axis)``): rows padded to ``D * ceil(n/D)`` with zeros
    past ``n``, each rank holding its own contiguous block. ``solve
    .collectives.counts`` holds the last call's collectives (one
    ``all_reduce`` per level of each factor); ``solve.lsplan`` /
    ``solve.usplan`` the plans (``psum_bytes_per_solve``).

    The JAX ``multihost=`` keyword is not ported: every torch process
    group is multi-process already.
    """
    group, D, d = mesh_axis(mesh, axis)
    check_device(F, group)
    plan = F.plan
    lsp = build_sharded_tri_plan(plan.lplan, D)
    usp = build_sharded_tri_plan(plan.uplan, D)
    llev = rank_levels(plan.lplan, lsp, d, F.device)
    ulev = rank_levels(plan.uplan, usp, d, F.device)
    comm = Collectives(group, D, d)
    n = F.n
    Sh = -(-n // D)  # rows per rank in the sharded output
    mode = F.config.tri_mode

    def solve(b):
        b, squeeze = F._as_rhs(b)
        comm.reset()
        num = F._numeric
        x = sharded_ldiv(comm, plan, llev, ulev, num.ldata, num.udata,
                         num.pidx, num.qidx, num.rs, b, tri_mode=mode)
        if squeeze:
            x = x[:, 0]
        if not shard_output:
            return x
        from torch.distributed.tensor import DTensor, Shard

        mine = x.new_zeros((Sh,) + tuple(x.shape[1:]))
        lo, hi = min(d * Sh, n), min((d + 1) * Sh, n)
        mine[: hi - lo] = x[lo:hi]
        shape = (D * Sh,) + tuple(x.shape[1:])
        return DTensor.from_local(mine, mesh, [Shard(0)], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    solve.collectives = comm
    solve.lsplan, solve.usplan = lsp, usp
    return solve
