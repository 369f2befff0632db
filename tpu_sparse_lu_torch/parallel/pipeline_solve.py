"""Halo-pipelined distributed triangular solves: counterpart of
``tpu_sparse_lu/parallel/pipeline_solve.py`` on ``torch.distributed``.

The psum engine (``sharded_solve.py``) keeps the whole carrier on every
rank, the shared-window analogue. This module is the message-passing
analogue for banded operators (BASELINE config 5: a block-banded PDE
matrix row-partitioned across ranks):

* chunks are partitioned contiguously: rank ``d`` owns the chunk range
  ``[d*Kl, (d+1)*Kl)``, so the solution is truly distributed;
* within a rank the chunks are solved in local dependency order, one
  chunk after the other, exactly the single-device engine on the slice;
* dependencies crossing the partition boundary become halo segments:
  the off-diagonal tiles whose source chunk is local but whose
  destination is on the next rank are applied locally, and the
  accumulated contribution travels to that rank with one
  ``batch_isend_irecv`` per round (JAX: one ``lax.ppermute``);
* the right-hand-side panel is split into ``M`` micro-panels, software
  pipelined: in round ``r`` rank ``d`` processes panel ``r - d``.

Each rank posts only the transfers that carry a panel: its send when it
processed one this round and has a neighbour on that side, its receive
when that neighbour did (JAX moves zeros in the other rounds). The plans
(:func:`build_pipeline_plan`, :func:`build_sharded_perm_plan`,
:func:`autotune_micro_panels`) are copies of the JAX package's and equal
its arrays. The tile products are ``torch.mm``/``addmm_`` on views of the
bank (JAX computes them outside any Pallas kernel); the perm-in and
perm-out are the port's ``perm_gather`` (B1's gather kernel on a CUDA
tensor), the un-pivot of a distributed solution a ``perm_gather`` per
boundary direction in place of JAX's one-hot tiles (``ops/permute.py`` is
not ported).

Restrictions (checked at plan time, ``None`` otherwise, as in JAX): every
off-diagonal tile stays within one boundary crossing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops.fused_ldiv import perm_gather
from ..solve import TriKernelData
from ..symbolic import TriPlan
from ._comm import Collectives, check_device
from .mesh import mesh_axis

__all__ = ["PipelinePlan", "build_pipeline_plan", "autotune_micro_panels",
           "RankPipeline", "rank_pipeline", "pipeline_tri_solve",
           "pipeline_ldiv_pair", "PermBlocks", "build_perm_blocks",
           "ShardedPermPlan", "build_sharded_perm_plan",
           "sharded_apply_perm", "make_pipeline_ldiv"]


@dataclasses.dataclass
class PipelinePlan:
    """Static per-device schedule for one pipelined triangular solve."""

    D: int            # devices
    Kl: int           # chunks per device (padded)
    H: int            # halo depth in chunks (max boundary crossing)
    forward: bool     # True: lsolve (halo flows d -> d+1); False: rsolve
    # (D, Kl) global chunk id per local step (K = dummy); steps run in
    # local dependency order (ascending chunks for L, descending for U)
    steps: np.ndarray
    # (D, Kl, MT) tile ids applied after each local step's chunk solve,
    # LOCAL destinations only (T = dummy)
    step_tiles: np.ndarray
    # (D, Kl, MT) local slot (0..Kl+H) of each tile's dst in the device's
    # extended carrier [halo_in | local chunks]
    step_tile_dst: np.ndarray
    # (D, Kl, MT) same for boundary tiles: applied after the step, into the
    # outgoing halo buffer slot 0..H-1 (H = dummy/no-op)
    bnd_tiles: np.ndarray
    bnd_tile_dst: np.ndarray
    MT: int
    MB: int


def _owner(k: int, Kl: int, D: int) -> int:
    return min(k // Kl, D - 1)


def build_pipeline_plan(plan: TriPlan, D: int) -> Optional[PipelinePlan]:
    """Build the pipelined schedule, or None if the pattern doesn't fit
    (crossings deeper than one device, or non-chain local structure is
    fine — local levels are honoured by processing in level order)."""
    K, T = plan.K, plan.T
    Kl = -(-K // D)
    fwd = plan.lower

    # halo depth: max |dst - src| in chunks, must stay within neighbour
    if T:
        span = np.abs(plan.tile_brow[:T].astype(int) - plan.tile_bcol[:T].astype(int))
        H = int(span.max())
    else:
        H = 1
    H = max(1, min(H, Kl))
    for t in range(T):
        src, dst = int(plan.tile_bcol[t]), int(plan.tile_brow[t])
        osrc, odst = _owner(src, Kl, D), _owner(dst, Kl, D)
        if abs(odst - osrc) > 1:
            return None  # crossing skips a device: psum engine instead
        if fwd and odst < osrc:
            return None
        if not fwd and odst > osrc:
            return None

    # local step order: within a device, chunks in dependency order
    steps = np.full((D, Kl), K, dtype=np.int32)
    local_index = {}
    for d in range(D):
        lo, hi = d * Kl, min((d + 1) * Kl, K)
        ids = list(range(lo, hi))
        if not fwd:
            ids = ids[::-1]
        for a, k in enumerate(ids):
            steps[d, a] = k
            local_index[k] = a

    # tiles grouped by their source chunk's local step; split local/boundary
    per_step_local = [[[] for _ in range(Kl)] for _ in range(D)]
    per_step_bnd = [[[] for _ in range(Kl)] for _ in range(D)]
    for t in range(T):
        src, dst = int(plan.tile_bcol[t]), int(plan.tile_brow[t])
        d = _owner(src, Kl, D)
        a = local_index[src]
        if _owner(dst, Kl, D) == d:
            # local slot: position of dst within the extended carrier
            # [H halo slots | Kl local chunks] — halo slots hold incoming
            # contributions for the FIRST chunks processed
            slot = H + (dst - d * Kl if fwd else (min((d + 1) * Kl, K) - 1 - dst))
            per_step_local[d][a].append((t, slot))
        else:
            # boundary: halo slot on the RECEIVER = position of dst in its
            # first H processed chunks
            nd = d + 1 if fwd else d - 1
            off = (dst - nd * Kl) if fwd else (min((nd + 1) * Kl, K) - 1 - dst)
            if off >= H:
                return None  # receiver processes it later than halo depth
            per_step_bnd[d][a].append((t, off))

    MT = max((len(x) for dd in per_step_local for x in dd), default=1) or 1
    MB = max((len(x) for dd in per_step_bnd for x in dd), default=1) or 1
    step_tiles = np.full((D, Kl, MT), T, dtype=np.int32)
    step_tile_dst = np.zeros((D, Kl, MT), dtype=np.int32)
    bnd_tiles = np.full((D, Kl, MB), T, dtype=np.int32)
    bnd_tile_dst = np.full((D, Kl, MB), H, dtype=np.int32)
    for d in range(D):
        for a in range(Kl):
            for i, (t, s) in enumerate(per_step_local[d][a]):
                step_tiles[d, a, i] = t
                step_tile_dst[d, a, i] = s
            for i, (t, s) in enumerate(per_step_bnd[d][a]):
                bnd_tiles[d, a, i] = t
                bnd_tile_dst[d, a, i] = s
    return PipelinePlan(
        D=D, Kl=Kl, H=H, forward=fwd,
        steps=steps, step_tiles=step_tiles, step_tile_dst=step_tile_dst,
        bnd_tiles=bnd_tiles, bnd_tile_dst=bnd_tile_dst, MT=MT, MB=MB,
    )



def autotune_micro_panels(R: int, D: int, *, cap: Optional[int] = None) -> int:
    """Pick the micro-panel count M for the overlapped pipeline.

    Pipeline efficiency is ``M / (M + 2D - 1)`` — the fill/drain bubble is
    ``2D - 1`` rounds regardless of M, so more (thinner) panels amortize
    it better; the cost of thin panels (cs × R/M tile matmuls) is small
    because each round is latency-bound, not MXU-bound. M must divide R
    (equal static panel widths), so take the largest divisor of R that is
    ≤ ``cap``. The default cap scales with the bubble: ``max(16, 4*(2D-1))``
    — at D ≤ 3 the old cap of 16 already gives ≥ 0.76 pipeline
    efficiency, while D ≥ 4 with wide panels (R ≥ 32) needs M > 16 to
    stay above the 70% bar (M=32 at D=4: 32/39 = 0.82 vs 16/23 = 0.70);
    each extra round costs one neighbour exchange.

    ``R = 1`` (the reference's primary calling pattern, src:286) returns
    M=1: a banded chain is inherently serial across a contiguous row
    partition — device d+1's first chunk depends on device d's last
    chunks — so there is no intra-RHS axis to pipeline; single-RHS
    multi-rank solves should ride the level-striped psum engine over an
    nd ordering instead (level width is the parallelism there).
    """
    if cap is None:
        cap = max(16, 4 * (2 * D - 1))
    m = max(1, min(cap, R))
    while R % m:
        m -= 1
    return m



@dataclasses.dataclass
class PermBlocks:
    """The block structure of ``out[i] = v[perm[i]]`` on chunk-blocked
    carriers: output chunk ``k`` draws from the source chunks
    ``src[k, :]`` (``K_in`` = none). The JAX package's ``PermPlan``
    (``ops/permute.py``) without its one-hot tiles, which the port does
    not build: the port moves rows by gather, through ``perm`` itself
    (``-1`` rows are zero)."""

    K: int
    cs: int
    S: int
    K_in: int
    src: np.ndarray   # (K, S) int32
    perm: np.ndarray  # (n,) int64


def build_perm_blocks(perm, n: int, cs: int, *,
                      n_in: Optional[int] = None) -> PermBlocks:
    """The blocks of ``out[i] = v[perm[i]]``, ``perm`` of length ``n``
    indexing a vector of length ``n_in`` (default ``n``): ``src`` equals
    the JAX ``build_perm_plan``'s."""
    K = -(-n // cs)
    n_in = n if n_in is None else n_in
    K_in = -(-n_in // cs)
    perm = np.asarray(perm, dtype=np.int64)
    keep = perm >= 0
    i = np.arange(n, dtype=np.int64)[keep]
    pairs = np.unique((i // cs) * np.int64(K_in + 1) + perm[keep] // cs)
    pk, ps = pairs // (K_in + 1), pairs % (K_in + 1)
    counts = np.bincount(pk, minlength=K)
    S = max(1, int(counts.max()) if pairs.size else 1)
    src = np.full((K, S), K_in, dtype=np.int32)
    fill = np.zeros(K, dtype=np.int64)
    for k, s in zip(pk.tolist(), ps.tolist()):
        src[k, fill[k]] = s
        fill[k] += 1
    return PermBlocks(K=K, cs=cs, S=S, K_in=K_in, src=src, perm=perm)


@dataclasses.dataclass
class ShardedPermPlan:
    """Static owner-computes schedule for applying a permutation to a
    chunk-sharded carrier: the solution stays partitioned by chunk blocks
    end to end.

    Blocks are grouped by boundary crossing ``owner(dst) - owner(src)`` ∈
    {0, +1, -1}: each rank moves the rows whose source chunk it owns into
    one buffer per direction; the off-rank buffers travel to the
    neighbour in one exchange, never a global collective. ``tile_idx``,
    ``src_slot``, ``dst_slot`` and ``use_dir`` equal the JAX plan's (a
    tile there is the block ``(o, s)``, ``o*S + s``); ``row_src`` is the
    gather the port runs instead of the one-hot tile products: for rank
    ``d`` and direction ``di``, the local source row of each local output
    row (``-1``: none)."""

    D: int
    Ko_l: int                # output chunks per rank (padded)
    tile_idx: np.ndarray     # (D, 3, MJ) flat block id (K*S = none)
    src_slot: np.ndarray     # (D, 3, MJ) local slot in the sharded input
    dst_slot: np.ndarray     # (D, 3, MJ) output slot (Ko_l = none)
    use_dir: tuple           # (stay, fwd, bwd) static usage flags
    row_src: np.ndarray      # (D, 3, Ko_l*cs) int32


def build_sharded_perm_plan(qperm: PermBlocks, Kl_src: int, D: int):
    """Schedule ``out = Q x`` over a carrier sharded in ``Kl_src``
    contiguous source chunks per rank. ``None`` when a block crosses more
    than one rank boundary (the replicated path instead)."""
    src = np.asarray(qperm.src)          # (K_out, S)
    K_out, S = src.shape
    cs = qperm.cs
    Ko_l = -(-K_out // D)
    items = [[[] for _ in range(3)] for _ in range(D)]  # [d][dir]
    for o in range(K_out):
        d_out = min(o // Ko_l, D - 1)
        for s_ in range(S):
            sc = int(src[o, s_])
            if sc >= qperm.K_in:
                continue
            d_src = min(sc // Kl_src, D - 1)
            delta = d_out - d_src
            if abs(delta) > 1:
                return None
            items[d_src][delta % 3].append(  # 0: stay, 1: fwd, 2: bwd
                (o * S + s_, sc - d_src * Kl_src, o - d_out * Ko_l)
            )
    MJ = max(1, max(len(x) for dd in items for x in dd))
    zero_tile = K_out * S
    tile_idx = np.full((D, 3, MJ), zero_tile, dtype=np.int32)
    src_slot = np.zeros((D, 3, MJ), dtype=np.int32)
    dst_slot = np.full((D, 3, MJ), Ko_l, dtype=np.int32)
    for d in range(D):
        for di in range(3):
            for a, (t, ss, ds) in enumerate(items[d][di]):
                tile_idx[d, di, a] = t
                src_slot[d, di, a] = ss
                dst_slot[d, di, a] = ds
    use_dir = tuple(
        any(len(items[d][di]) for d in range(D)) for di in range(3)
    )
    # the rows behind the blocks: output row i of chunk o reads perm[i]
    perm = qperm.perm
    i = np.nonzero(perm >= 0)[0]
    o, sc = i // cs, perm[i] // cs
    d_out = np.minimum(o // Ko_l, D - 1)
    d_src = np.minimum(sc // Kl_src, D - 1)
    row_src = np.full((D, 3, Ko_l * cs), -1, dtype=np.int32)
    row_src[d_src, (d_out - d_src) % 3,
            (o - d_out * Ko_l) * cs + i % cs] = (
        (sc - d_src * Kl_src) * cs + perm[i] % cs)
    return ShardedPermPlan(D=D, Ko_l=Ko_l, tile_idx=tile_idx,
                           src_slot=src_slot, dst_slot=dst_slot,
                           use_dir=use_dir, row_src=row_src)


@dataclasses.dataclass
class RankPipeline:
    """Rank ``d``'s share of a :class:`PipelinePlan`, padding dropped.

    ``steps`` lists the real local steps in processing order as ``(a, k,
    local, boundary)``: local slot ``a``, chunk ``k``, the local tiles
    ``(slot, t)`` (destination slot among the local rows) and the
    boundary tiles ``(h, t)`` (halo slot on the neighbour). On the device:
    ``rows`` (Kl,) the chunk of each local slot (``K`` = a padding slot,
    a zero row), ``real``/``real_chunks`` the slots and chunks of the real
    steps (the final scatter), and for the U sweep of the overlapped pair
    ``u_from_l`` (each U slot's L slot), ``asc_slot``/``asc_pos`` (the
    slots of the rank's chunks, in ascending chunk order, and their
    positions).
    """

    H: int
    forward: bool
    steps: list
    rows: torch.Tensor
    real: torch.Tensor
    real_chunks: torch.Tensor
    u_from_l: torch.Tensor
    asc_slot: torch.Tensor
    asc_pos: torch.Tensor


def rank_pipeline(plan: TriPlan, pplan: PipelinePlan, d: int,
                  device) -> RankPipeline:
    K, T, Kl = plan.K, plan.T, pplan.Kl
    st = pplan.steps[d]
    steps = []
    for a in range(Kl):
        k = int(st[a])
        if k >= K:
            continue
        loc = [(int(pplan.step_tile_dst[d, a, j]) - pplan.H, int(t))
               for j, t in enumerate(pplan.step_tiles[d, a]) if t < T]
        bnd = [(int(pplan.bnd_tile_dst[d, a, j]), int(t))
               for j, t in enumerate(pplan.bnd_tiles[d, a]) if t < T]
        steps.append((a, k, loc, bnd))
    real = np.nonzero(st < K)[0]
    u_from_l = np.where(st < K, st - d * Kl, Kl - 1)

    def dev(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)

    return RankPipeline(
        H=pplan.H, forward=pplan.forward, steps=steps, rows=dev(st),
        real=dev(real), real_chunks=dev(st[real]), u_from_l=dev(u_from_l),
        asc_slot=dev(st[real] - d * Kl), asc_pos=dev(real))


def _bind(rp: RankPipeline, data: TriKernelData) -> list:
    """The steps with their bank tiles as views (``tiles_t`` holds every
    tile transposed, the off-diagonal ones negated): no copy of the
    factor is made."""
    bank, K = data.tiles_t, data.K
    return [(a, bank[k].T, data.diag[k],
             [(s, bank[K + 1 + t].T) for s, t in loc],
             [(h, bank[K + 1 + t].T) for h, t in bnd])
            for a, k, loc, bnd in rp.steps]


def _sweep(steps: list, rhs: torch.Tensor, H: int, lower: bool,
           tri_mode: str):
    """One rank's chunk chain on one panel: ``rhs (Kl, cs, Rm)`` takes the
    local tiles' updates in place; returns the solved rows (padding slots
    as given) and the outgoing halo ``(H, cs, Rm)``."""
    ys = rhs.clone()
    halo = rhs.new_zeros((H,) + tuple(rhs.shape[1:]))
    for a, dinv, diag, loc, bnd in steps:
        r, y = rhs[a], ys[a]
        if tri_mode == "trsm":
            torch.linalg.solve_triangular(diag, r, upper=not lower, out=y)
        else:
            torch.mm(dinv, r, out=y)
            if tri_mode == "inv_refine":
                y.addmm_(dinv, torch.addmm(r, diag, y, alpha=-1))
        for s, off in loc:
            rhs[s].addmm_(off, y)
        for h, off in bnd:
            halo[h].addmm_(off, y)
    return ys, halo


def _panels(xw: torch.Tensor, rows: torch.Tensor, M: int) -> torch.Tensor:
    """(M, Kl, cs, R/M): the carrier rows ``rows`` split into M panels."""
    Kl, (_, cs, R) = rows.numel(), xw.shape
    return (xw.index_select(0, rows).view(Kl, cs, M, R // M)
            .permute(2, 0, 1, 3).contiguous())


def _micro(micro_panels: int, R: int) -> int:
    M = max(1, min(micro_panels, R))
    while R % M:
        M -= 1
    return M


def _gather_out(comm: Collectives, rp: RankPipeline, out: list,
                xw: torch.Tensor) -> torch.Tensor:
    """Every rank's solved rows into a replicated carrier: scatter the
    rank's real chunks into zeros, one ``all_reduce``."""
    outR = torch.cat(out, dim=-1)
    glob = torch.zeros_like(xw)
    glob.index_add_(0, rp.real_chunks, outR.index_select(0, rp.real))
    comm.all_reduce(glob)
    return glob


def _check_tri_mode(tri_mode: str) -> None:
    if tri_mode not in ("inv", "trsm", "inv_refine"):
        raise ValueError(f"unknown tri_mode: {tri_mode!r}")


def pipeline_tri_solve(comm: Collectives, rp: RankPipeline,
                       data: TriKernelData, xw: torch.Tensor, *,
                       micro_panels: int = 4,
                       tri_mode: str = "inv") -> torch.Tensor:
    """One pipelined triangular solve of the replicated carrier ``xw
    (K+1, cs, R)``; returns the replicated solved carrier. ``D + M - 1``
    rounds; a backward solve starts at the last rank."""
    _check_tri_mode(tri_mode)
    D, d = comm.D, comm.d
    fwd = rp.forward
    pos = d if fwd else D - 1 - d
    M = _micro(micro_panels, xw.shape[-1])
    loc = _panels(xw, rp.rows, M)
    halo_in = loc.new_zeros((M, rp.H) + tuple(loc.shape[2:]))
    steps = _bind(rp, data)
    out = list(loc)
    for r in range(D + M - 1):
        m = r - pos
        sent = None
        if 0 <= m < M:
            rhs = loc[m]
            rhs[: rp.H] += halo_in[m]
            out[m], sent = _sweep(steps, rhs, rp.H, data.lower, tri_mode)
        # the panel the previous rank of the chain finished this round is
        # the one this rank takes next round
        m_recv, prev = r + 1 - pos, (d - 1 if fwd else d + 1)
        recv = (loc.new_empty((rp.H,) + tuple(loc.shape[2:]))
                if 0 <= prev < D and 0 <= m_recv < M else None)
        if fwd:
            comm.neighbours(sent, None, recv, None)
        else:
            comm.neighbours(None, sent, None, recv)
        if recv is not None:
            halo_in[m_recv] += recv
    return _gather_out(comm, rp, out, xw)


def pipeline_ldiv_pair(comm: Collectives, lrp: RankPipeline,
                       ldata: TriKernelData, urp: RankPipeline,
                       udata: TriKernelData, xw: torch.Tensor, *,
                       micro_panels: int = 4, tri_mode: str = "inv",
                       shard_output: bool = False) -> torch.Tensor:
    """Both triangular solves with overlapped phases: rank ``d`` at round
    ``r`` runs the L sweep of panel ``r - d`` and the U sweep of panel
    ``r - (2D-1-d)``; ``M + 2D - 1`` rounds instead of the sequential
    ``2(M + D - 1)``. The L results never leave the rank: the U sweep
    reads them re-indexed (``u_from_l``).

    Returns the replicated solved carrier ``(K+1, cs, R)`` (one
    ``all_reduce``), or with ``shard_output=True`` this rank's chunk rows
    ``(Kl, cs, R)`` in ascending order, padding rows zero: the only
    collectives are then the halo exchanges.
    """
    _check_tri_mode(tri_mode)
    D, d = comm.D, comm.d
    M = _micro(micro_panels, xw.shape[-1])
    HL, HU = lrp.H, urp.H
    pos_l, pos_u = d, 2 * D - 1 - d
    loc = _panels(xw, lrp.rows, M)
    shape = tuple(loc.shape[2:])
    halo_l = loc.new_zeros((M, HL) + shape)
    halo_u = loc.new_zeros((M, HU) + shape)
    lsteps, usteps = _bind(lrp, ldata), _bind(urp, udata)
    out = [None] * M
    for r in range(M + 2 * D - 1):
        hol = hou = None
        m = r - pos_l
        if 0 <= m < M:  # forward sweep
            rhs = loc[m]
            rhs[:HL] += halo_l[m]
            ys, hol = _sweep(lsteps, rhs, HL, True, tri_mode)
            loc[m].copy_(ys)
        m = r - pos_u
        if 0 <= m < M:  # backward sweep: the L rows, no communication
            rhs = loc[m].index_select(0, urp.u_from_l)
            rhs[:HU] += halo_u[m]
            out[m], hou = _sweep(usteps, rhs, HU, False, tri_mode)
        # halos: L forward from rank d-1, U backward from rank d+1, each
        # expected when its sender processed a panel this round
        m_l, m_u = r + 1 - pos_l, r + 1 - pos_u
        recv_l = (loc.new_empty((HL,) + shape)
                  if d > 0 and 0 <= m_l < M else None)
        recv_u = (loc.new_empty((HU,) + shape)
                  if d + 1 < D and 0 <= m_u < M else None)
        comm.neighbours(hol, hou, recv_l, recv_u)
        if recv_l is not None:
            halo_l[m_l] += recv_l
        if recv_u is not None:
            halo_u[m_u] += recv_u
    if not shard_output:
        return _gather_out(comm, urp, out, xw)
    outR = torch.cat(out, dim=-1)
    mine = outR.new_zeros(outR.shape)
    mine.index_copy_(0, urp.asc_slot, outR.index_select(0, urp.asc_pos))
    return mine


def sharded_apply_perm(comm: Collectives, spp: ShardedPermPlan,
                       row_src: torch.Tensor,
                       x_loc: torch.Tensor) -> torch.Tensor:
    """Apply the permutation to this rank's chunk rows ``x_loc (Kl_src,
    cs, R)`` of a sharded carrier → its output rows ``(Ko_l*cs, R)``:
    one ``perm_gather`` per used direction (``row_src``: this rank's
    ``spp.row_src``, int32 on the device), the off-rank buffers moved in
    one exchange with the neighbours."""
    R = x_loc.shape[-1]
    flat = x_loc.reshape(-1, R)
    bufs = [perm_gather(flat, row_src[di]) if spp.use_dir[di] else None
            for di in range(3)]
    out = bufs[0] if bufs[0] is not None else flat.new_zeros(
        (row_src.shape[1], R))
    recv_f = torch.empty_like(out) if spp.use_dir[1] else None
    recv_b = torch.empty_like(out) if spp.use_dir[2] else None
    comm.neighbours(bufs[1], bufs[2], recv_f, recv_b)
    if recv_f is not None and comm.d > 0:
        out += recv_f
    if recv_b is not None and comm.d + 1 < comm.D:
        out += recv_b
    return out


def make_pipeline_ldiv(F, mesh, axis: str = "chunks",
                       micro_panels: Optional[int] = None, *,
                       replicate: bool = True):
    """Pipelined distributed ``ldiv`` for banded-enough factors: every
    rank calls ``solve(b)`` with the same ``b``, ``(n,)`` or ``(n, R)``.

    Returns ``None`` when either factor's pattern crosses more than one
    rank boundary (use ``make_sharded_ldiv`` instead).
    ``micro_panels=None`` picks the panel count per call
    (:func:`autotune_micro_panels`).

    ``replicate=True`` returns the solution on every rank (one
    ``all_reduce`` after the waves). ``replicate=False`` keeps it
    distributed end to end: the un-pivot runs owner-computes on the
    sharded carrier with at most one exchange per direction, and
    ``solve`` returns a ``DTensor`` sharded by rows (``Shard(0)``) of
    padded length ``D * ceil(K_out/D) * cs`` (rows past ``n`` zero).
    It falls back to the replicated path when the column permutation
    crosses more than one rank boundary. ``solve.collectives.counts``
    holds the last call's collectives.
    """
    group, D, d = mesh_axis(mesh, axis)
    check_device(F, group)
    plan = F.plan
    lp = build_pipeline_plan(plan.lplan, D)
    up = build_pipeline_plan(plan.uplan, D)
    if lp is None or up is None:
        return None
    dev = F.device
    lrp = rank_pipeline(plan.lplan, lp, d, dev)
    urp = rank_pipeline(plan.uplan, up, d, dev)
    comm = Collectives(group, D, d)
    spp = row_src = None
    if not replicate:
        qb = build_perm_blocks(F._numeric.qidx.cpu().numpy(), F.n, plan.cs,
                               n_in=plan.n)
        spp = build_sharded_perm_plan(qb, lp.Kl, D)
        replicate = spp is None
        if spp is not None:
            row_src = torch.as_tensor(spp.row_src[d], device=dev)
    mode = F.config.tri_mode
    K, cs = plan.lplan.K, plan.cs

    def solve(b):
        b, squeeze = F._as_rhs(b)
        comm.reset()
        R = b.shape[1]
        M = (autotune_micro_panels(R, D) if micro_panels is None
             else micro_panels)
        num = F._numeric
        xw = perm_gather(b, num.pidx, num.rs).view(K + 1, cs, R)
        xw = pipeline_ldiv_pair(comm, lrp, num.ldata, urp, num.udata, xw,
                                micro_panels=M, tri_mode=mode,
                                shard_output=not replicate)
        if replicate:
            x = perm_gather(xw.view(-1, R), num.qidx)
            return x[:, 0] if squeeze else x
        from torch.distributed.tensor import DTensor, Shard

        x = sharded_apply_perm(comm, spp, row_src, xw)
        if squeeze:
            x = x[:, 0].contiguous()
        shape = (D * x.shape[0],) + tuple(x.shape[1:])
        return DTensor.from_local(x, mesh, [Shard(0)], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    solve.collectives = comm
    solve.lplan, solve.uplan = lp, up
    return solve
