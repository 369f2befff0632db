"""Tile-store assembly for the device refactorization: counterpart of
``tpu_sparse_lu/assemble.py``.

The device refactorization starts by placing A's nonzeros into the merged
dense tile store as ``(Rs·A)[p, q]`` (the reference's ``fill_chunks!``
scatter, src:180-243, with UMFPACK's per-``lu!`` row-scaling recompute,
src:263). It runs in stages, all planned once on the host:

1. **Span gather** (kernel B4): the unpermuted store is built TRANSPOSED,
   ``(tile, col, row)``, so the nonzeros of one CSC column that fall in one
   tile are one contiguous run of the value stream and one row of the
   transposed store. Each store row is copied from its longest run; rows
   come out in order, so no scatter is needed.
2. **Leftovers**: elements whose run lost its store row to a longer run
   are placed with one index write.
3. **nd ones**: the nd embedding's identity entries, placed *before*
   the equilibration so they are scaled like values.
4. **Row equilibration** on the unpermuted store: ``Rs`` comes out in
   original row order.
5. **Transpose**, then 6. the row permutation ``p`` as one row gather
   (``permrow_src``) into the closure store, then 7. the identity pads
   (tail diagonal of the last chunk, dummy tile).

On a CUDA tensor :func:`assemble` runs them in two launches
(``ops/assembly.py``, ``csrc/assemble.cu``): blocks over the unpermuted
tiles for stages 1-3, the row maxima and the transpose; blocks over the
closure tiles for stages 6-7 with the scaling. ``yardstick=True`` runs the
route those launches replaced — ``span_gather`` (``csrc/span_gather.cu``)
and a PyTorch op per stage — which they equal bit for bit; on a CPU tensor
that route runs with the plain span gather.

The JAX package's second front end, the W-shifted windowed gather
(``win_src/win_dst/win_mask/left_*``), exists because row gathers cost
the same at any width on the TPU; it is not ported (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .ops.assembly import assemble_store
from .ops.span_gather import span_gather, span_gather_plain

__all__ = ["AssemblyPlan", "plan_assembly", "assemble"]


@dataclasses.dataclass
class AssemblyPlan:
    """Static schedule of the assembly (host NumPy, int32).

    Every array also in the JAX package's ``WindowPlan`` holds the same
    values, except that the span rows are not padded to a TPU grid page:
    ``span_g/lo/hi`` have exactly ``(TF2 + 1) * cs`` entries.
    """

    TF2: int               # tiles of the UNPERMUTED pattern grid (+1 zero slot)
    # nd-embedding identity entries as (row, col) of the
    # ((TF2+1)*cs, cs) row view of the transposed store
    ones_row: np.ndarray
    ones_col: np.ndarray
    # per store row: value-stream span start g (into the stream front-padded
    # by cs zeros) and covered lane range [lo, hi)
    span_g: np.ndarray
    span_lo: np.ndarray
    span_hi: np.ndarray
    # per-element leftovers of contested rows
    span_left_src: np.ndarray
    span_left_row: np.ndarray
    span_left_col: np.ndarray
    brow2_tiles: np.ndarray   # (K, MT2) unpermuted tile ids per block row
    tile_brow2: np.ndarray    # (TF2+1,) block row of each unpermuted tile
    permrow_src: np.ndarray   # ((TF+2)*cs,) row-permutation gather map
    # identity-one positions of the final store, (row, col) of its
    # ((TF+2)*cs, cs) row view
    pad_row: np.ndarray
    pad_col: np.ndarray


def plan_assembly(
    A_pattern: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
    order: list,
    TF: int,
    n_pad_tail: np.ndarray,
    data_src: np.ndarray | None = None,
) -> AssemblyPlan:
    """Plan the assembly of the closure store ``order`` (``TF`` tiles).

    ``n_pad_tail`` — flat positions of the final store that receive an
    identity one. ``data_src`` (optional, one per pattern nonzero) maps
    each nonzero to its index in the value stream, -1 meaning a constant
    1.0 (the nd embedding's identity entries).
    """
    A = sp.csc_matrix(A_pattern)
    n = A.shape[0]
    K = -(-n // cs)
    qinv = np.argsort(q)

    rows = A.indices.astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    bj = qinv[cols]
    trow, r = rows // cs, rows % cs
    tcol, c = bj // cs, bj % cs

    # unpermuted tile grid (pattern tiles only; slot TF2 stays all-zero)
    keys2 = trow * K + tcol
    uk = np.unique(keys2)
    TF2 = int(len(uk))
    t2 = np.searchsorted(uk, keys2)
    destT = (t2 * cs + c) * cs + r  # transposed layout: (tile, col, row)

    # value-stream source index per pattern nonzero (-1 = constant 1.0)
    if data_src is None:
        src = np.arange(len(rows), dtype=np.int64)
        ones_dst = np.empty(0, dtype=np.int64)
    else:
        data_src = np.asarray(data_src, dtype=np.int64)
        real = data_src >= 0
        ones_dst = destT[~real]
        destT = destT[real]
        src = data_src[real]

    # maximal runs: consecutive destination AND consecutive source
    ne = len(destT)
    newrun = np.ones(ne, dtype=bool)
    if ne > 1:
        newrun[1:] = (destT[1:] != destT[:-1] + 1) | (src[1:] != src[:-1] + 1)
    run_start = np.nonzero(newrun)[0]
    run_d0 = destT[run_start]
    run_s0 = src[run_start]
    run_len = np.diff(np.append(run_start, ne))
    nruns = len(run_start)
    rid = np.cumsum(newrun) - 1

    # span plan: each store row (one tile column) is won by the run that
    # covers most of it; the losers' elements become leftovers
    n_rows = (TF2 + 1) * cs
    rf_c = run_d0 // cs
    rl_c = (run_d0 + run_len - 1) // cs
    cnt_c = rl_c - rf_c + 1
    tot_c = int(cnt_c.sum())
    cand_c = np.repeat(np.arange(nruns), cnt_c)
    off_c = (np.arange(tot_c, dtype=np.int64)
             - np.repeat(np.cumsum(cnt_c) - cnt_c, cnt_c))
    srow = rf_c[cand_c] + off_c
    lo_c = np.maximum(run_d0[cand_c], srow * cs)
    hi_c = np.minimum(run_d0[cand_c] + run_len[cand_c], (srow + 1) * cs)
    ordr_c = np.lexsort((lo_c - hi_c, srow))
    first_c = np.ones(tot_c, dtype=bool)
    ss = srow[ordr_c]
    if tot_c > 1:
        first_c[1:] = ss[1:] != ss[:-1]
    sel_c = ordr_c[first_c]
    span_g = np.zeros(n_rows, dtype=np.int32)
    span_lo = np.zeros(n_rows, dtype=np.int32)
    span_hi = np.zeros(n_rows, dtype=np.int32)
    w_rows = srow[sel_c]
    w_runs = cand_c[sel_c]
    # out[row, lane] = a_pad[g + lane], a_pad = cs zeros then the stream
    span_g[w_rows] = (cs + run_s0[w_runs] + w_rows * cs
                      - run_d0[w_runs]).astype(np.int32)
    span_lo[w_rows] = (lo_c[sel_c] - w_rows * cs).astype(np.int32)
    span_hi[w_rows] = (hi_c[sel_c] - w_rows * cs).astype(np.int32)
    if len(w_rows):
        pos_c = np.searchsorted(w_rows, destT // cs)
        cov_c = rid == w_runs[np.minimum(pos_c, len(w_runs) - 1)]
    else:
        cov_c = np.zeros(ne, dtype=bool)
    span_left_src = src[~cov_c].astype(np.int32)
    span_left = destT[~cov_c]

    # equilibration maps (unpermuted grid)
    browt: list = [[] for _ in range(K)]
    for t, key in enumerate(uk):
        browt[int(key // K)].append(t)
    MT2 = max(1, max(len(x) for x in browt))
    brow2_tiles = np.full((K, MT2), TF2, dtype=np.int32)
    for i, x in enumerate(browt):
        brow2_tiles[i, : len(x)] = x
    tile_brow2 = np.zeros(TF2 + 1, dtype=np.int32)
    tile_brow2[:TF2] = uk // K

    # row-permutation gather map: row (t, u) of closure tile t = (bi, tj)
    # holds original row p[bi*cs + u] restricted to tj's columns, i.e. row
    # p[...] % cs of unpermuted tile (p[...] // cs, tj), or the all-zero
    # slot TF2 when that tile is empty
    zero_row = TF2 * cs
    permrow_src = np.full(((TF + 2) * cs,), zero_row, dtype=np.int32)
    for t, (bi, tj) in enumerate(order):
        gr0 = bi * cs
        u_max = min(cs, n - gr0)
        if u_max <= 0:
            continue
        pr = p[gr0:gr0 + u_max].astype(np.int64)
        key = (pr // cs) * K + tj
        idx = np.searchsorted(uk, key)
        idx_c = np.minimum(idx, TF2 - 1)
        present = uk[idx_c] == key
        permrow_src[t * cs:t * cs + u_max] = np.where(
            present, idx_c * cs + pr % cs, zero_row)

    n_pad_tail = np.asarray(n_pad_tail, dtype=np.int64)
    return AssemblyPlan(
        TF2=TF2,
        ones_row=(ones_dst // cs).astype(np.int32),
        ones_col=(ones_dst % cs).astype(np.int32),
        span_g=span_g,
        span_lo=span_lo,
        span_hi=span_hi,
        span_left_src=span_left_src,
        span_left_row=(span_left // cs).astype(np.int32),
        span_left_col=(span_left % cs).astype(np.int32),
        brow2_tiles=brow2_tiles,
        tile_brow2=tile_brow2,
        permrow_src=permrow_src,
        pad_row=(n_pad_tail // cs).astype(np.int32),
        pad_col=(n_pad_tail % cs).astype(np.int32),
    )


def _inside(rows: np.ndarray, cols: np.ndarray, n_rows: int, cs: int):
    """Keep the (row, col) pairs inside an (n_rows, cs) view: the JAX
    package drops any other (``mode="drop"``), ``index_put_`` would raise."""
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < cs)
    return keep


def _by_tile(rows: np.ndarray, cols: np.ndarray, n_tiles: int, cs: int):
    """Group (row, col) positions of a ``(n_tiles·cs, cs)`` row view by
    tile ``row // cs``, keeping their order within a tile: returns the
    CSR offsets ``ptr`` (n_tiles + 1,), the order that sorts the
    positions by tile, and each position within its tile,
    ``(row % cs)·cs + col``."""
    rows = np.asarray(rows, dtype=np.int64)
    order = np.argsort(rows // cs, kind="stable")
    ptr = np.searchsorted(rows[order] // cs, np.arange(n_tiles + 1))
    pos = (rows[order] % cs) * cs + np.asarray(cols, dtype=np.int64)[order]
    return ptr.astype(np.int32), order, pos.astype(np.int32)


def assembly_device_arrays(plan: AssemblyPlan, cs: int, TF: int,
                           device) -> dict:
    """Upload the assembly schedule once: int64 index tensors for the
    PyTorch ops, int32 for the kernels, and (``k_*``) the kernels'
    per-tile groupings of the leftovers and nd ones (by unpermuted tile)
    and of the pads (by closure tile)."""
    n_rows2 = (plan.TF2 + 1) * cs
    n_rowsP = (TF + 2) * cs

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    keep_l = _inside(plan.span_left_row, plan.span_left_col, n_rows2, cs)
    keep_o = _inside(plan.ones_row, plan.ones_col, n_rows2, cs)
    keep_p = _inside(plan.pad_row, plan.pad_col, n_rowsP, cs)
    left_ptr, left_ord, left_pos = _by_tile(
        plan.span_left_row[keep_l], plan.span_left_col[keep_l],
        plan.TF2 + 1, cs)
    ones_ptr, _, ones_pos = _by_tile(plan.ones_row[keep_o],
                                    plan.ones_col[keep_o], plan.TF2 + 1, cs)
    pad_ptr, _, pad_pos = _by_tile(plan.pad_row[keep_p], plan.pad_col[keep_p],
                                  TF + 2, cs)
    i32 = torch.int32
    kernel = {
        "k_left_ptr": t(left_ptr, i32),
        "k_left_src": t(plan.span_left_src[keep_l][left_ord], i32),
        "k_left_pos": t(left_pos, i32),
        "k_ones_ptr": t(ones_ptr, i32),
        "k_ones_pos": t(ones_pos, i32),
        "k_pad_ptr": t(pad_ptr, i32),
        "k_pad_pos": t(pad_pos, i32),
        "k_permrow_src": t(plan.permrow_src, i32),
        "k_tile_brow2": t(plan.tile_brow2, i32),
        "k_brow2_tiles": t(plan.brow2_tiles, i32),
    }
    return kernel | {
        "span_g": t(plan.span_g, torch.int32),
        "span_lo": t(plan.span_lo, torch.int32),
        "span_hi": t(plan.span_hi, torch.int32),
        "left_src": t(plan.span_left_src[keep_l]),
        "left_row": t(plan.span_left_row[keep_l]),
        "left_col": t(plan.span_left_col[keep_l]),
        "ones_row": t(plan.ones_row[keep_o]),
        "ones_col": t(plan.ones_col[keep_o]),
        "brow2_tiles": t(plan.brow2_tiles),
        "tile_brow2": t(plan.tile_brow2),
        "permrow_src": t(plan.permrow_src),
        "pad_row": t(plan.pad_row[keep_p]),
        "pad_col": t(plan.pad_col[keep_p]),
    }


def assemble(a_data: torch.Tensor, dev: dict, *, n: int, cs: int, TF: int,
             TF2: int, plain: bool = False, yardstick: bool = False):
    """Device assembly: ``a_data`` (value stream, original CSC order) →
    the permuted, equilibrated closure store ``(TF+2, cs, cs)`` and ``Rs``
    (length ``n``, factor row order == original row order of the factored
    matrix). No host synchronisation.

    On a CUDA tensor: the two launches of ``ops/assembly.py``.
    ``yardstick=True`` runs ``span_gather`` and a PyTorch op per stage
    instead, ``plain=True`` the same with the span gather's plain PyTorch
    version (what a CPU tensor runs); all three agree bit for bit.
    """
    if not (plain or yardstick or a_data.device.type == "cpu"):
        return assemble_store(a_data, dev, n=n, cs=cs, TF=TF, TF2=TF2)
    dt = a_data.dtype
    n_rows = (TF2 + 1) * cs
    # 1. span gather from the stream front-padded by cs zeros
    a_pad = torch.zeros(cs + a_data.shape[0], dtype=dt, device=a_data.device)
    a_pad[cs:] = a_data
    gather = span_gather_plain if plain else span_gather
    rows2v = gather(a_pad, dev["span_g"], dev["span_lo"], dev["span_hi"], cs)
    # 2. leftovers of contested rows
    if dev["left_src"].numel():
        rows2v[dev["left_row"], dev["left_col"]] = a_data[dev["left_src"]]
    # 3. nd identity entries, before the equilibration (a device scalar:
    # no host copy, so the pipeline can be captured in a CUDA graph)
    one = torch.ones((), dtype=dt, device=a_data.device)
    if dev["ones_row"].numel():
        rows2v[dev["ones_row"], dev["ones_col"]] = one
    t2 = rows2v.view(TF2 + 1, cs, cs)  # transposed: (tile, col, row)
    # 4. row equilibration on the unpermuted store: max over the column
    # axis, then over the tiles of each block row
    m = t2.abs().amax(dim=1)                              # (TF2+1, cs)
    rowmax = m[dev["brow2_tiles"]].amax(dim=1)            # (K, cs)
    rs2d = torch.where(rowmax > 0, 1.0 / rowmax, torch.ones_like(rowmax))
    t2 = t2 * rs2d[dev["tile_brow2"]][:, None, :]
    rs = rs2d.reshape(-1)[:n]
    # 5-6. transpose back, then the row permutation as one row gather
    rows2 = t2.transpose(1, 2).reshape(n_rows, cs)
    rowsP = rows2[dev["permrow_src"]]
    # 7. identity pads
    if dev["pad_row"].numel():
        rowsP[dev["pad_row"], dev["pad_col"]] = one
    return rowsP.view(TF + 2, cs, cs), rs
