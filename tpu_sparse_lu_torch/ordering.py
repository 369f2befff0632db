"""Fill-reducing, parallelism-exposing orderings.

SURVEY.md §7 hard part 1: the level-scheduled solve's speedup hinges on
level *widths*, i.e. on the symbolic layer. SuperLU's default COLAMD
ordering minimises fill but produces a near-sequential chunk DAG on PDE
matrices (measured: 69 levels for 79 chunks on 2D Poisson — a chain). A
**nested-dissection** ordering gives a balanced elimination tree instead:
within each dissection level all separated subdomains eliminate
independently, so the chunk DAG becomes wide and shallow.

``nested_dissection`` is a light BFS-separator implementation (George-style
recursive bisection using pseudo-peripheral BFS level structures — the
classic cheap approximation; no METIS in this environment). For grid-like
PDE graphs it yields O(log) -depth trees; for irregular graphs it degrades
gracefully toward the natural order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["nested_dissection"]


def _bfs_levels(adj_indptr, adj_indices, nodes, start):
    """BFS level structure over the subgraph induced by ``nodes`` (bool
    mask over global ids), from ``start``. Returns (order, level)."""
    n = adj_indptr.shape[0] - 1
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = [start]
    order = [start]
    lv = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj_indices[adj_indptr[u]:adj_indptr[u + 1]]:
                if nodes[v] and level[v] < 0:
                    level[v] = lv + 1
                    nxt.append(v)
                    order.append(v)
        frontier = nxt
        lv += 1
    return order, level


def _dissect(adj_indptr, adj_indices, nodes_list, cutoff, depth0=0):
    """Dissect and return groups as (depth, nodes): bases and separators
    tagged with their recursion depth. A separator's ancestors always have
    strictly smaller depth."""
    groups = []
    stack = [(nodes_list, depth0)]
    while stack:
        nodes_list, d = stack.pop()
        if not nodes_list:
            continue
        if len(nodes_list) <= cutoff:
            groups.append((d, nodes_list))
            continue
        n_glob = adj_indptr.shape[0] - 1
        mask = np.zeros(n_glob, dtype=bool)
        mask[nodes_list] = True
        start = nodes_list[0]
        # pseudo-peripheral start: BFS twice
        order, lvl = _bfs_levels(adj_indptr, adj_indices, mask, start)
        far = order[-1]
        order, lvl = _bfs_levels(adj_indptr, adj_indices, mask, far)
        if len(order) < len(nodes_list):
            # disconnected: the components are independent at this depth
            rest = [u for u in nodes_list if lvl[u] < 0]
            stack.append((order, d))
            stack.append((rest, d))
            continue
        # split at the median BFS level; separator = the split level
        med = int(np.median(lvl[order]))
        half_a = [u for u in order if lvl[u] < med]
        sep = [u for u in order if lvl[u] == med]
        half_b = [u for u in order if lvl[u] > med]
        if not half_a or not half_b:
            groups.append((d, order))
            continue
        if sep:                        # median may be a non-attained level
            groups.append((d, sep))    # separator eliminated LAST (stage
        stack.append((half_b, d + 1))  # ordering below: larger depth first)
        stack.append((half_a, d + 1))
    return groups


def _dissect_banded(S: sp.csr_matrix, cutoff: int, cs: int):
    """Index-contiguous ("banded") dissection.

    Splits the natural index range recursively at the midpoint; the
    separator is the CONTIGUOUS range ``[mid, max(hi[a:mid])+1)`` that
    covers every edge crossing the cut (``hi[i]`` = largest neighbour of
    ``i`` in the symmetrized pattern, so rows left of the separator reach
    at most its end). For banded/PDE matrices in their natural order the
    separator width is the local bandwidth, every group is a contiguous
    index range, and the ldiv permutations collapse to near-block-copies
    (measured on 2D Poisson: the scattered BFS separators made the perms
    75% of the fused op stream). A range whose separator would be wider
    than a third of the range is not meaningfully banded — it is handed
    to the BFS dissection (:func:`_dissect`) at its current depth, so
    irregular matrices degrade gracefully to the general path.
    """
    n = S.shape[0]
    # per-row max neighbour; empty rows -> self
    hi = np.full(n, -1, dtype=np.int64)
    nz_rows = np.nonzero(np.diff(S.indptr))[0]
    hi[nz_rows] = np.maximum.reduceat(S.indices, S.indptr[nz_rows])
    hi = np.maximum(hi, np.arange(n, dtype=np.int64))

    def range_max(a, b):
        return int(hi[a:b].max())

    groups = []
    leaf = max(cutoff, cs)
    stack = [(0, n, 0)]
    while stack:
        a, b, d = stack.pop()
        if b - a <= 0:
            continue
        if b - a <= leaf:
            groups.append((d, list(range(a, b))))
            continue
        # cs-aligned split point: left children come out as exact
        # cs-multiples, so the bin packer emits them with zero padding
        mid = a + max(cs, ((b - a) // 2) // cs * cs)
        if mid >= b:
            groups.append((d, list(range(a, b))))
            continue
        s1 = min(max(range_max(a, mid) + 1, mid), b)
        if (s1 - mid) * 3 > (b - a):
            # not banded here: BFS-dissect this range at the same depth
            groups.extend(
                _dissect(S.indptr, S.indices, list(range(a, b)),
                         cutoff, depth0=d)
            )
            continue
        if s1 < b:
            stack.append((s1, b, d + 1))
        groups.append((d, list(range(mid, s1))))
        stack.append((a, mid, d + 1))
    return groups


def staged_extension(A: sp.spmatrix, cs: int, cutoff: int = None):
    """Chunk-aligned nested-dissection embedding.

    The staged ND order alone still chains at chunk granularity because
    group boundaries straddle the fixed ``cs`` chunk boundaries (measured:
    a group split across two chunks couples them, re-serialising the whole
    DAG). This embeds A into an EXTENDED matrix: groups are bin-packed
    into cs-sized bins stage by stage, bins padded with identity rows, so
    every chunk contains only same-stage (mutually independent) group
    rows. The chunk DAG depth then equals the dissection-tree height.

    Returns ``(A_ext, ext_src, ext_pos, data_src)``:
      A_ext     (n_ext x n_ext) csc with identity padding rows,
      ext_src   (n_ext,) original row per extended row, -1 for padding,
      ext_pos   (n,)     extended row per original row,
      data_src  (nnz_ext,) index into A_ext-ordered original nonzeros:
                 for each A_ext csc nonzero, the position in A.data (csc,
                 sorted) it came from, or -1 for a padding 1.0.
    """
    A = sp.csc_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    # default cutoff = cs: on the byte-bound fused kernel the stream cost
    # is tile COUNT x 64KB, and whole-chunk subdomains pack denser tiles
    # (measured, 2D Poisson n=10k cs=128: 309 -> 237 off-diag tiles per
    # factor, 8 -> 7 levels, model 103 -> 82 us vs the old cs//2 default)
    cutoff = cutoff if cutoff is not None else max(32, cs)
    S = (A + A.T).tocsr()
    S.sort_indices()
    groups = _dissect_banded(S, cutoff, cs)
    # bins per stage: first-fit-decreasing into cs-capacity bins; a group
    # larger than cs takes dedicated bins (its internal chain is real)
    from collections import defaultdict

    by_stage = defaultdict(list)
    for d, g in groups:
        by_stage[d].append(g)
    order_rows = []
    for d in sorted(by_stage.keys(), reverse=True):  # deepest first
        # LOCALITY-AWARE shelf packing of WHOLE groups: groups walked in
        # ascending min-row order, appended to the current bin while they
        # fit, oversize groups cut into dedicated cs-bins. Bins never
        # straddle a multi-bin group boundary INTO the next group — a
        # straddling bin would bridge the big group's internal band
        # coupling across every bin it spans and chain the whole stage
        # (measured: 9 → 52 chunk-DAG levels on 2D Poisson). Rows within
        # a bin are sorted by original index: combined with the banded
        # dissection's contiguous groups this keeps each bin a handful of
        # original-index runs, making the ldiv permutations block-sparse
        # (input-perm chunk pairs 2348 → ~380 on 2D Poisson; the perms
        # were 75% of the fused op stream).
        bins = []
        cur: list = []
        for g in sorted((g for g in by_stage[d] if g), key=min):
            if len(g) >= cs:
                if cur:
                    bins.append(cur)
                    cur = []
                for i in range(0, len(g), cs):
                    piece = list(g[i:i + cs])
                    if len(piece) == cs:
                        bins.append(piece)
                    else:
                        cur = piece  # tail rides with the next groups
                continue
            if len(cur) + len(g) > cs:
                bins.append(cur)
                cur = []
            cur.extend(g)
        if cur:
            bins.append(cur)
        for b in bins:
            b.sort()
            order_rows.extend(b)
            order_rows.extend([-1] * (cs - len(b)))  # identity padding
    ext_src = np.asarray(order_rows, dtype=np.int64)
    n_ext = ext_src.shape[0]
    ext_pos = np.full(n, -1, dtype=np.int64)
    real = ext_src >= 0
    ext_pos[ext_src[real]] = np.nonzero(real)[0]
    assert (ext_pos >= 0).all()

    # A_ext in COO: original entries mapped + identity pads
    rows = A.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    er = ext_pos[rows]
    ec = ext_pos[cols]
    pad_rows = np.nonzero(~real)[0]
    coo_r = np.concatenate([er, pad_rows])
    coo_c = np.concatenate([ec, pad_rows])
    vals = np.concatenate([A.data, np.ones(pad_rows.shape[0], dtype=A.data.dtype)])
    tag = np.concatenate([
        np.arange(A.data.shape[0], dtype=np.int64),
        np.full(pad_rows.shape[0], -1, dtype=np.int64),
    ])
    A_ext = sp.coo_matrix((vals, (coo_r, coo_c)), shape=(n_ext, n_ext)).tocsc()
    A_ext.sort_indices()
    # recover the source of each csc-ordered nonzero via a parallel pass
    key = sp.coo_matrix(
        (tag.astype(np.float64) + 2.0, (coo_r, coo_c)), shape=(n_ext, n_ext)
    ).tocsc()
    key.sort_indices()
    data_src = (key.data - 2.0).astype(np.int64)
    return A_ext, ext_src, ext_pos, data_src


def nested_dissection(A: sp.spmatrix, cutoff: int = 32) -> np.ndarray:
    """Symmetric fill-reducing ND permutation of A's pattern.

    Returns ``perm`` with the meaning "eliminate ``perm[0]`` first":
    reorder as ``A[perm][:, perm]``.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # symmetrized pattern
    S = (A + A.T).tocsr()
    S.sort_indices()
    groups = _dissect(S.indptr, S.indices, list(range(n)), cutoff)
    # STAGE ordering: deepest groups (leaf subdomains) eliminate first,
    # separators stage-by-stage toward the root — a valid topological
    # order of the dissection tree that keeps each stage's groups mutually
    # independent, so fixed-size chunks over the order yield a WIDE chunk
    # DAG instead of the interleaved post-order's chunk-level chain
    # (measured: interleaved = 63 levels on 2D Poisson, staged ~ tree
    # height).
    groups.sort(key=lambda g: -g[0])
    out: list = []
    for _, nodes in groups:
        out.extend(nodes)
    perm = np.asarray(out, dtype=np.int64)
    assert perm.shape[0] == n and np.array_equal(np.sort(perm), np.arange(n))
    return perm
