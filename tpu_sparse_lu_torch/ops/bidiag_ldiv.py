"""The bidiagonal chain solve (kernel B5): counterpart of
``tpu_sparse_lu/ops/scan_solve.py`` ``pallas_bidiag_ldiv`` and, with one
sweep, of ``scan_bidiag_solve``.

For bidiagonal factors given as affine coefficient planes
(:func:`~tpu_sparse_lu_torch.ops.scan_solve.chain_planes`),

* ``lower=(aL, sL)`` — forward sweep ``y_i = aL_i·y_{i-1} + sL_i·b_i``;
* ``upper=(aU, sU)`` — backward sweep ``x_i = aU_i·x_{i+1} + sU_i·y_i``;

either of which may be ``None`` (``lsolve``/``rsolve`` of a chain run one
sweep). :func:`bidiag_ldiv` runs both in one launch of the hand-written
CUDA kernel ``csrc/bidiag.cu`` on a CUDA tensor, and the plain PyTorch
version :func:`bidiag_ldiv_plain` — the Kogge-Stone recurrence of the TPU
kernel, log2(n) shifted multiply-adds — on a CPU tensor.
``bidiag_ldiv.LAUNCHES`` counts kernel launches.

The kernel cuts the rows into tiles of :func:`tile_rows` rows, one block
per tile at a time, and composes each tile's entry value from the earlier
tiles' aggregate maps in a fixed order; :func:`bidiag_ldiv_tiled_plain`
mirrors that tiling and that order step by step in NumPy (the tests hold
it against the JAX package). Its ready flags, counters and aggregates live
in :func:`chain_words`, one set per CUDA stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ._launch import KERNEL_DTYPES as _KERNEL_DTYPES
from ._launch import check as _check
from ._launch import device_kind as _device_kind
from ._launch import lib as _lib
from ._launch import require as _require
from ._launch import stream as _stream

__all__ = ["bidiag_ldiv", "bidiag_ldiv_plain", "bidiag_ldiv_tiled_plain",
           "tile_rows", "chain_words"]

Planes = Optional[Tuple[torch.Tensor, torch.Tensor]]

# csrc/bidiag.cu: threads of a block, most maps a thread composes per chunk
THREADS = 256
ITEMS = 16
# tiles of a sweep: at least TILES_MIN where the rows allow it (short
# vectors spread over that many SMs), at most TILES_MAX (each tile composes
# every earlier tile's aggregate)
TILES_MIN = 32
TILES_MAX = 512


def _kogge_stone(a: torch.Tensor, c: torch.Tensor,
                 backward: bool) -> torch.Tensor:
    """Inclusive composition of the affine maps ``(a_i, c_i)`` along dim 0
    (from the end when ``backward``): ``a`` (n, 1), ``c`` (n, R)."""
    n = c.shape[0]
    d = 1
    while d < n:
        ones = a.new_ones((d, 1))
        zeros = c.new_zeros((d, c.shape[1]))
        if backward:
            a_s = torch.cat([a[d:], ones])
            c_s = torch.cat([c[d:], zeros])
        else:
            a_s = torch.cat([ones, a[:-d]])
            c_s = torch.cat([zeros, c[:-d]])
        c = a * c_s + c
        a = a * a_s
        d *= 2
    return c


def bidiag_ldiv_plain(b: torch.Tensor, lower: Planes = None,
                      upper: Planes = None) -> torch.Tensor:
    """The chain solve in plain PyTorch on any device; returns a new
    ``(n, R)`` tensor."""
    x = b
    if lower is not None:
        a, s = lower
        x = _kogge_stone(a[:, None], s[:, None] * x, backward=False)
    if upper is not None:
        a, s = upper
        x = _kogge_stone(a[:, None], s[:, None] * x, backward=True)
    return x.clone() if x is b else x


def _segments(g: int) -> int:
    """Threads per column for a group of ``g`` columns (``segments`` of
    csrc/bidiag.cu): the largest power of two ``s`` with ``s·g <=
    THREADS``."""
    s = 1
    while 2 * s * g <= THREADS:
        s *= 2
    return s


def tile_rows(n: int, R: int) -> int:
    """Rows of a tile of the chain kernel: one chunk
    (``segments · ITEMS`` rows) or fewer, so that a sweep has at least
    ``TILES_MIN`` tiles; more, in whole chunks, when a sweep would have
    more than ``TILES_MAX``."""
    chunk = _segments(min(R, THREADS)) * ITEMS
    rows = max(1, min(-(-n // TILES_MIN), chunk))
    if -(-n // rows) > TILES_MAX:
        rows = -(-(-(-n // TILES_MAX)) // chunk) * chunk
    return rows


# ---------------------------------------------------------------------------
# the kernel's tiling, step by step
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """``a·b + c`` rounded once for float32 (the product is exact in
    float64); for float64 rounded twice, the nearest NumPy comes."""
    if a.dtype == np.float32:
        return (a.astype(np.float64) * b + c).astype(np.float32)
    return a * b + c


def _scan_chunk(ap, cp, S, Kc):
    """csrc/bidiag.cu ``scan_chunk`` on one chunk: ``ap`` (S·Kc,), ``cp``
    (S·Kc, g). Returns per segment the column's inclusive map ``(A, C)``
    and the exclusive map's pieces ``(Ash, Csh, lead, PA, PC, has_p)``."""
    g = cp.shape[1]
    A = np.ones((S, 1), ap.dtype)
    C = np.zeros((S, g), ap.dtype)
    for kk in range(Kc):
        a = ap[np.arange(S) * Kc + kk][:, None]
        C = _fma(a, C, cp[np.arange(S) * Kc + kk])
        A = a * A
    W = min(S, 32)
    wl = np.arange(S) % W
    d = 1
    while d < W:
        src = np.where(wl >= d, np.arange(S) - d, np.arange(S))
        Ae, Ce = A[src], C[src]
        on = (wl >= d)[:, None]
        C = np.where(on, _fma(A, Ce, C), C)
        A = np.where(on, A * Ae, A)
        d *= 2
    src = np.where(wl >= 1, np.arange(S) - 1, np.arange(S))
    Ash, Csh, lead = A[src], C[src], wl == 0
    PA = np.ones((S, 1), ap.dtype)
    PC = np.zeros((S, g), ap.dtype)
    has_p = np.zeros(S, bool)
    if S > 32:
        wA, wC = A[31::32], C[31::32]
        for seg in range(S):
            for w in range(seg // 32):
                PC[seg] = _fma(wA[w], PC[seg], wC[w])
                PA[seg] = wA[w] * PA[seg]
                has_p[seg] = True
        on = has_p[:, None]
        C = np.where(on, _fma(A, PC, C), C)
        A = np.where(on, A * PA, A)
    return A, C, (Ash, Csh, lead, PA, PC, has_p)


def _chunks(length, S):
    """(p0, rc, Kc) of each chunk of a tile of ``length`` rows."""
    CR = S * ITEMS
    for p0 in range(0, length, CR):
        rc = min(CR, length - p0)
        yield p0, rc, -(-rc // S)


def _staged(av, cv, p0, rc, S, Kc):
    """A chunk's positions padded with identity maps to S·Kc."""
    ap = np.ones(S * Kc, av.dtype)
    cp = np.zeros((S * Kc, cv.shape[1]), cv.dtype)
    ap[:rc] = av[p0:p0 + rc]
    cp[:rc] = cv[p0:p0 + rc]
    return ap, cp


def _entry(aggs, k, cols):
    """csrc/bidiag.cu step 3: the aggregates of places 0..k-1 composed by
    32 lanes over fixed groups, then a shuffle tree; the map applied to 0.
    ``aggs`` [(A, C (R,))] in sweep order."""
    per = -(-k // 32)
    dt = aggs[0][1].dtype if aggs else np.float64
    MA = [np.ones((), dt) for _ in range(32)]
    MC = [np.zeros(len(cols), dt) for _ in range(32)]
    for lane in range(32):
        for q in range(lane * per, min(k, (lane + 1) * per)):
            Aq, Cq = aggs[q]
            MC[lane] = _fma(Aq, MC[lane], Cq[cols])
            MA[lane] = Aq * MA[lane]
    d = 1
    while d < 32:
        for lane in range(0, 32, 2 * d):
            RA, RC = MA[lane + d], MC[lane + d]
            MC[lane] = _fma(RA, MC[lane], RC)
            MA[lane] = RA * MA[lane]
        d *= 2
    return MC[0]


def _sweep_tiled(v, a, s, rows, back):
    n, R = v.shape
    tiles = -(-n // rows)
    out = np.empty_like(v)
    aggs = []
    for k in range(tiles):
        m = tiles - 1 - k if back else k
        r0, r1 = m * rows, min(n, m * rows + rows)
        idx = np.arange(r1 - 1, r0 - 1, -1) if back else np.arange(r0, r1)
        av = a[idx]
        cv = s[idx][:, None] * v[idx]
        length = r1 - r0
        tA, tC = np.ones((), v.dtype), np.zeros(R, v.dtype)
        walks = []
        for jg in range(0, R, THREADS):
            cols = np.arange(jg, min(R, jg + THREADS))
            S = _segments(len(cols))
            gA = np.ones((), v.dtype)
            gC = np.zeros(len(cols), v.dtype)
            for p0, rc, Kc in _chunks(length, S):
                ap, cp = _staged(av, cv[:, cols], p0, rc, S, Kc)
                A, C, ex = _scan_chunk(ap, cp, S, Kc)
                gC = _fma(A[S - 1, 0], gC, C[S - 1])
                gA = A[S - 1, 0] * gA
            tC[cols] = gC
            if jg == 0:
                tA = gA
            walks.append((cols, S))
        aggs.append((tA, tC))
        y_tile = np.empty((length, R), v.dtype)
        for cols, S in walks:
            carry = _entry(aggs, k, cols)
            for p0, rc, Kc in _chunks(length, S):
                ap, cp = _staged(av, cv[:, cols], p0, rc, S, Kc)
                _, _, (Ash, Csh, lead, PA, PC, has_p) = _scan_chunk(
                    ap, cp, S, Kc)
                y = np.broadcast_to(carry, (S, len(cols))).copy()
                y = np.where(has_p[:, None], _fma(PA, y, PC), y)
                y = np.where(lead[:, None], y, _fma(Ash, y, Csh))
                walked = np.empty_like(cp)
                for kk in range(Kc):
                    p = np.arange(S) * Kc + kk
                    y = _fma(ap[p][:, None], y, cp[p])
                    walked[p] = y
                carry = y[S - 1]
                y_tile[p0:p0 + rc, cols] = walked[:rc]
        out[idx] = y_tile
    return out


def bidiag_ldiv_tiled_plain(b: torch.Tensor, lower: Planes = None,
                            upper: Planes = None,
                            rows: Optional[int] = None) -> torch.Tensor:
    """The chain solve as ``csrc/bidiag.cu`` computes it, in NumPy on the
    host: tiles of ``rows`` rows (default :func:`tile_rows`), each tile's
    aggregate from its chunks, its entry value from the earlier tiles'
    aggregates in the kernel's fixed order, then the serial walk from each
    thread's entry. Float32 multiply-adds are rounded once, as the
    kernel's ``fma``; float64 ones twice. Returns a new CPU tensor."""
    v = b.detach().cpu().numpy()
    n, R = v.shape
    rows = tile_rows(n, R) if rows is None else int(rows)
    _require(rows >= 1, "rows must be positive")
    if n == 0:
        return torch.as_tensor(v.copy())
    for planes, back in ((lower, False), (upper, True)):
        if planes is not None:
            a, s = (t.detach().cpu().numpy() for t in planes)
            v = _sweep_tiled(v, a, s, rows, back)
    return torch.as_tensor(v.copy())


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_WORDS = {}     # (tickets, R, dtype, device, stream) -> (state, aggregates)
_CAPACITY = {}  # (dtype, device) -> resident blocks
_LAUNCH = {}    # per call shape and stream: the entry, rows, grid, words


def chain_words(tickets: int, R: int, dtype: torch.dtype, device,
                stream: int = 0):
    """The kernel's int32 words and aggregate scratch for ``tickets``
    tickets of ``R`` columns on the raw CUDA stream ``stream``, made once
    and then left to the kernel: ticket counter, exit counter, generation
    (starts at 1), then two flags per ticket (start at 0); and
    ``tickets · (R + 1)`` values of ``dtype`` for the tiles' aggregate
    maps. Launches on one stream run one after another, so each stream's
    set serves one launch at a time."""
    dev = torch.device(device)
    key = (tickets, R, dtype, dev, stream)
    words = _WORDS.get(key)
    if words is None:
        state = torch.zeros(3 + 2 * tickets, dtype=torch.int32, device=dev)
        state[2] = 1
        words = (state, torch.empty(tickets * (R + 1), dtype=dtype,
                                    device=dev))
        _WORDS[key] = words
    return words


def _reset_cache() -> None:
    """Forget the library's entries and capacities (the kernel library was
    swapped)."""
    _CAPACITY.clear()
    _LAUNCH.clear()


def _launch_args(b: torch.Tensor, sweeps: int, grid, stream: int):
    """(entry, rows, grid, state pointer, aggregate pointer) of a launch,
    made once per call shape and stream."""
    n, R = b.shape
    dt = b.dtype
    _require(dt in _KERNEL_DTYPES, f"unsupported dtype {dt}")
    rows = tile_rows(n, R)
    name = f"bidiag_ldiv_{_KERNEL_DTYPES[dt]}"
    if grid is None:
        key = (dt, b.device)
        grid = _CAPACITY.get(key)
        if grid is None:
            cap = getattr(_lib(), f"{name}_capacity")()
            if cap < 0:
                _check(-cap, "bidiag_ldiv")
            grid = _CAPACITY[key] = cap
    _require(int(grid) >= 1, "grid must be positive")
    state, agg = chain_words(sweeps * -(-n // rows), R, dt, b.device, stream)
    return (getattr(_lib(), name), rows, int(grid), state.data_ptr(),
            agg.data_ptr())


def bidiag_ldiv(b: torch.Tensor, lower: Planes = None, upper: Planes = None,
                *, grid: Optional[int] = None) -> torch.Tensor:
    """Solve with bidiagonal factors: the forward sweep of ``lower``, then
    the backward sweep of ``upper`` (at least one of them).

    ``b`` (n, R) float32/float64; each plane (n,) of ``b``'s dtype.
    Returns a new (n, R) tensor. On the card: one launch, ``grid`` blocks
    (default: as many as the card holds at once; any number from 1 up
    gives the same bits), tiles of :func:`tile_rows` rows. The checks build no message unless they fail and
    the launch's words are looked up once per shape and stream: the
    wrapper's host time is most of a short chain's solve.
    """
    if lower is None and upper is None:
        raise ValueError("bidiag_ldiv needs the lower planes, the upper "
                         "planes or both")
    if b.dim() != 2:
        raise ValueError("b must be (n, R)")
    n, R = b.shape
    aL, sL = lower if lower is not None else (None, None)
    aU, sU = upper if upper is not None else (None, None)
    planes = (aL, sL) if upper is None else (
        (aU, sU) if lower is None else (aL, sL, aU, sU))
    dt = b.dtype
    contiguous = b.is_contiguous()
    for t in planes:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"planes must be ({n},) vectors, got "
                             f"{tuple(t.shape)}")
        contiguous = contiguous and t.dtype == dt and t.is_contiguous()
    if _device_kind(b, *planes) == "cpu":
        return bidiag_ldiv_plain(b, lower, upper)
    if not contiguous:
        raise ValueError("b and the planes must be contiguous, of one dtype")
    stream = _stream(b)
    key = (dt, b.device, n, R, len(planes), stream, grid)
    args = _LAUNCH.get(key)
    if args is None:
        args = _LAUNCH[key] = _launch_args(b, len(planes) // 2, grid, stream)
    fn, rows, grid_, state, agg = args
    x = torch.empty_like(b)
    rc = fn(x.data_ptr(), b.data_ptr(),
            None if aL is None else aL.data_ptr(),
            None if sL is None else sL.data_ptr(),
            None if aU is None else aU.data_ptr(),
            None if sU is None else sU.data_ptr(),
            agg, state, n, R, rows, grid_, stream)
    _check(rc, "bidiag_ldiv")  # raises, or counts the launch in its span
    bidiag_ldiv.LAUNCHES += 1
    return x


bidiag_ldiv.LAUNCHES = 0
