"""The tile-store assembly kernels (B4): counterpart of
``tpu_sparse_lu/ops/pallas_span.py`` ``span_gather`` and of the stages the
JAX package runs around it (``tpu_sparse_lu/assemble.py``).

:func:`assemble_store` builds the permuted, equilibrated closure store
``(TF+2, cs, cs)`` and ``Rs`` from the value stream in two launches of
``csrc/assemble.cu``:

* :func:`assemble_tiles` — per part of ``PART`` columns of an unpermuted
  tile: the span gather, the tile's own leftovers and nd ones, the part
  written in (row, col) order, and each row's max |.| folded into the
  row's max over its block row (``rowmax`` (K, cs));
* :func:`assemble_closure` — per part of ``PART`` rows of a closure tile:
  the row permutation times each row's ``rs = 1 / rowmax`` (1 where the
  max is not > 0), then the identity pads; and ``Rs = rs.flat[:n]``.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch twin (``*_plain``) on a CPU tensor; each counts its launches in
``LAUNCHES``. The twins do the same operations on every value (a copy,
|.|, a max, one reciprocal, one multiply), so both routes equal
``assemble.assemble``'s PyTorch route bit for bit. ``dev`` is the dict of
``assemble.assembly_device_arrays``: the per-tile groupings (CSR offsets
by tile) of the leftovers, nd ones and pads are its ``k_*`` arrays.
"""

from __future__ import annotations

import torch

from ._launch import KERNEL_DTYPES, check, device_kind, require, stream
from ._launch import lib as _lib
from .span_gather import span_gather_plain

__all__ = ["assemble_store", "assemble_store_plain", "assemble_tiles",
           "assemble_tiles_plain", "assemble_closure",
           "assemble_closure_plain"]

_FN = {}  # (entry, dtype) -> the library's entry
# csrc/assemble.cu: columns (rows) of a tile (closure tile) per block
PART = 32


def _reset_cache() -> None:
    """Forget the library's entries (the kernel library was swapped)."""
    _FN.clear()


def _fn(name: str, dt: torch.dtype):
    f = _FN.get((name, dt))
    if f is None:
        f = _FN[(name, dt)] = getattr(_lib(), f"{name}_{KERNEL_DTYPES[dt]}")
    return f


def _flat(ptr: torch.Tensor, pos: torch.Tensor, cs: int) -> torch.Tensor:
    """Flat positions ``tile·cs² + pos`` of a per-tile grouping."""
    tile = torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=pos.device), (ptr[1:] - ptr[:-1])
        .long())
    return tile * cs * cs + pos.long()


def assemble_tiles_plain(a: torch.Tensor, dev: dict, cs: int, TF2: int):
    """The unpermuted store ``((TF2+1)·cs, cs)`` in (tile, row, col)
    order, unscaled, and each row's max |.| over its block row's tiles,
    ``rowmax`` (K, cs)."""
    a_pad = torch.zeros(cs + a.shape[0], dtype=a.dtype, device=a.device)
    a_pad[cs:] = a
    rows2v = span_gather_plain(a_pad, dev["span_g"], dev["span_lo"],
                               dev["span_hi"], cs)
    flat = rows2v.view(-1)
    if dev["k_left_pos"].numel():
        flat[_flat(dev["k_left_ptr"], dev["k_left_pos"], cs)] = \
            a[dev["k_left_src"].long()]
    if dev["k_ones_pos"].numel():
        flat[_flat(dev["k_ones_ptr"], dev["k_ones_pos"], cs)] = torch.ones(
            (), dtype=a.dtype, device=a.device)
    t2 = rows2v.view(TF2 + 1, cs, cs)  # (tile, col, row)
    m = t2.abs().amax(dim=1)
    rowmax = m[dev["k_brow2_tiles"].long()].amax(dim=1)
    return t2.transpose(1, 2).reshape(-1, cs), rowmax


def assemble_closure_plain(rows2: torch.Tensor, rowmax: torch.Tensor,
                           dev: dict, n: int, cs: int, TF: int):
    """The closure store ``(TF+2, cs, cs)``: permuted rows times their
    ``rs``, then the identity pads; and ``Rs`` (n,)."""
    rs2d = torch.where(rowmax > 0, 1.0 / rowmax, torch.ones_like(rowmax))
    scaled = rows2.view(-1, cs, cs) * rs2d[dev["k_tile_brow2"].long()][
        :, :, None]
    out = scaled.reshape(-1, cs)[dev["k_permrow_src"].long()]
    if dev["k_pad_pos"].numel():
        out.view(-1)[_flat(dev["k_pad_ptr"], dev["k_pad_pos"], cs)] = \
            torch.ones((), dtype=out.dtype, device=out.device)
    return out.view(TF + 2, cs, cs), rs2d.reshape(-1)[:n]


def assemble_tiles(a: torch.Tensor, dev: dict, cs: int, TF2: int):
    """:func:`assemble_tiles_plain` in one launch, a block per part of a
    tile."""
    if device_kind(a) == "cpu":
        return assemble_tiles_plain(a, dev, cs, TF2)
    require(a.dtype in KERNEL_DTYPES and a.dim() == 1 and a.is_contiguous(),
            "a must be a contiguous float32/float64 vector")
    require(1 <= cs <= _lib().max_chunk and dev["span_g"].numel() ==
            (TF2 + 1) * cs, "cs too large, or the span rows do not fit TF2")
    rows2 = torch.empty(((TF2 + 1) * cs, cs), dtype=a.dtype, device=a.device)
    # +0.0 is zero bits: the kernel folds the maxima in with atomicMax
    rowmax = torch.zeros((dev["k_brow2_tiles"].shape[0], cs), dtype=a.dtype,
                         device=a.device)
    rc = _fn("assemble_tiles", a.dtype)(
        rows2.data_ptr(), rowmax.data_ptr(), dev["k_tile_brow2"].data_ptr(),
        a.data_ptr(), dev["span_g"].data_ptr(), dev["span_lo"].data_ptr(),
        dev["span_hi"].data_ptr(), dev["k_left_ptr"].data_ptr(),
        dev["k_left_src"].data_ptr(), dev["k_left_pos"].data_ptr(),
        dev["k_ones_ptr"].data_ptr(), dev["k_ones_pos"].data_ptr(),
        a.shape[0], TF2 + 1, cs, stream(a))
    check(rc, "assemble_tiles")
    assemble_tiles.LAUNCHES += 1
    return rows2, rowmax


def assemble_closure(rows2: torch.Tensor, rowmax: torch.Tensor, dev: dict,
                     n: int, cs: int, TF: int):
    """:func:`assemble_closure_plain` in one launch, a block per part of
    a closure tile (and a few for ``Rs``)."""
    if device_kind(rows2, rowmax) == "cpu":
        return assemble_closure_plain(rows2, rowmax, dev, n, cs, TF)
    require(rows2.dtype == rowmax.dtype and rows2.dtype in KERNEL_DTYPES
            and rows2.is_contiguous() and rowmax.is_contiguous(),
            "rows2 and rowmax must be contiguous, of one float dtype")
    require(dev["k_permrow_src"].numel() == (TF + 2) * cs
            and n <= rowmax.numel(), "permrow_src or n do not fit TF and cs")
    out = torch.empty((TF + 2, cs, cs), dtype=rows2.dtype,
                      device=rows2.device)
    rs = torch.empty(n, dtype=rows2.dtype, device=rows2.device)
    rc = _fn("assemble_closure", rows2.dtype)(
        out.data_ptr(), rs.data_ptr(), rows2.data_ptr(), rowmax.data_ptr(),
        dev["k_permrow_src"].data_ptr(), dev["k_tile_brow2"].data_ptr(),
        dev["k_pad_ptr"].data_ptr(), dev["k_pad_pos"].data_ptr(), TF + 2, cs,
        n, stream(rows2))
    check(rc, "assemble_closure")
    assemble_closure.LAUNCHES += 1
    return out, rs


for _f in (assemble_tiles, assemble_closure):
    _f.LAUNCHES = 0


def assemble_store(a_data: torch.Tensor, dev: dict, *, n: int, cs: int,
                   TF: int, TF2: int):
    """The closure store ``(TF+2, cs, cs)`` and ``Rs`` (n,) from the value
    stream: :func:`assemble_tiles`, then :func:`assemble_closure`."""
    rows2, rowmax = assemble_tiles(a_data, dev, cs, TF2)
    return assemble_closure(rows2, rowmax, dev, n, cs, TF)


def assemble_store_plain(a_data: torch.Tensor, dev: dict, *, n: int, cs: int,
                         TF: int, TF2: int):
    """:func:`assemble_store` with the plain twins, on any device."""
    rows2, rowmax = assemble_tiles_plain(a_data, dev, cs, TF2)
    return assemble_closure_plain(rows2, rowmax, dev, n, cs, TF)
