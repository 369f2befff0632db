"""The dense-tile LU kernel (B2): counterpart of
``tpu_sparse_lu/ops/pallas_factor.py``.

Factors tiles of a ``(N, cs, cs)`` bank in place into merged L\\U with no
pivoting (strict lower = L with an implicit unit diagonal, upper incl.
the diagonal = U), writes each tile's min |pivot|, and, when asked, both
triangular inverses ``L⁻¹`` and ``U⁻¹`` — the diagonal step of the blocked
elimination (``ops/elimination.py``). On a CUDA tensor the wrapper
launches ``csrc/lu_tile.cu``; on a CPU tensor it runs
:func:`lu_tile_plain`. ``lu_tile.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._launch import KERNEL_DTYPES, check, device_kind, lib, require, stream
from .tri_inverse import tri_inverse

__all__ = ["lu_nopivot", "lu_tile", "lu_tile_plain"]


def lu_nopivot(D: torch.Tensor) -> torch.Tensor:
    """Dense no-pivot LU of ``(..., cs, cs)`` tiles into merged L\\U: the
    rank-1 loop of ``tpu_sparse_lu.refactor._lu_nopivot``, every tile of
    the batch advanced at once. Returns a new tensor."""
    cs = D.shape[-1]
    ridx = torch.arange(cs, device=D.device)
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    for i in range(cs):
        piv = D[..., i, i][..., None]
        lower = ridx > i
        l = torch.where(lower, D[..., :, i] / piv, zero)
        urow = torch.where(lower, D[..., i, :], zero)  # columns > i
        D = D - l[..., :, None] * urow[..., None, :]
        D[..., :, i] = torch.where(lower, l, D[..., :, i])
    return D


def _inverses(M: torch.Tensor):
    """``(L⁻¹, U⁻¹)`` of merged L\\U tiles."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    linv = tri_inverse(torch.tril(M, -1) + eye, lower=True)
    uinv = tri_inverse(torch.triu(M), lower=False)
    return linv, uinv


def lu_tile_plain(tiles: torch.Tensor, ids: Optional[torch.Tensor] = None,
                  *, piv: Optional[torch.Tensor] = None,
                  linv: Optional[torch.Tensor] = None,
                  uinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`lu_tile` with :func:`lu_nopivot` and ``tri_inverse``."""
    sel = slice(None) if ids is None else ids.long()
    M = lu_nopivot(tiles[sel])
    tiles[sel] = M
    p = M.diagonal(dim1=-2, dim2=-1).abs().amin(dim=-1)
    if piv is None:
        piv = p
    else:
        piv.copy_(p)
    if linv is not None:
        li, ui = _inverses(M)
        linv.copy_(li)
        uinv.copy_(ui)
    return piv


def lu_tile(tiles: torch.Tensor, ids: Optional[torch.Tensor] = None, *,
            piv: Optional[torch.Tensor] = None,
            linv: Optional[torch.Tensor] = None,
            uinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Factor ``tiles[ids]`` (every tile when ``ids`` is None) in place.

    ``tiles`` contiguous ``(N, cs, cs)`` float32/float64; ``ids`` contiguous
    int32 ``(B,)`` of distinct tile indices. ``piv`` (B,) receives each
    tile's min |pivot| (allocated when None) and is returned; ``linv`` and
    ``uinv``, both given or both None, contiguous ``(B, cs, cs)``, receive
    the tiles' ``L⁻¹`` and ``U⁻¹``.
    """
    B = tiles.shape[0] if ids is None else ids.shape[0]
    require((linv is None) == (uinv is None),
            "linv and uinv are given together")
    extra = [t for t in (ids, piv, linv, uinv) if t is not None]
    if device_kind(tiles, *extra) == "cpu":
        return lu_tile_plain(tiles, ids, piv=piv, linv=linv, uinv=uinv)
    require(tiles.dtype in KERNEL_DTYPES, f"unsupported dtype {tiles.dtype}")
    require(tiles.dim() == 3 and tiles.shape[1] == tiles.shape[2]
            and tiles.is_contiguous(),
            "tiles must be a contiguous (N, cs, cs) bank")
    cs = tiles.shape[1]
    if ids is not None:
        require(ids.dtype == torch.int32 and ids.dim() == 1
                and ids.is_contiguous(), "ids must be contiguous int32 (B,)")
    if piv is None:
        piv = torch.empty(B, dtype=tiles.dtype, device=tiles.device)
    require(piv.dtype == tiles.dtype and piv.shape == (B,)
            and piv.is_contiguous(), "piv must be contiguous (B,)")
    for t in (linv, uinv):
        if t is not None:
            require(t.dtype == tiles.dtype and t.shape == (B, cs, cs)
                    and t.is_contiguous(),
                    "linv/uinv must be contiguous (B, cs, cs)")
    L = lib()
    require(cs <= L.max_chunk,
            f"the CUDA lu_tile kernel takes cs <= {L.max_chunk}, got {cs}")
    fn = getattr(L, f"lu_tile_{KERNEL_DTYPES[tiles.dtype]}")
    rc = fn(tiles.data_ptr(), None if ids is None else ids.data_ptr(), B,
            piv.data_ptr(), None if linv is None else linv.data_ptr(),
            None if uinv is None else uinv.data_ptr(), cs, stream(tiles))
    check(rc, "lu_tile")
    lu_tile.LAUNCHES += 1
    return piv


lu_tile.LAUNCHES = 0
