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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._launch import KERNEL_DTYPES as _KERNEL_DTYPES
from ._launch import check as _check
from ._launch import device_kind as _device_kind
from ._launch import lib as _lib
from ._launch import require as _require
from ._launch import stream as _stream

__all__ = ["bidiag_ldiv", "bidiag_ldiv_plain"]

Planes = Optional[Tuple[torch.Tensor, torch.Tensor]]


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


def bidiag_ldiv(b: torch.Tensor, lower: Planes = None,
                upper: Planes = None) -> torch.Tensor:
    """Solve with bidiagonal factors: the forward sweep of ``lower``, then
    the backward sweep of ``upper`` (at least one of them).

    ``b`` (n, R) float32/float64; each plane (n,) of ``b``'s dtype.
    Returns a new (n, R) tensor.
    """
    _require(lower is not None or upper is not None,
             "bidiag_ldiv needs the lower planes, the upper planes or both")
    planes = [t for p in (lower, upper) if p is not None for t in p]
    n = b.shape[0]
    _require(b.dim() == 2, "b must be (n, R)")
    for t in planes:
        _require(t.dim() == 1 and t.shape[0] == n,
                 f"planes must be ({n},) vectors, got {tuple(t.shape)}")
    if _device_kind(b, *planes) == "cpu":
        return bidiag_ldiv_plain(b, lower, upper)
    _require(b.dtype in _KERNEL_DTYPES, f"unsupported dtype {b.dtype}")
    _require(b.is_contiguous() and all(
        t.dtype == b.dtype and t.is_contiguous() for t in planes),
        "b and the planes must be contiguous, of one dtype")
    R = b.shape[1]
    x = torch.empty_like(b)
    aL, sL = (None, None) if lower is None else (t.data_ptr() for t in lower)
    aU, sU = (None, None) if upper is None else (t.data_ptr() for t in upper)
    fn = getattr(_lib(), f"bidiag_ldiv_{_KERNEL_DTYPES[b.dtype]}")
    rc = fn(x.data_ptr(), b.data_ptr(), aL, sL, aU, sU, n, R, _stream(b))
    _check(rc, "bidiag_ldiv")
    bidiag_ldiv.LAUNCHES += 1
    return x


bidiag_ldiv.LAUNCHES = 0
