"""The span-gather kernel (B4): counterpart of
``tpu_sparse_lu/ops/pallas_span.py``.

``out[i, k] = a.flat[g[i] + k]`` for ``lo[i] <= k < hi[i]`` and 0
elsewhere: the first stage of the refactorization's tile-store assembly
(``assemble.py``), one store row per span of the CSC value stream. On a
CUDA tensor the wrapper launches ``csrc/span_gather.cu``; on a CPU tensor
it runs :func:`span_gather_plain`. It is a pure copy, so both agree bit
for bit. ``span_gather.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ._launch import KERNEL_DTYPES, check, device_kind, lib, require, stream

__all__ = ["span_gather", "span_gather_plain"]


def span_gather_plain(a: torch.Tensor, g: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, width: int) -> torch.Tensor:
    """Masked span gather with a ``torch.where``; a source index outside
    ``[0, a.numel())`` reads 0."""
    flat = a.reshape(-1)
    k = torch.arange(width, device=a.device)
    idx = g.long()[:, None] + k[None, :]
    inside = ((k[None, :] >= lo[:, None]) & (k[None, :] < hi[:, None])
              & (idx >= 0) & (idx < flat.numel()))
    vals = flat[idx.clamp(0, max(flat.numel() - 1, 0))]
    return torch.where(inside, vals, torch.zeros((), dtype=a.dtype,
                                                 device=a.device))


def span_gather(a: torch.Tensor, g: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, width: int) -> torch.Tensor:
    """Gather ``len(g)`` rows of ``width`` lanes from the spans of ``a``.

    ``a`` contiguous float32/float64 (read flat); ``g``, ``lo``, ``hi``
    contiguous int32 of one length. Returns a new ``(len(g), width)``
    tensor of ``a``'s dtype.
    """
    if device_kind(a, g, lo, hi) == "cpu":
        return span_gather_plain(a, g, lo, hi, width)
    require(a.dtype in KERNEL_DTYPES, f"unsupported dtype {a.dtype}")
    require(a.is_contiguous(), "a must be contiguous")
    n_rows = g.shape[0]
    for t in (g, lo, hi):
        require(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
                and t.shape[0] == n_rows,
                "g, lo, hi must be contiguous int32 vectors of one length")
    require(width >= 1, "width must be positive")
    out = torch.empty((n_rows, width), dtype=a.dtype, device=a.device)
    fn = getattr(lib(), f"span_gather_{KERNEL_DTYPES[a.dtype]}")
    rc = fn(out.data_ptr(), a.data_ptr(), g.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), a.numel(), n_rows, width, stream(a))
    check(rc, "span_gather")
    span_gather.LAUNCHES += 1
    return out


span_gather.LAUNCHES = 0
