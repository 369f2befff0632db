"""The solve banks' extraction at the end of the device refactorization,
in one launch of ``csrc/extract.cu``. It replaces no TPU kernel: the JAX
package extracts with ``jnp`` ops (``tpu_sparse_lu/refactor.py``
``_extract_solve_tiles`` and the gathers after it).

From the eliminated store ``(TF+2, cs, cs)``, the per-level inverse
stacks ``linv``/``uinv`` (``(NL, BL, cs, cs)``, any leading shape) and the
plan's maps (``RefactorDevice.diag_src``, ``l_off_src``, ``u_off_src``,
``diag_lvlslot``, int64), :func:`extract_banks` returns

* ``lbank``/``ubank`` ``(K+T+2, cs, cs)``: the solve's transposed tile
  banks ``[diag_inv (K); I; −offdiag (T); 0]``, T the bank's off-diagonal
  tile count;
* ``ldiag``/``udiag`` ``(K+1, cs, cs)``: ``tril(d, -1) + I`` and
  ``triu(d)`` of each diagonal tile, the identity at K;
* ``growth`` (0-d): max |.| over ``udiag`` and both banks' off-diagonal
  tiles (NaN if any of them holds one).

On a CUDA tensor it is one launch (after a zeroing of ``growth`` on the
same stream), counted in ``extract_banks.LAUNCHES``; on a CPU tensor it
runs the plain PyTorch twin, :func:`extract_banks_plain`, which
``refactor_pipeline(..., plain=True)`` runs on any device. Both give the
same bits.
"""

from __future__ import annotations

import torch

from ._launch import KERNEL_DTYPES, check, device_kind, require, stream
from ._launch import lib as _lib

__all__ = ["extract_banks", "extract_banks_plain"]

def _bank(dinv_real: torch.Tensor, off_real: torch.Tensor) -> torch.Tensor:
    """The solve's transposed tile bank ``[diag_inv (K+1); −offdiag (T+1)]``
    from the real tiles, with the dummy slots scrubbed to identity / zero
    (the elimination never writes the dummy tile, but the solve bank's
    layout has one slot of each kind)."""
    cs = dinv_real.shape[-1]
    eye = torch.eye(cs, dtype=dinv_real.dtype, device=dinv_real.device)[None]
    zero = torch.zeros_like(eye)
    return torch.cat([dinv_real, eye, -off_real, zero]).transpose(1, 2) \
        .contiguous()


def extract_banks_plain(store, linv, uinv, diag_src, l_off_src, u_off_src,
                        diag_lvlslot):
    """:func:`extract_banks` as PyTorch ops, on any device."""
    cs = store.shape[-1]
    eye = torch.eye(cs, dtype=store.dtype, device=store.device)
    diag = store[diag_src]
    ldiag = torch.cat([torch.tril(diag, -1) + eye, eye[None]])
    udiag = torch.cat([torch.triu(diag), eye[None]])
    loff = store[l_off_src]
    uoff = store[u_off_src]
    # pivot growth: rows of (Rs·A)[p,q] have max |entry| == 1 after the
    # equilibration, so max |factor entry| is the growth factor
    parts = [udiag.abs().amax()]
    parts += [t.abs().amax() for t in (loff, uoff) if t.numel()]
    growth = torch.stack(parts).amax()
    ls = diag_lvlslot
    lbank = _bank(linv.reshape(-1, cs, cs)[ls], loff)
    ubank = _bank(uinv.reshape(-1, cs, cs)[ls], uoff)
    return lbank, ubank, ldiag, udiag, growth


def extract_banks(store, linv, uinv, diag_src, l_off_src, u_off_src,
                  diag_lvlslot):
    """``(lbank, ubank, ldiag, udiag, growth)``: one launch of
    ``csrc/extract.cu`` on CUDA tensors, :func:`extract_banks_plain` on
    CPU tensors."""
    maps = (diag_src, l_off_src, u_off_src, diag_lvlslot)
    if device_kind(store, linv, uinv, *maps) == "cpu":
        return extract_banks_plain(store, linv, uinv, *maps)
    dt = store.dtype
    require(dt in KERNEL_DTYPES and linv.dtype == dt and uinv.dtype == dt,
            "store, linv and uinv must be of one dtype, float32 or float64")
    cs = store.shape[-1]
    require(store.dim() == 3 and store.shape[1] == cs
            and 1 <= cs <= _lib().max_chunk and linv.shape == uinv.shape
            and linv.dim() >= 2 and linv.shape[-2:] == store.shape[1:],
            "store must be (tiles, cs, cs) with cs <= the kernels' largest "
            "chunk, and linv, uinv of one shape ending in (cs, cs)")
    require(store.is_contiguous() and linv.is_contiguous()
            and uinv.is_contiguous()
            and all(m.dtype == torch.int64 and m.dim() == 1
                    and m.is_contiguous() for m in maps)
            and diag_src.shape == diag_lvlslot.shape,
            "store, linv and uinv must be contiguous, and the maps "
            "contiguous int64 vectors with diag_src and diag_lvlslot of "
            "one length")
    K, TL, TU = diag_src.shape[0], l_off_src.shape[0], u_off_src.shape[0]
    dev = store.device
    lbank = torch.empty((K + TL + 2, cs, cs), dtype=dt, device=dev)
    ubank = torch.empty((K + TU + 2, cs, cs), dtype=dt, device=dev)
    ldiag = torch.empty((K + 1, cs, cs), dtype=dt, device=dev)
    udiag = torch.empty_like(ldiag)
    growth = torch.empty((), dtype=dt, device=dev)
    fn = getattr(_lib(), f"extract_banks_{KERNEL_DTYPES[dt]}")
    rc = fn(lbank.data_ptr(), ubank.data_ptr(), ldiag.data_ptr(),
            udiag.data_ptr(), growth.data_ptr(), store.data_ptr(),
            linv.data_ptr(), uinv.data_ptr(), diag_src.data_ptr(),
            l_off_src.data_ptr(), u_off_src.data_ptr(),
            diag_lvlslot.data_ptr(), K, TL, TU, store.shape[0],
            linv.numel() // (cs * cs), cs, stream(store))
    check(rc, "extract_banks")
    extract_banks.LAUNCHES += 1
    return lbank, ubank, ldiag, udiag, growth


extract_banks.LAUNCHES = 0
