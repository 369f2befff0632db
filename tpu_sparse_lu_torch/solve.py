"""Level-scheduled blocked triangular solves: counterpart of
``tpu_sparse_lu/solve.py``.

The reference's ``lsolve!``/``rsolve!`` run a serial chunk loop of BLAS
``trsv!`` + ``gemm!`` (reference src/SharedMemSparseLU.jl:349-367,
:374-392). Here the chunk DAG is layered into levels on the host
(``plan_triangular``) and each level runs as two steps
(:func:`~tpu_sparse_lu_torch.ops.fused_ldiv.build_waves`):

* the diagonal step over the level's chunks (the reference's ``trsv!``),
  by ``tri_mode``: ``"inv"`` — the diagonal wave ``x_k ← Dinv_k · x_k``
  with pre-inverted tiles; ``"trsm"`` — substitution with the tiles
  ``D_k`` themselves, every chunk of the level in one launch
  (:func:`~tpu_sparse_lu_torch.ops.fused_ldiv.diag_trsm`);
  ``"inv_refine"`` — the diagonal wave, then one correction
  ``y += Dinv_k · (r − D_k · y)``;
* the off-diagonal wave ``x_dst += Σ off_t · x_src(t)`` over the tiles
  whose source chunk lies in the level (the reference's ``gemm!``, tiles
  pre-negated), in every mode.

:class:`DeviceFactors` holds a solver's whole device numeric state and
runs its direct solve: one launch of ``fused_ldiv`` at ``"inv"``, the
level steps below in the other modes, or the chain kernel for bidiagonal
factors. :func:`refine` is the one iterative-refinement loop.

The right-hand side is carried chunk-blocked as ``xw : (K+1, cs, R)``;
block ``K`` is the padding slot the JAX engine needs for its padded level
arrays. The waves touch only real chunks, so it stays zero here. One
executor serves every device: the JAX ``scan``/``unrolled`` split is a
compile-time concern of XLA and is not carried over.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from functools import partial
from typing import Callable, List, Optional

import torch

from .ops.bidiag_ldiv import bidiag_ldiv, bidiag_ldiv_plain
from .ops.fused_ldiv import (
    LdivSchedule,
    Wave,
    build_waves,
    diag_trsm,
    diag_trsm_plain,
    fused_ldiv,
    fused_ldiv_bf16,
    perm_gather,
    perm_gather_plain,
    wave_apply,
    wave_apply_bf16,
    wave_apply_plain,
)
from .ops.tri_inverse import tri_inverse
from .symbolic import TriPlan
from .trace import span

__all__ = [
    "TriKernelData",
    "prepare_tri_kernel",
    "tri_kernel_from_bank",
    "blocked_tri_solve",
    "block_rhs",
    "unblock_rhs",
    "DeviceFactors",
    "refine",
]


@dataclasses.dataclass
class TriKernelData:
    """Device data for one triangular factor.

    ``tiles_t`` is the factor's tile bank, every tile transposed (the
    layout the kernel reads coalesced): the ``K+1`` diagonal-tile inverses,
    then the ``T+1`` negated off-diagonal tiles, dummy slots included; one
    layout in every ``tri_mode``. ``diag`` keeps the ``K+1`` diagonal tiles
    themselves (padding rows and the dummy slot = I): the ``"trsm"`` and
    ``"inv_refine"`` diagonal steps read them, and after a device
    refactorization ``ParallelSparseLU``'s host factors are made from
    them. ``lower`` — which triangle. ``tiles_bf16`` is a bfloat16 copy of
    ``tiles_t`` under ``SolverConfig.stream_dtype="bfloat16"``: the tile
    stream ``ldiv``'s waves read; the bank itself stays at the solver's
    dtype (``F.L``/``F.U`` and ``lsolve``/``rsolve`` read it).
    """

    K: int
    T: int
    lower: bool
    tiles_t: torch.Tensor  # (K+1+T+1, cs, cs)
    waves: List[Wave]
    diag: torch.Tensor  # (K+1, cs, cs)
    tiles_bf16: Optional[torch.Tensor] = None  # (K+1+T+1, cs, cs)

    @property
    def diag_inv(self) -> torch.Tensor:
        """(K+1, cs, cs) diagonal-tile inverses (padding rows = I)."""
        return self.tiles_t[: self.K + 1].transpose(1, 2)

    @property
    def offdiag(self) -> torch.Tensor:
        """(T+1, cs, cs) negated off-diagonal tiles."""
        return self.tiles_t[self.K + 1:].transpose(1, 2)


def prepare_tri_kernel(plan: TriPlan, diag: torch.Tensor,
                       offdiag: torch.Tensor, *,
                       bf16_stream: bool = False) -> TriKernelData:
    """Invert the packed diagonal tiles and build the wave schedule
    (``bf16_stream``: and the bfloat16 copy of the bank).

    The diagonal is always explicit: SuperLU's L stores its unit diagonal
    and the packer writes it into the tiles.
    """
    diag_inv = tri_inverse(diag, lower=plan.lower)
    tiles_t = torch.cat([diag_inv, offdiag]).transpose(1, 2).contiguous()
    return TriKernelData(
        K=plan.K, T=plan.T, lower=plan.lower, tiles_t=tiles_t,
        waves=build_waves(plan, diag.device), diag=diag,
        tiles_bf16=tiles_t.to(torch.bfloat16) if bf16_stream else None)


def tri_kernel_from_bank(prev: TriKernelData, tiles_t: torch.Tensor,
                         diag: torch.Tensor) -> TriKernelData:
    """``prev`` with a new bank (same plan, same layout, and a fresh
    bfloat16 copy where ``prev`` has one): its waves are reused, so
    nothing is re-planned, re-inverted or read back from the device."""
    if tiles_t.shape != prev.tiles_t.shape:
        raise ValueError(f"bank {tuple(tiles_t.shape)} does not match the "
                         f"plan's {tuple(prev.tiles_t.shape)}")
    bf16 = None if prev.tiles_bf16 is None else tiles_t.to(torch.bfloat16)
    return dataclasses.replace(prev, tiles_t=tiles_t, diag=diag,
                               tiles_bf16=bf16)


def blocked_tri_solve(data: TriKernelData, xw: torch.Tensor, *,
                      mode: str = "inv", plain: bool = False,
                      stream: bool = False) -> torch.Tensor:
    """Solve ``T x = b`` in place on the chunk-blocked ``xw (K+1, cs, R)``,
    each level's diagonal step by ``mode`` (``SolverConfig.tri_mode``,
    resolved: ``"inv"``, ``"trsm"`` or ``"inv_refine"``).

    ``stream=True`` reads the tile stream of ``ldiv``: the bfloat16 copy
    where there is one (through :func:`wave_apply_bf16`; solvers make one
    at ``"inv"`` only), else the bank. ``plain=True`` runs the plain
    PyTorch waves on any device, and at ``"trsm"`` the plain diagonal
    step (:func:`diag_trsm_plain`: a gather, ``solve_triangular`` and a
    scatter); it exists to hold the kernel path against them on the card.

    Outside ``"inv"`` the steps are spans of their own, one after another:
    each off-diagonal wave a ``lu.ldiv.launch``, each diagonal step (the
    ``diag_trsm`` launch, or the correction) a ``lu.ldiv.diag``, so the
    registry's calls of ``lu.ldiv.diag`` count the diagonal steps
    (``trace.phases``; its launches, the ``diag_trsm`` launches). At
    ``"inv"`` every wave runs in the caller's span.
    """
    if mode not in ("inv", "trsm", "inv_refine"):
        raise ValueError(f"unknown tri_mode: {mode!r}")
    tiles, apply, trsm = data.tiles_t, wave_apply, diag_trsm
    if stream and data.tiles_bf16 is not None:
        tiles, apply = data.tiles_bf16, wave_apply_bf16
    if plain:
        apply, trsm = wave_apply_plain, diag_trsm_plain
    for w in data.waves:
        if mode == "inv":
            apply(xw, tiles, w)
        elif w.accumulate:
            with span("lu.ldiv.launch"):
                apply(xw, tiles, w)
        else:
            with span("lu.ldiv.diag"):
                if mode == "trsm":
                    trsm(xw, data.diag, w, data.lower)
                else:
                    # the diagonal wave's destinations are the level's
                    # chunks
                    ids = w.dst_long
                    r = xw[ids]
                    apply(xw, tiles, w)                   # y = Dinv·r
                    y = xw[ids]
                    xw[ids] = r - torch.bmm(data.diag[ids], y)
                    apply(xw, tiles, w)                   # Dinv·(r − D·y)
                    xw.index_add_(0, ids, y)              # y + Dinv·(r − D·y)
    return xw


def block_rhs(v: torch.Tensor, n: int, K: int, cs: int) -> torch.Tensor:
    """(n, R) → chunk-blocked (K+1, cs, R) with zero-padded tail + dummy."""
    R = v.shape[1]
    out = torch.zeros(((K + 1) * cs, R), dtype=v.dtype, device=v.device)
    out[:n] = v
    return out.view(K + 1, cs, R)


def unblock_rhs(xw: torch.Tensor, n: int) -> torch.Tensor:
    """Chunk-blocked (K+1, cs, R) → (n, R)."""
    Kp1, cs, R = xw.shape
    return xw.reshape(Kp1 * cs, R)[:n]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceFactors:
    """A solver's device numeric state: everything a direct solve reads.

    ``ldata``/``udata`` — the two factors' banks; ``rs`` — the row
    equilibration in input-row order (the perm-in scales before it
    permutes); ``pidx``/``qidx`` — the perm-in and perm-out indices,
    composed with the nd embedding; ``sched`` — the one-launch solve's
    task list (``tri_mode="inv"`` only, else None); ``mode`` — the
    resolved ``tri_mode``; ``planes`` — the chain solve's affine planes
    (``ops/scan_solve.chain_planes``) when both factors are bidiagonal,
    else None; ``chain`` — :meth:`solve` runs the chain kernel (planes
    under identity permutations, ``Rs`` folded into ``sL``).

    Immutable: a new factorization is a new object (a re-pack, or
    :meth:`with_banks`), so holding one is holding one numeric state.
    """

    ldata: TriKernelData
    udata: TriKernelData
    rs: torch.Tensor
    pidx: torch.Tensor
    qidx: torch.Tensor
    sched: Optional[LdivSchedule]
    mode: str
    planes: Optional[dict] = None
    chain: bool = False

    def tiles(self, b: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """``x = A⁻¹ b`` for a contiguous (n, R) tensor on the device by
        the tile solve: perm-in with ``rs``, the L levels, the U levels,
        perm-out — at ``"inv"`` one launch of ``fused_ldiv`` on the tile
        stream (the bfloat16 banks where there are some), in the other
        modes :meth:`_levels`.

        ``plain=True`` runs the plain PyTorch version of the perms and of
        every wave instead; it exists to hold the kernel path against it
        on the card.
        """
        if self.mode != "inv":
            return self._levels(b, plain=plain)
        with span("lu.ldiv.launch"):
            ldata, udata = self.ldata, self.udata
            if plain:
                return self._levels(b, plain=True)
            if ldata.tiles_bf16 is not None:
                return fused_ldiv_bf16(b, self.sched, ldata.tiles_bf16,
                                       udata.tiles_bf16, self.rs)
            return fused_ldiv(b, self.sched, ldata.tiles_t, udata.tiles_t,
                              self.rs)

    def _levels(self, b: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """The tile solve as level steps: ``perm_gather``, the level steps
        of :func:`blocked_tri_solve` for L and for U, ``perm_gather``.
        Outside ``"inv"`` each perm is a ``lu.ldiv.launch`` span and
        :func:`blocked_tri_solve` spans its own steps; at ``"inv"`` (the
        plain twin of the one launch) the caller's span holds them all."""
        ldata, udata = self.ldata, self.udata
        gather = perm_gather_plain if plain else perm_gather
        perm = (nullcontext if self.mode == "inv"
                else partial(span, "lu.ldiv.launch"))
        R = b.shape[1]
        with perm():
            xw = gather(b, self.pidx, self.rs).view(
                ldata.K + 1, ldata.tiles_t.shape[1], R)
        blocked_tri_solve(ldata, xw, mode=self.mode, plain=plain,
                          stream=True)
        blocked_tri_solve(udata, xw, mode=self.mode, plain=plain,
                          stream=True)
        with perm():
            return gather(xw.view(-1, R), self.qidx)

    def solve(self, b: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """One direct solve of ``ldiv``: on a chain (``chain``) ``Rs``
        folded into the forward sweep, then the backward sweep, one launch
        of the chain kernel (``plain=True``: the plain PyTorch scan); else
        :meth:`tiles`."""
        if self.chain:
            with span("lu.ldiv.chain"):
                p = self.planes
                run = bidiag_ldiv_plain if plain else bidiag_ldiv
                return run(b, lower=(p["aL"], p["sL"]),
                           upper=(p["aU"], p["sU"]))
        return self.tiles(b, plain=plain)

    def with_banks(self, out: dict,
                   ext_pos: Optional[torch.Tensor]) -> "DeviceFactors":
        """This state with the banks of a device refactorization (``out``
        of ``refactor.refactor_pipeline``): the same plans, waves,
        permutations and task list, ``rs`` mapped to input-row order
        through ``ext_pos`` (the nd embedding's position of each input
        row; None without one). The chain planes hold the values of the
        last re-pack, so the tile solve serves until the next one."""
        rs = out["rs"]
        return DeviceFactors(
            ldata=tri_kernel_from_bank(self.ldata, out["lbank"],
                                       out["ldiag"]),
            udata=tri_kernel_from_bank(self.udata, out["ubank"],
                                       out["udiag"]),
            rs=rs if ext_pos is None else rs[ext_pos],
            pidx=self.pidx, qidx=self.qidx, sched=self.sched,
            mode=self.mode)


def refine(solve: Callable, residual: Callable, b: torch.Tensor,
           x: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` sweeps of iterative refinement ``x += solve(b - A x)``
    from ``x``: ``residual(b, x)`` gives ``b - A x`` (in the caller's
    precision) and ``solve`` one direct solve of it, casts included. The
    residual and the update are each a ``lu.ldiv.residual`` span."""
    for _ in range(steps):
        with span("lu.ldiv.residual"):
            r = residual(b, x)
        d = solve(r)
        with span("lu.ldiv.residual"):
            x = x + d
    return x
