"""Public solver API: the :class:`ParallelSparseLU` lifecycle in PyTorch.

Counterpart of ``tpu_sparse_lu/api.py`` (host factorization, ``tri_mode=
"inv"``), mirroring the reference's user contract
(reference test/runtests.jl:108-188): factor once → solve many →
refactor in place when values change but sparsity doesn't → solve again.

  * ``ParallelSparseLU(A, chunk_size, device=...)`` ↔ reference constructor
  * ``F.ldiv(b)`` / ``F.solve(b)`` / ``F(b)``  ↔ ``ldiv!(x, F, b)``
  * ``F.lsolve(b)`` / ``F.rsolve(b)``          ↔ ``lsolve!`` / ``rsolve!``
  * ``F.refactor(A)``                          ↔ ``lu!(F, A)``

Construction (SuperLU, the nd embedding, planning) runs on the host; the
packed tiles, their inverses and the solves live on ``device``. A solve on
a CUDA device runs the hand-written kernels of ``ops/fused_ldiv.py``.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Mapping, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .ops.fused_ldiv import perm_gather, perm_gather_plain
from .pack import pack_factor
from .solve import (
    TriKernelData,
    block_rhs,
    blocked_tri_solve,
    prepare_tri_kernel,
    unblock_rhs,
)
from .symbolic import (
    HostFactors,
    SymbolicPlan,
    TriPlan,
    build_symbolic_plan,
    factorize_host,
    plan_triangular,
)
from .utils.config import SolverConfig, default_chunk_size, resolve_tri_mode

__all__ = ["ParallelSparseLU", "cleanup_ParallelSparseLU"]

_DEVICE_REFACTOR = "ROADMAP.md queue A item 6 (device refactorization)"

# SolverConfig fields a JAX save carries over; the solve mode and tile
# stream are the port's own
_CARRIED_CONFIG = ("chunk_size", "dtype", "ordering", "pivot_threshold",
                   "nd_cutoff")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev


def _resolve_dtype(config_dtype: Optional[str], A_dtype) -> torch.dtype:
    if config_dtype is not None:
        return getattr(torch, config_dtype)
    return torch.float64 if A_dtype == np.float64 else torch.float32


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: {item}")


class ParallelSparseLU:
    """Sparse LU factorization with fast repeated solves on a torch device.

    Exposes the reference struct's quantities (src/SharedMemSparseLU.jl:
    43-62): ``m, n, L, U, p, q, Rs`` with
    ``L @ U == (Rs[:, None] * A)[p][:, q]``, plus the static
    :class:`SymbolicPlan` and the device-resident tile banks. ``device`` is
    required: the solver never picks one on its own.
    """

    def __init__(
        self,
        A: sp.spmatrix,
        chunk_size: Optional[int] = None,
        *,
        config: Optional[SolverConfig] = None,
        device,
    ):
        self.device = _resolve_device(device)
        self.config = config or SolverConfig(chunk_size=chunk_size)
        if chunk_size is not None and self.config.chunk_size is None:
            self.config = dataclasses.replace(self.config,
                                              chunk_size=chunk_size)
        self.config = dataclasses.replace(
            self.config, tri_mode=resolve_tri_mode(self.config.tri_mode)
        )
        A = sp.csc_matrix(A)
        A.sort_indices()
        cs = self.config.chunk_size or default_chunk_size(
            A.shape[0], self.device.type
        )
        cs = max(1, min(cs, A.shape[0]))  # reference clamp, src:72
        self._n_orig = A.shape[0]
        self.dtype = _resolve_dtype(self.config.dtype, A.dtype)

        # nested-dissection embedding: factor an extended matrix whose
        # chunks align with the dissection stages
        self._ext = None
        self._nd_cutoff = self.config.nd_cutoff
        A_factor = A
        if self.config.ordering == "nd":
            from .ordering import staged_extension

            if self._nd_cutoff == "auto":
                self._nd_cutoff = self._autotune_nd_cutoff(A, cs)
            A_ext, ext_src, ext_pos, data_src = staged_extension(
                A, cs, cutoff=self._nd_cutoff
            )
            self._ext = {"src": ext_src, "pos": ext_pos, "data_src": data_src}
            A_factor = A_ext
        self._factors = self._factorize(A_factor)
        self.plan = build_symbolic_plan(self._factors, cs)
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        self._a_factor_pattern = (A_factor.indptr.copy(),
                                  A_factor.indices.copy())
        self._set_matrix(A)
        self._prepare_device()

    @classmethod
    def from_jax_arrays(cls, A: sp.spmatrix, arrays: Mapping, *, device):
        """Build a solver from the arrays a JAX
        ``tpu_sparse_lu.ParallelSparseLU.save(path, values=True)`` writes
        (``np.load(path)``), so both packages solve with the very same
        factorization: factors, permutations, scaling, plan and nd
        embedding are taken as saved, and nothing is re-planned.

        ``A`` must be the matrix that was factored (pattern and values).
        """
        z = arrays
        if int(z["version"]) != 1:
            raise ValueError(f"unknown save version {int(z['version'])}")
        if "light" in z and int(z["light"]) == 1:
            _not_ported("loading a values-less save", _DEVICE_REFACTOR)
        A = sp.csc_matrix(A)
        A.sort_indices()
        if (not np.array_equal(A.indptr, z["a_indptr"])
                or not np.array_equal(A.indices, z["a_indices"])):
            raise ValueError("matrix sparsity pattern differs from the saved "
                             "state")
        if not np.array_equal(np.asarray(A.data, np.float64),
                              np.asarray(z["a_data"], np.float64)):
            raise ValueError("matrix values differ from the saved state; "
                             "load with the saved matrix, then refactor(A)")
        saved = json.loads(bytes(z["config_json"]).decode())
        self = cls.__new__(cls)
        self.device = _resolve_device(device)
        self.config = SolverConfig(
            tri_mode="inv", **{k: saved[k] for k in _CARRIED_CONFIG}
        )
        self._n_orig = int(z["n_orig"])
        self.dtype = _resolve_dtype(self.config.dtype, A.dtype)
        nd = int(z["nd_cutoff"])
        self._nd_cutoff = self.config.nd_cutoff if nd < 0 else nd
        self._ext = None
        if "ext_src" in z:
            self._ext = {"src": z["ext_src"], "pos": z["ext_pos"],
                         "data_src": z["ext_data_src"]}
        nf = int(z["f_n"])

        def csc(prefix):
            return sp.csc_matrix(
                (z[f"{prefix}_data"], z[f"{prefix}_indices"],
                 z[f"{prefix}_indptr"]), shape=(nf, nf))

        self._factors = HostFactors(m=int(z["f_m"]), n=nf, L=csc("L"),
                                    U=csc("U"), p=z["p"], q=z["q"],
                                    Rs=z["Rs"])

        def tri(prefix):
            kw = {}
            for fld in dataclasses.fields(TriPlan):
                v = z[f"{prefix}_{fld.name}"]
                if fld.name in ("n", "cs", "K", "T"):
                    v = int(v)
                elif fld.name == "lower":
                    v = bool(v)
                kw[fld.name] = v
            return TriPlan(**kw)

        self.plan = SymbolicPlan(
            n=int(z["plan_n"]), cs=int(z["plan_cs"]), lplan=tri("l"),
            uplan=tri("u"), p=z["plan_p"], q=z["plan_q"], Rs=z["plan_Rs"],
            qinv=z["plan_qinv"],
        )
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        if self._ext is None:
            self._a_factor_pattern = (A.indptr.copy(), A.indices.copy())
        else:
            self._a_factor_pattern = (z["af_indptr"].copy(),
                                      z["af_indices"].copy())
        self._set_matrix(A)
        self._prepare_device()
        return self

    def _autotune_nd_cutoff(self, A: sp.csc_matrix, cs: int) -> int:
        """Pick the nd base-subdomain size among {cs, 2cs, 4cs} by the
        tile-count cost model of the JAX package (one trial factorization
        each): ``89*(diag + off-diagonal tiles) + 20*levels``."""
        from .ordering import staged_extension

        best, best_cost = cs, None
        for cutoff in (cs, 2 * cs, 4 * cs):
            A_ext, _, _, _ = staged_extension(A, cs, cutoff=cutoff)
            f = self._factorize(A_ext)
            lp = plan_triangular(f.L, cs, lower=True)
            up = plan_triangular(f.U, cs, lower=False)
            cost = (89 * (lp.K + up.K + lp.T + up.T + 2)
                    + 20 * (lp.num_levels + up.num_levels))
            if best_cost is None or cost < best_cost:
                best, best_cost = cutoff, cost
        return best

    def _factorize(self, A_factor: sp.csc_matrix) -> HostFactors:
        if self.config.ordering == "nd":
            # pivoting would scramble the chunk-aligned embedding: static
            # diagonal pivots unless a threshold is asked for
            thresh = self.config.pivot_threshold
            return factorize_host(
                A_factor, permc_spec="NATURAL",
                diag_pivot_thresh=0.0 if thresh is None else thresh,
            )
        kw = {}
        if self.config.ordering == "natural":
            kw["permc_spec"] = "NATURAL"
        elif self.config.ordering == "mmd":
            kw["permc_spec"] = "MMD_AT_PLUS_A"
        if self.config.pivot_threshold is not None:
            kw["diag_pivot_thresh"] = self.config.pivot_threshold
        return factorize_host(A_factor, **kw)

    def _ext_values(self, A: sp.csc_matrix) -> np.ndarray:
        """Map original csc data to the extended matrix's csc data."""
        ds = self._ext["data_src"]
        return np.where(ds >= 0, A.data[np.maximum(ds, 0)], 1.0)

    def _set_matrix(self, A: sp.csc_matrix) -> None:
        """Keep A on the device as a sparse CSR tensor, for the residual of
        iterative refinement (``matvec``)."""
        csr = A.tocsr()
        with warnings.catch_warnings():
            # torch flags sparse CSR as beta and notes the skipped checks
            warnings.filterwarnings("ignore", message="Sparse")
            self._A_dev = torch.sparse_csr_tensor(
                torch.as_tensor(csr.indptr, dtype=torch.int64),
                torch.as_tensor(csr.indices, dtype=torch.int64),
                torch.as_tensor(csr.data, dtype=self.dtype),
                size=A.shape, device=self.device, check_invariants=False,
            )

    def matvec(self, x) -> torch.Tensor:
        """``A @ x`` on the device with the current matrix values."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.dim() == 1:
            return (self._A_dev @ x[:, None])[:, 0]
        return self._A_dev @ x

    # -- reference-parity attributes ---------------------------------------
    @property
    def m(self) -> int:
        """Size of the input matrix (under ordering="nd" the factored
        matrix is the chunk-aligned extension; see ``n_factor``)."""
        return self._n_orig

    @property
    def n(self) -> int:
        return self._n_orig

    @property
    def n_factor(self) -> int:
        """Dimension of the factored matrix (== n except under "nd")."""
        return self._factors.n

    @property
    def L(self) -> sp.csc_matrix:
        return self._factors.L

    @property
    def U(self) -> sp.csc_matrix:
        return self._factors.U

    @property
    def p(self) -> np.ndarray:
        return self._factors.p

    @property
    def q(self) -> np.ndarray:
        return self._factors.q

    @property
    def Rs(self) -> np.ndarray:
        return self._factors.Rs

    @property
    def chunk_size(self) -> int:
        return self.plan.cs

    @property
    def total_chunks(self) -> int:
        return self.plan.lplan.K

    # -- device state -------------------------------------------------------
    def _prepare_device(self) -> None:
        """Pack the factor nonzeros into tiles, invert the diagonal tiles
        and build the wave schedules and permutation vectors (the
        reference's allocate_chunks + fill_chunks!, src:151-243)."""
        plan, dev = self.plan, self.device

        def tri(tplan, M):
            nz = torch.as_tensor(np.asarray(M.data), dtype=self.dtype,
                                 device=dev)
            return prepare_tri_kernel(tplan, *pack_factor(tplan, nz))

        self.ldata: TriKernelData = tri(plan.lplan, self._factors.L)
        self.udata: TriKernelData = tri(plan.uplan, self._factors.U)
        # ldiv permutations (src:324-339), composed with the nd embedding:
        #   wrk[i] = (Rs ⊙ b_ext)[p[i]],  b_ext[e] = b[ext_src[e]]
        #   x[j]   = wrk[qinv[ext_pos[j]]]
        if self._ext is None:
            pvec, qvec, rs_in = plan.p, plan.qinv, plan.Rs
        else:
            src, pos = self._ext["src"], self._ext["pos"]
            pvec = np.where(plan.p < src.shape[0], src[plan.p], -1)
            qvec = plan.qinv[pos]
            rs_in = plan.Rs[pos]  # per ORIGINAL row
        K, cs = plan.lplan.K, plan.cs
        pidx = np.full((K + 1) * cs, -1, dtype=np.int32)
        pidx[: plan.n] = pvec
        self._pidx = torch.as_tensor(pidx, device=dev)
        self._qidx = torch.as_tensor(np.asarray(qvec, dtype=np.int32),
                                     device=dev)
        # Rs in input row order: the perm-in scales before it permutes
        self._rs = torch.as_tensor(np.asarray(rs_in), dtype=self.dtype,
                                   device=dev)

    # -- solves -------------------------------------------------------------
    def _as_rhs(self, b, n=None):
        n = self.n if n is None else n
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.dim() not in (1, 2) or b.shape[0] != n:
            raise ValueError(
                f"`b` does not have same size as F: {tuple(b.shape)} vs n={n}"
            )
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        return b.contiguous(), squeeze

    def _direct_solve(self, b: torch.Tensor, *,
                      plain: bool = False) -> torch.Tensor:
        """``x = A⁻¹ b`` for a contiguous (n, R) tensor on the device:
        perm-in with ``Rs``, the L waves, the U waves, perm-out.

        ``plain=True`` runs the plain PyTorch version of every kernel; it
        exists to hold the kernel path against it on the card.
        """
        gather = perm_gather_plain if plain else perm_gather
        R = b.shape[1]
        xw = gather(b, self._pidx, self._rs).view(
            self.plan.lplan.K + 1, self.plan.cs, R)
        blocked_tri_solve(self.ldata, xw, plain=plain)
        blocked_tri_solve(self.udata, xw, plain=plain)
        return gather(xw.view(-1, R), self._qidx)

    def lsolve(self, b) -> torch.Tensor:
        """Solve ``L y = b`` (reference ``lsolve!``, src:349-367).

        Under ordering="nd" the factors live on the extended matrix:
        ``b`` has length ``n_factor``."""
        return self._tri_solve(self.ldata, self.plan.lplan, b)

    def rsolve(self, b) -> torch.Tensor:
        """Solve ``U y = b`` (reference ``rsolve!``, src:374-392)."""
        return self._tri_solve(self.udata, self.plan.uplan, b)

    def _tri_solve(self, data: TriKernelData, tplan: TriPlan, b):
        nf = self.n_factor
        b, squeeze = self._as_rhs(b, nf)
        xw = blocked_tri_solve(data, block_rhs(b, nf, tplan.K, tplan.cs))
        y = unblock_rhs(xw, nf)
        return y[:, 0] if squeeze else y

    def ldiv(self, b, *, refine_steps: int = 0) -> torch.Tensor:
        """Solve ``A x = b`` (reference ``ldiv!``, src:286-342).

        ``b`` may be ``(n,)`` or ``(n, R)``, a tensor or an array; the
        result is a tensor on the solver's device. ``refine_steps`` —
        iterative-refinement sweeps ``x += solve(b - A x)`` after the direct
        solve, with the residual in the solver's dtype.
        """
        if self.m != self.n:
            raise ValueError(f"`F` is not square: m={self.m}, n={self.n}")
        b, squeeze = self._as_rhs(b)
        x = self._direct_solve(b)
        for _ in range(refine_steps):
            x = x + self._direct_solve(b - self.matvec(x))
        return x[:, 0] if squeeze else x

    solve = ldiv
    __call__ = ldiv

    # -- refactorization ----------------------------------------------------
    def refactor(self, A: Optional[sp.spmatrix]) -> None:
        """Full host refactorization — reference ``lu!(F, A)`` (src:245-279).

        Re-runs SuperLU (which may re-pivot), detects a sparsity-pattern
        change of the factors as the reference does (src:252-258), re-plans
        only when it changed (src:265-273), and always re-packs
        (src:274-276). ``A=None`` is a no-op re-pack (src:246).
        """
        if A is None:
            self._prepare_device()
            return
        A = sp.csc_matrix(A)
        A.sort_indices()
        if A.shape != (self.n, self.n):
            raise ValueError(
                f"refactor needs a {self.n}x{self.n} matrix, got {A.shape}"
            )
        old_sig = self._factors.pattern_signature()
        A_factor = A
        if self._ext is not None:
            if (A.indptr.tobytes(), A.indices.tobytes()) != self._a_pattern_sig:
                # pattern changed: rebuild the nd embedding from scratch
                from .ordering import staged_extension

                A_ext, ext_src, ext_pos, data_src = staged_extension(
                    A, self.plan.cs, cutoff=self._nd_cutoff
                )
                self._ext = {"src": ext_src, "pos": ext_pos,
                             "data_src": data_src}
                A_factor = A_ext
            else:
                indptr, indices = self._a_factor_pattern
                A_factor = sp.csc_matrix(
                    (self._ext_values(A), indices, indptr),
                    shape=(indptr.shape[0] - 1, indptr.shape[0] - 1),
                )
        new_factors = self._factorize(A_factor)
        reallocate = new_factors.pattern_signature() != old_sig
        self._factors = new_factors
        self._a_factor_pattern = (A_factor.indptr.copy(),
                                  A_factor.indices.copy())
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        self._set_matrix(A)
        if reallocate:
            self.plan = build_symbolic_plan(new_factors, self.plan.cs)
        else:
            # same L/U pattern, but SuperLU may still have picked new
            # pivots/scaling: refresh them (the reference's in-place
            # copies, src:261-263)
            self.plan.p = new_factors.p.astype(np.int32)
            self.plan.q = new_factors.q.astype(np.int32)
            self.plan.Rs = new_factors.Rs
            self.plan.qinv = np.argsort(new_factors.q).astype(np.int32)
        self._prepare_device()

    # -- not ported yet -----------------------------------------------------
    def refactor_numeric(self, A, **kwargs):
        _not_ported("refactor_numeric", _DEVICE_REFACTOR)

    def make_refactor_solve_step(self, **kwargs):
        _not_ported("make_refactor_solve_step", _DEVICE_REFACTOR)

    def enable_device_refactor(self, **kwargs):
        _not_ported("enable_device_refactor", _DEVICE_REFACTOR)

    def make_f64_ldiv(self, **kwargs):
        _not_ported("make_f64_ldiv",
                    "ROADMAP.md queue A item 9 (f64 tier)")

    def save(self, path, **kwargs):
        _not_ported("save", "ROADMAP.md queue A item 11 (persistence)")

    @classmethod
    def from_saved(cls, A, path, **kwargs):
        _not_ported("from_saved", "ROADMAP.md queue A item 11 (persistence)")

    def close(self) -> None:
        """Release the device buffers (the reference's exported
        ``cleanup_ParallelSparseLU!``, src:31)."""
        self.ldata = self.udata = None
        self._A_dev = self._pidx = self._qidx = self._rs = None


def cleanup_ParallelSparseLU(F: ParallelSparseLU) -> None:
    """API-parity alias for the reference export (src:31)."""
    F.close()
