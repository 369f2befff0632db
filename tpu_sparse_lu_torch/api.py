"""Public solver API: the :class:`ParallelSparseLU` lifecycle in PyTorch.

Counterpart of ``tpu_sparse_lu/api.py``, mirroring the reference's user
contract
(reference test/runtests.jl:108-188): factor once → solve many →
refactor in place when values change but sparsity doesn't → solve again.

  * ``ParallelSparseLU(A, chunk_size, device=...)`` ↔ reference constructor
  * ``F.ldiv(b)`` / ``F.solve(b)`` / ``F(b)``  ↔ ``ldiv!(x, F, b)``
  * ``F.lsolve(b)`` / ``F.rsolve(b)``          ↔ ``lsolve!`` / ``rsolve!``
  * ``F.refactor(A)``                          ↔ ``lu!(F, A)``
  * ``F.refactor_numeric(A)``                  — same-pattern numeric
                                                 refactorization on the
                                                 device (static pivots)
  * ``F.make_f64_ldiv()``                      — float64-accurate solves
                                                 from a float32
                                                 factorization
  * ``F.save(path)`` / ``ParallelSparseLU.from_saved(A, path)``
                                               — persistence: a reload
                                                 skips SuperLU and the
                                                 host planning

Construction (SuperLU, or with ``factorize="device"`` no numeric host
factorization at all; the nd embedding; planning) runs on the host; the
packed tiles, their inverses and the solves live on ``device``. A solve on
a CUDA device at ``tri_mode="inv"`` is one launch of the hand-written
kernel of ``ops/fused_ldiv.py`` (``fused_ldiv``); at ``"trsm"`` and
``"inv_refine"`` it is ``perm_gather``, the level steps of
``solve.blocked_tri_solve`` (the off-diagonal waves on ``wave_apply``) and
``perm_gather``; for bidiagonal factors (1-D chains) in any mode it is
the one launch of ``ops/bidiag_ldiv.py``. A device refactorization runs
the two kernels of ``ops/assembly.py`` and the one launch of
``ops/elim_fused.py`` (the whole elimination).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Mapping, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .ops.bidiag_ldiv import bidiag_ldiv, bidiag_ldiv_plain
from .ops.fused_ldiv import (
    build_ldiv_schedule,
    fused_ldiv,
    fused_ldiv_bf16,
    perm_gather,
    perm_gather_plain,
)
from .ops.scan_solve import bidiag_bands, chain_planes
from .pack import pack_factor
from .solve import (
    TriKernelData,
    block_rhs,
    blocked_tri_solve,
    prepare_tri_kernel,
    tri_kernel_from_bank,
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

# save-file versions: 1 is the JAX package's (full, or light with a
# ``light`` entry), read but never written; the port writes 2 (full: the
# factor values) and 3 (light: the device-refactor plan, no values)
JAX_SAVE, FULL_SAVE, LIGHT_SAVE = 1, 2, 3

# prefix of the six top-level SymbolicPlan entries of a solver save
_PLAN_TOP = "plan_"


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


def _pattern_factors(A: sp.csc_matrix) -> HostFactors:
    """Pattern-only :class:`HostFactors` for ``factorize="device"``.

    Under a static-diagonal-pivot ordering (p = q = identity, no row
    pivoting) the factor patterns need no numeric factorization: L and U
    lie inside the blocked-elimination closure of A's own pattern, which
    is what the device refactorization plans on
    (``refactor.closure_solve_plans``). These placeholder factors carry
    the triangles of A's pattern with identity values (diagonal 1,
    off-diagonal 0, so the pack that precedes the first device
    factorization stays finite); the first device refactorization then
    computes the real values and every closure fill tile.
    """
    n = A.shape[0]
    eye = sp.eye(n, format="csc")

    def tri(M):
        M = (M + eye).tocsc()
        M.sort_indices()
        rows = M.indices
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(M.indptr))
        M.data = (rows == cols).astype(np.float64)
        return M

    ident = np.arange(n, dtype=np.int64)
    return HostFactors(
        m=n, n=n,
        L=tri(sp.tril(A, -1)),
        U=tri(sp.triu(A, 1)),
        p=ident, q=ident.copy(),
        Rs=np.ones(n, dtype=np.float64),
    )


def _free_bytes(device: torch.device) -> int:
    """Free memory of ``device``: ``torch.cuda.mem_get_info`` on a card,
    the host's available physical memory on the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


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
        if (self.config.stream_dtype == "bfloat16"
                and self.dtype != torch.float32):
            raise ValueError(
                "stream_dtype='bfloat16' streams the tiles of a float32 "
                f"factorization; this solver's dtype is {self.dtype}")

        # nested-dissection embedding: factor an extended matrix whose
        # chunks align with the dissection stages
        self._init_refactor_state()
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
        # first-factorization backend: "device" runs no numeric host
        # factorization — pattern-only placeholder factors now, the real
        # values from the device elimination below
        fac = self.config.factorize
        static_piv = self.config.ordering == "nd" or (
            self.config.ordering == "natural"
            and self.config.pivot_threshold == 0.0
        )
        if fac == "auto":
            fac = "device" if static_piv else "host"
        if fac == "device" and not static_piv:
            raise ValueError(
                "factorize='device' needs a static-diagonal-pivot ordering "
                "(ordering='nd', or 'natural' with pivot_threshold=0.0): "
                "the frozen pivot order must be known from the pattern "
                "alone before any numeric factorization exists"
            )
        self.config = dataclasses.replace(self.config, factorize=fac)
        if fac == "device":
            self._factors = _pattern_factors(A_factor)
        else:
            self._factors = self._factorize(A_factor)
        self.plan = build_symbolic_plan(self._factors, cs)
        self._a_factor_pattern = (A_factor.indptr.copy(),
                                  A_factor.indices.copy())
        self._set_matrix(A)
        if fac == "device":
            # the first factorization on the device: closure plans (with
            # the memory guard), then the device elimination
            self.enable_device_refactor()
            self.refactor_numeric(A)
        else:
            self._prepare_device()

    @classmethod
    def from_jax_arrays(cls, A: sp.spmatrix, arrays: Mapping, *, device):
        """Build a solver from the arrays of a save (``np.load(path)``) —
        a JAX ``tpu_sparse_lu.ParallelSparseLU.save``, full or light, or
        the port's own — so both packages solve with the very same
        factorization. ``A`` must be the matrix the file holds, values
        included (``ValueError`` otherwise): :meth:`from_saved` with
        ``on_value_change="error"``.
        """
        return cls._from_arrays(A, arrays, device=device,
                                on_value_change="error")

    @classmethod
    def from_saved(cls, A: sp.spmatrix, path, *, device,
                   on_value_change: str = "refactor"):
        """Rebuild a solver from a :meth:`save` file (or a JAX package
        save, version 1, full or light), skipping SuperLU and all host
        planning (reference analogue: the live UMFPACK object reused
        across ``lu!``, src:53-54).

        ``A`` must have exactly the sparsity pattern the state was saved
        from (``ValueError`` otherwise: a pattern change needs a new
        solver, the reference's reallocate path, src:265-273). A full
        save is packed as saved; a light save (no factor values) runs the
        device refactorization (``factorize="device"``'s path) on ``A``'s
        values, from the saved refactor plan — or, for a JAX light file,
        whose plan describes the JAX package's windowed assembly, from a
        refactor plan the port rebuilds on the saved closure solve plans.
        If ``A``'s values differ from the saved ones, ``on_value_change``
        says what to do: ``"refactor"`` (default) refactorizes on the
        device (``refactor_numeric``, unchecked), ``"error"`` raises.
        ``device`` is where the solver lives, whatever the saver's was.
        """
        with np.load(path) as z:
            return cls._from_arrays(A, z, device=device,
                                    on_value_change=on_value_change)

    @classmethod
    def _from_arrays(cls, A: sp.spmatrix, z: Mapping, *, device,
                     on_value_change: str):
        """The one reader of saved state (:meth:`from_saved`)."""
        if on_value_change not in ("refactor", "error"):
            raise ValueError(f"unknown on_value_change: {on_value_change!r}")
        version = int(z["version"])
        if version not in (JAX_SAVE, FULL_SAVE, LIGHT_SAVE):
            raise ValueError(f"unknown save version {version}")
        light = version == LIGHT_SAVE or (
            version == JAX_SAVE and "light" in z and int(z["light"]) == 1)
        A = sp.csc_matrix(A)
        A.sort_indices()
        if (not np.array_equal(A.indptr, z["a_indptr"])
                or not np.array_equal(A.indices, z["a_indices"])):
            raise ValueError(
                "matrix sparsity pattern differs from the saved state; "
                "from_saved needs the exact saved pattern: construct a new "
                "ParallelSparseLU for a pattern change")
        values_changed = not np.array_equal(
            np.asarray(A.data, np.float64),
            np.asarray(z["a_data"], np.float64))
        if values_changed and on_value_change == "error":
            raise ValueError(
                "matrix values differ from the saved state (same pattern); "
                "load with the saved matrix, or pass on_value_change="
                "'refactor' to refactorize on the device")
        saved = json.loads(bytes(z["config_json"]).decode())
        names = {f.name for f in dataclasses.fields(SolverConfig)}
        self = cls.__new__(cls)
        self._init_refactor_state()
        self.device = _resolve_device(device)
        # a JAX save carries the JAX-only knobs too; the resolved mode is
        # taken as saved
        self.config = SolverConfig(
            **{k: v for k, v in saved.items() if k in names})
        self.config = dataclasses.replace(
            self.config, tri_mode=resolve_tri_mode(self.config.tri_mode))
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
            indptr, indices = z[f"{prefix}_indptr"], z[f"{prefix}_indices"]
            if light:
                # no values: identity placeholders (diagonal 1, the rest
                # 0), finite through the pack, replaced by the device
                # refactorization below — as under factorize="device"
                cols = np.repeat(np.arange(nf, dtype=np.int64),
                                 np.diff(indptr))
                data = (indices == cols).astype(np.float64)
            else:
                data = z[f"{prefix}_data"]
            return sp.csc_matrix((data, indices, indptr), shape=(nf, nf))

        self._factors = HostFactors(m=int(z["f_m"]), n=nf, L=csc("L"),
                                    U=csc("U"), p=z["p"], q=z["q"],
                                    Rs=z["Rs"])
        self.plan = SymbolicPlan.from_arrays(z, top=_PLAN_TOP)
        if self._ext is None:
            self._a_factor_pattern = (A.indptr.copy(), A.indices.copy())
        else:
            self._a_factor_pattern = (z["af_indptr"].copy(),
                                      z["af_indices"].copy())
        self._set_matrix(A)
        self._prepare_device()
        if light:
            from .refactor import RefactorPlan, upload_refactor_plan

            if version == LIGHT_SAVE:
                rp = RefactorPlan.from_arrays(z)
            else:
                rp = self._build_refactor_plan(self.plan.lplan,
                                               self.plan.uplan)
            self._refactor_dev = upload_refactor_plan(rp, self.device)
            self._refactor_plan = rp
        if light or values_changed:
            self.refactor_numeric(A)
        return self

    def _init_refactor_state(self) -> None:
        self._refactor_plan = None
        self._refactor_dev = None
        self._factors_stale = False
        self.refactor_diagnostics = None

    def _autotune_nd_cutoff(self, A: sp.csc_matrix, cs: int) -> int:
        """Pick the nd base-subdomain size among {cs, 2cs, 4cs} by the
        tile-count cost model of the JAX package (one trial factorization
        each): ``89*(diag + off-diagonal tiles) + 20*levels``. Under
        ``factorize != "host"`` the trial is pattern-only: the tile counts
        come from the blocked closure the device elimination fills."""
        from .ordering import staged_extension

        pattern_only = self.config.factorize != "host"
        best, best_cost = cs, None
        for cutoff in (cs, 2 * cs, 4 * cs):
            A_ext, _, _, _ = staged_extension(A, cs, cutoff=cutoff)
            if pattern_only:
                from .refactor import closure_solve_plans

                pf = _pattern_factors(A_ext)
                lp, up = closure_solve_plans(A_ext, pf.L, pf.U, pf.p, pf.q,
                                             cs)
            else:
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
        """Keep A's pattern on the host (``save``, the same-pattern checks)
        and A on the device as a sparse CSR tensor, for the residual of
        iterative refinement (``matvec``), with the CSC → CSR permutation
        of its values, so new values on the device need no host trip, and
        a float64 copy of its CSC values (``make_f64_ldiv``'s residual,
        ``save``'s ``a_data``)."""
        self._a_pattern = (A.indptr.copy(), A.indices.copy())
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        nnz = A.indices.shape[0]
        # CSC positions carried through the conversion (shifted by one so
        # that no position is an explicit zero)
        pos = sp.csc_matrix((np.arange(1, nnz + 1), A.indices, A.indptr),
                            shape=A.shape).tocsr()
        dev = self.device
        self._csr_pattern = (
            torch.as_tensor(pos.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(pos.indices, dtype=torch.int64, device=dev),
        )
        self._csc_to_csr = torch.as_tensor(pos.data - 1, dtype=torch.int64,
                                           device=dev)
        self._set_matrix_values(
            torch.as_tensor(A.data, dtype=torch.float64, device=dev))

    def _csr_matrix(self, a_data: torch.Tensor) -> torch.Tensor:
        """The sparse CSR tensor of A from its CSC values on the device."""
        with warnings.catch_warnings():
            # torch flags sparse CSR as beta and notes the skipped checks
            warnings.filterwarnings("ignore", message="Sparse")
            return torch.sparse_csr_tensor(
                *self._csr_pattern, a_data[self._csc_to_csr],
                size=(self.n, self.n), check_invariants=False,
            )

    def _set_matrix_values(self, a_data: torch.Tensor) -> None:
        """New values of A (CSC order, on the device, of any float dtype:
        float64 keeps the f64 copy exact), same pattern."""
        self._a64 = a_data.to(torch.float64)
        self._A_dev = self._csr_matrix(a_data.to(self.dtype))

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
        self._materialize_factors()
        return self._factors.L

    @property
    def U(self) -> sp.csc_matrix:
        self._materialize_factors()
        return self._factors.U

    def _materialize_factors(self) -> None:
        """Refresh the host csc factor values from the device tiles.

        After a device factorization (``refactor_numeric`` or
        ``factorize="device"``) the numeric truth lives in the device
        banks; the csc factors kept for reference parity (``F.L``/``F.U``,
        reference struct fields src:43-62) are stale until read. The
        diagonal tiles and the negated off-diagonal tiles are pulled once,
        restricted to real rows and columns, explicit zeros dropped.
        """
        if not self._factors_stale:
            return
        self._factors_stale = False
        nf = self.plan.n

        def tocsc(tplan: TriPlan, data: TriKernelData) -> sp.csc_matrix:
            cs = tplan.cs
            ar = np.arange(cs)
            dv = data.diag[: tplan.K].double().cpu().numpy()
            k = np.arange(tplan.K, dtype=np.int64)
            rows = [np.broadcast_to(k[:, None, None] * cs
                                    + ar[None, :, None], dv.shape).ravel()]
            cols = [np.broadcast_to(k[:, None, None] * cs
                                    + ar[None, None, :], dv.shape).ravel()]
            vals = [dv.ravel()]
            if tplan.T:
                # off-diagonal tiles are stored negated for the solve
                ov = -data.offdiag[: tplan.T].double().cpu().numpy()
                br = tplan.tile_brow[: tplan.T].astype(np.int64)
                bc = tplan.tile_bcol[: tplan.T].astype(np.int64)
                rows.append(np.broadcast_to(
                    br[:, None, None] * cs + ar[None, :, None],
                    ov.shape).ravel())
                cols.append(np.broadcast_to(
                    bc[:, None, None] * cs + ar[None, None, :],
                    ov.shape).ravel())
                vals.append(ov.ravel())
            r, c, v = map(np.concatenate, (rows, cols, vals))
            m = (r < nf) & (c < nf) & (v != 0.0)
            M = sp.coo_matrix((v[m], (r[m], c[m])), shape=(nf, nf)).tocsc()
            M.sort_indices()
            return M

        self._factors.L = tocsc(self.plan.lplan, self.ldata)
        self._factors.U = tocsc(self.plan.uplan, self.udata)
        # the device refactorization also recomputed the row equilibration
        self.plan.Rs = np.asarray(self.Rs, dtype=np.float64)
        # re-plan on the SAME tile sets so the per-nonzero pack maps fit
        # the materialized factors (tile ids, levels and waves unchanged)
        for attr, M in (("lplan", self._factors.L),
                        ("uplan", self._factors.U)):
            tp = getattr(self.plan, attr)
            extra = list(zip(tp.tile_brow[: tp.T].tolist(),
                             tp.tile_bcol[: tp.T].tolist()))
            new = plan_triangular(M, tp.cs, lower=tp.lower,
                                  extra_tiles=extra)
            if (new.T, new.K) != (tp.T, tp.K):
                raise RuntimeError("materialized factors left the tile "
                                   "plan they were factored on")
            setattr(self.plan, attr, new)

    @property
    def p(self) -> np.ndarray:
        return self._factors.p

    @property
    def q(self) -> np.ndarray:
        return self._factors.q

    @property
    def Rs(self) -> np.ndarray:
        rs = self._factors.Rs
        if isinstance(rs, torch.Tensor):  # after a device refactorization
            rs = rs.double().cpu().numpy()
            self._factors.Rs = rs
        return rs

    @property
    def chunk_size(self) -> int:
        return self.plan.cs

    @property
    def total_chunks(self) -> int:
        return self.plan.lplan.K

    # -- device state -------------------------------------------------------
    def _prepare_device(self) -> None:
        """Pack the factor nonzeros into tiles, invert the diagonal tiles
        and build the wave schedules, the permutation vectors and, at
        ``tri_mode="inv"``, the task list of the one-launch solve (the
        reference's allocate_chunks + fill_chunks!, src:151-243), then
        detect a bidiagonal chain (:meth:`_prepare_scan_path`). The bank
        has one layout in every mode: the inverses are made in
        ``"trsm"`` too (``lsolve``/``rsolve`` and the other modes share
        the waves)."""
        plan, dev = self.plan, self.device
        mode = self.config.tri_mode
        # numeric-state generation: a make_f64_ldiv callable records it and
        # refuses to run once it moved
        self._generation = getattr(self, "_generation", 0) + 1
        # only the one-launch solve reads a bfloat16 stream
        bf16 = self.config.stream_dtype == "bfloat16" and mode == "inv"

        def tri(tplan, M):
            nz = torch.as_tensor(np.asarray(M.data), dtype=self.dtype,
                                 device=dev)
            return prepare_tri_kernel(tplan, *pack_factor(tplan, nz),
                                      bf16_stream=bf16)

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
        # the whole solve as one task list (ops/fused_ldiv.py); a device
        # refactorization changes only the banks and keeps it
        self._ldiv_sched = None
        if mode == "inv":
            self._ldiv_sched = build_ldiv_schedule(
                plan.lplan, plan.uplan, pidx, qvec, self.n, cs, dev)
        # Rs in input row order: the perm-in scales before it permutes
        self._rs = torch.as_tensor(np.asarray(rs_in), dtype=self.dtype,
                                   device=dev)
        # the nd embedding's position of each input row, for the Rs of a
        # device refactorization
        self._ext_pos_dev = None if self._ext is None else torch.as_tensor(
            self._ext["pos"], dtype=torch.int64, device=dev)
        self._prepare_scan_path()

    def _prepare_scan_path(self) -> None:
        """Detect bidiagonal factors (1-D chain matrices) and stage the
        chain solve (``ops/bidiag_ldiv.py``): a chain's chunk DAG has no
        width for the tile waves, one level per chunk, while the chain's
        substitution is one prefix scan.

        Sets ``_scan_bands`` (``ld, lo, ud, uo`` on the device; ``None``
        when a factor is not bidiagonal), ``_scan_perm_id`` (no nd
        embedding and ``p``, ``q`` the identity: ``ldiv`` may run the
        chain solve) and ``_scan_planes`` (the affine coefficient planes of
        ``ops/scan_solve.chain_planes``). Runs on every re-pack, so each
        factorization is detected anew.
        """
        self._scan_bands = self._scan_planes = None
        self._scan_perm_id = False
        lb = bidiag_bands(self._factors.L, lower=True)
        if lb is None:
            return
        ub = bidiag_bands(self._factors.U, lower=False)
        if ub is None:
            return
        n = self.plan.n
        self._scan_perm_id = (
            self._ext is None
            and np.array_equal(self.plan.p, np.arange(n))
            and np.array_equal(self.plan.q, np.arange(n))
        )
        np_dt = np.float32 if self.dtype == torch.float32 else np.float64

        def dev(v):
            return torch.as_tensor(v, dtype=self.dtype, device=self.device)

        self._scan_bands = {"ld": dev(lb["diag"]), "lo": dev(lb["off"]),
                            "ud": dev(ub["diag"]), "uo": dev(ub["off"])}
        rs = self.plan.Rs if self._scan_perm_id else None
        self._scan_planes = {k: dev(v) for k, v in
                             chain_planes(lb, ub, rs, np_dt).items()}

    @property
    def _stream_dt(self) -> torch.dtype:
        """dtype of the L/U tile stream ``ldiv`` reads
        (``SolverConfig.stream_dtype``)."""
        return getattr(torch, self.config.stream_dtype)

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
        perm-in with ``Rs``, the L levels, the U levels, perm-out — at
        ``tri_mode="inv"`` in one launch of ``fused_ldiv``, in the other
        modes as ``perm_gather``, the level steps of ``blocked_tri_solve``
        and ``perm_gather``.

        ``plain=True`` runs the plain PyTorch version of the perms and of
        every wave instead; it exists to hold the kernel path against it
        on the card.
        """
        return self._solve_with(self.ldata, self.udata, self._rs, b,
                                plain=plain)

    def _solve_with(self, ldata: TriKernelData, udata: TriKernelData,
                    rs: torch.Tensor, b: torch.Tensor, *,
                    plain: bool = False) -> torch.Tensor:
        """:meth:`_direct_solve` with the given banks and row scaling.
        Reads the tile stream: the bfloat16 banks where there are some."""
        mode = self.config.tri_mode
        if plain or mode != "inv":
            gather = perm_gather_plain if plain else perm_gather
            R = b.shape[1]
            xw = gather(b, self._pidx, rs).view(
                self.plan.lplan.K + 1, self.plan.cs, R)
            blocked_tri_solve(ldata, xw, mode=mode, plain=plain, stream=True)
            blocked_tri_solve(udata, xw, mode=mode, plain=plain, stream=True)
            return gather(xw.view(-1, R), self._qidx)
        if ldata.tiles_bf16 is not None:
            return fused_ldiv_bf16(b, self._ldiv_sched, ldata.tiles_bf16,
                                   udata.tiles_bf16, rs)
        return fused_ldiv(b, self._ldiv_sched, ldata.tiles_t, udata.tiles_t,
                          rs)

    def _chain_solve(self, b: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
        """``x = A⁻¹ b`` on a chain (``_scan_perm_id``): ``Rs`` folded into
        the forward sweep, then the backward sweep, one kernel launch.
        ``plain=True`` runs the plain PyTorch scan."""
        sp_ = self._scan_planes
        solve = bidiag_ldiv_plain if plain else bidiag_ldiv
        return solve(b, lower=(sp_["aL"], sp_["sL"]),
                     upper=(sp_["aU"], sp_["sU"]))

    def _solve_once(self, b: torch.Tensor) -> torch.Tensor:
        """One direct solve of ``ldiv``: the chain solve when the factors
        are a chain under identity permutations, else the tile solve."""
        if self._scan_perm_id:
            return self._chain_solve(b)
        return self._direct_solve(b)

    def lsolve(self, b) -> torch.Tensor:
        """Solve ``L y = b`` (reference ``lsolve!``, src:349-367).

        Under ordering="nd" the factors live on the extended matrix:
        ``b`` has length ``n_factor``."""
        if self._scan_bands is not None:
            sp_ = self._scan_planes
            return self._chain_tri_solve(b, lower=(sp_["aL"], sp_["iL"]))
        return self._tri_solve(self.ldata, self.plan.lplan, b)

    def rsolve(self, b) -> torch.Tensor:
        """Solve ``U y = b`` (reference ``rsolve!``, src:374-392)."""
        if self._scan_bands is not None:
            sp_ = self._scan_planes
            return self._chain_tri_solve(b, upper=(sp_["aU"], sp_["sU"]))
        return self._tri_solve(self.udata, self.plan.uplan, b)

    def _chain_tri_solve(self, b, **planes):
        b, squeeze = self._as_rhs(b, self.n_factor)
        y = bidiag_ldiv(b, **planes)
        return y[:, 0] if squeeze else y

    def _tri_solve(self, data: TriKernelData, tplan: TriPlan, b):
        nf = self.n_factor
        b, squeeze = self._as_rhs(b, nf)
        xw = blocked_tri_solve(data, block_rhs(b, nf, tplan.K, tplan.cs),
                               mode=self.config.tri_mode)
        y = unblock_rhs(xw, nf)
        return y[:, 0] if squeeze else y

    def ldiv(self, b, *, refine_steps: int = 0) -> torch.Tensor:
        """Solve ``A x = b`` (reference ``ldiv!``, src:286-342).

        ``b`` may be ``(n,)`` or ``(n, R)``, a tensor or an array; the
        result is a tensor on the solver's device. ``refine_steps`` —
        iterative-refinement sweeps ``x += solve(b - A x)`` after the direct
        solve, with the residual in the solver's dtype. Bidiagonal factors
        under identity permutations (1-D chains, natural ordering) solve
        through the chain kernel; anything else is one launch of the tile
        solve (``fused_ldiv``), which keeps its ready flags in the solver,
        one set per CUDA stream: solves on different streams may run at
        once.
        """
        if self.m != self.n:
            raise ValueError(f"`F` is not square: m={self.m}, n={self.n}")
        b, squeeze = self._as_rhs(b)
        x = self._solve_once(b)
        for _ in range(refine_steps):
            x = x + self._solve_once(b - self.matvec(x))
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
            # after a device refactorization the host csc values are
            # stale: sync them first, or the re-pack restores the old ones
            self._materialize_factors()
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
        # the pivots (and maybe the pattern) moved: the static-pivot
        # refactorization schedule is stale, and the host values are fresh
        self._init_refactor_state()
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

    # -- device refactorization ----------------------------------------------
    @property
    def has_device_refactor(self) -> bool:
        return self._refactor_plan is not None

    def enable_device_refactor(self, *,
                               store_budget: Optional[int] = None) -> None:
        """Build (once) the static device-refactorization schedule.

        Rebuilds the solve plans on the blocked-fill closure of the input
        pattern (a tile superset of the factors' own patterns), so the
        eliminated tiles feed the solve directly, re-packs the current
        factors onto them and builds their waves once.

        ``store_budget`` — working-set ceiling in bytes for the memory
        guard (default: ``SolverConfig.refactor_store_budget``, else the
        device's free memory, ``torch.cuda.mem_get_info`` on a card).
        """
        if self._refactor_plan is not None:
            return
        from .refactor import upload_refactor_plan

        lplan, uplan, rp = self._plan_device_refactor(store_budget)
        self.plan.lplan = lplan
        self.plan.uplan = uplan
        self._refactor_dev = upload_refactor_plan(rp, self.device)
        self._refactor_plan = rp
        self._prepare_device()

    def _factor_pattern(self) -> sp.csc_matrix:
        """The pattern of the factored matrix (the nd extension under
        ordering="nd"), values 1: what the refactor plan is built on."""
        indptr, indices = self._a_factor_pattern
        nf = indptr.shape[0] - 1
        return sp.csc_matrix((np.ones(indices.shape[0]), indices, indptr),
                             shape=(nf, nf))

    def _build_refactor_plan(self, lplan: TriPlan, uplan: TriPlan):
        """The refactor plan of this factorization for the closure solve
        plans ``lplan``/``uplan``."""
        from .refactor import build_refactor_plan

        return build_refactor_plan(
            self._factor_pattern(), self._factors.p, self._factors.q,
            self.plan.cs, lplan, uplan,
            data_src=None if self._ext is None else self._ext["data_src"],
        )

    def _plan_device_refactor(self, store_budget: Optional[int] = None):
        """``(lplan, uplan, rp)``: the closure solve plans and the refactor
        plan of this factorization, under the memory guard of
        :meth:`enable_device_refactor`. Changes nothing on the solver."""
        if store_budget is None:
            store_budget = self.config.refactor_store_budget
        limit = store_budget if store_budget else _free_bytes(self.device)
        from .refactor import closure_solve_plans

        A_pat = self._factor_pattern()
        nf = A_pat.shape[0]
        lplan, uplan = closure_solve_plans(
            A_pat, self._factors.L, self._factors.U,
            self._factors.p, self._factors.q, self.plan.cs,
        )
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        cs = self.plan.cs
        K = -(-nf // cs)

        def refuse(nbytes: int, detail: str) -> None:
            raise RuntimeError(
                "device refactorization needs a working set of "
                f"~{nbytes / 1e9:.1f} GB ({detail}), above the budget "
                f"({limit / 1e9:.1f} GB). Use the host refactor() path, a "
                "smaller chunk_size, ordering='colamd' for this matrix, or "
                "raise the budget via enable_device_refactor("
                "store_budget=...) / SolverConfig.refactor_store_budget."
            )

        # fail fast before the host scheduling: a 4x envelope over the
        # merged tile store (store, the two solve banks, the assembly)
        store_bytes = 4 * (lplan.T + uplan.T + K) * cs ** 2 * itemsize
        if store_bytes > limit:
            refuse(store_bytes, "dense tile store of the elimination "
                   "closure + solve extraction")
        rp = self._build_refactor_plan(lplan, uplan)
        # precise guard now that the levels exist: the per-level inverse
        # stacks (2 * NL * BL tiles) and the unpermuted assembly store
        BL = rp.diag_ids.shape[1]
        extra = (2 * rp.NL * BL + rp.asm.TF2 + 1) * cs ** 2 * itemsize
        if store_bytes + extra > limit:
            refuse(store_bytes + extra, "tile store + per-level inverse "
                   "stacks + assembly store")
        return lplan, uplan, rp

    def refactor_numeric(self, A: sp.spmatrix, *, check: bool = False,
                         growth_limit: float = 1e7,
                         plain: bool = False) -> bool:
        """Same-pattern numeric refactorization on the device (static
        pivots): the counterpart of UMFPACK's numeric-only ``lu!``
        (reference src:247). Reuses the frozen pivot order, fill pattern
        and tile plan, and recomputes only values: span-gather assembly,
        blocked elimination, solve banks. ``A`` must have the pattern this
        factorization was built from (``ValueError`` otherwise).

        No numerical re-pivoting happens. ``self.refactor_diagnostics``
        afterwards holds 0-d device tensors ``min_pivot`` and ``growth``
        (max |factor entry| of the equilibrated system, ~1 for benign
        updates). ``check=False`` is the default on purpose, as in the JAX
        package: it keeps the call free of device synchronisation, so a
        hostile value change goes undetected unless the caller asks. With
        ``check=True`` the diagnostics are synced, and non-finite growth,
        growth above ``growth_limit`` or a zero pivot falls back to the
        host ``refactor`` (which re-pivots) and returns False. Returns True
        when the device factorization was kept.

        ``plain=True`` runs the plain PyTorch version of every kernel; it
        exists to hold the kernel path against it on the card.
        """
        from .refactor import refactor_same_pattern

        return refactor_same_pattern(
            self, sp.csc_matrix(A), check=check, growth_limit=growth_limit,
            plain=plain,
        )

    def make_refactor_solve_step(self, *, refine_steps: int = 0):
        """The fused step of a time-stepper: ``step(a_data, b) -> x``, with
        ``a_data`` A's new nonzero values (same pattern, original CSC
        order) and ``b`` an ``(n,)`` or ``(n, R)`` right-hand side.

        Refactorizes on the device (static pivots) and solves, with no
        host synchronisation — the reference lifecycle's inner loop (update
        coefficients → ``lu!`` → ``ldiv!``, test/runtests.jl:108-188).
        Does not change F's state; call ``refactor_numeric`` for that.

        ``refine_steps`` — refinement sweeps ``x += solve(b - A x)`` with
        ``A`` built from ``a_data`` on the device. A step made before a
        host ``refactor()`` raises ``RuntimeError``: that call rebuilt the
        schedule the step closes over.
        """
        from .refactor import refactor_pipeline

        self.enable_device_refactor()
        rp, dev = self._refactor_plan, self._refactor_dev
        nnz = self._csc_to_csr.shape[0]
        steps = int(refine_steps)

        def step(a_data, b):
            if self._refactor_plan is not rp:
                raise RuntimeError(
                    "stale refactor-solve step: refactor() rebuilt the "
                    "factorization after this step was created; call "
                    "make_refactor_solve_step() again"
                )
            a = torch.as_tensor(a_data, dtype=self.dtype, device=self.device)
            if a.shape != (nnz,):
                raise ValueError(f"a_data must hold the {nnz} values of A's "
                                 f"pattern, got shape {tuple(a.shape)}")
            b, squeeze = self._as_rhs(b)
            out = refactor_pipeline(a, dev)
            ldata = tri_kernel_from_bank(self.ldata, out["lbank"],
                                         out["ldiag"])
            udata = tri_kernel_from_bank(self.udata, out["ubank"],
                                         out["udiag"])
            rs = out["rs"]
            if self._ext_pos_dev is not None:
                rs = rs[self._ext_pos_dev]
            x = self._solve_with(ldata, udata, rs, b)
            if steps:
                A_new = self._csr_matrix(a)
                for _ in range(steps):
                    x = x + self._solve_with(ldata, udata, rs, b - A_new @ x)
            return x[:, 0] if squeeze else x

        return step

    def make_f64_ldiv(self, *, refine_steps: int = 2):
        """float64-accurate solves from a float32 factorization: mixed
        precision iterative refinement,

            x_0 = solve_f32(b);   x_{k+1} = x_k + solve_f32(b - A x_k),

        with the residual ``b - A x`` and ``x`` in float64 (a float64
        sparse CSR product with the CURRENT values of A) and every direct
        solve the float32 one ``ldiv`` runs (the chain kernel or one launch
        of the tile solve, with the bfloat16 tile stream where configured).
        Each sweep
        contracts the error by ~kappa(A)·eps of the stream, so a few sweeps
        reach the reference's 1e-12 bar (test/runtests.jl:25).

        Returns ``solve(b) -> x``: ``b`` ``(n,)`` or ``(n, R)``, ``x`` a
        float64 tensor on the solver's device. The callable belongs to the
        numeric state it was made on: after ``refactor``,
        ``refactor(None)`` or ``refactor_numeric`` it raises
        ``RuntimeError``; make a new one. Raises ``ValueError`` on a
        solver that is not float32.
        """
        if self.dtype != torch.float32:
            raise ValueError(
                "make_f64_ldiv refines an f32 factorization; this solver "
                f"was built with dtype={self.dtype}")
        A64 = self._csr_matrix(self._a64)
        steps = int(refine_steps)
        n = self.n
        gen = self._generation

        def solve(b):
            if self._generation != gen:
                raise RuntimeError(
                    "stale make_f64_ldiv solve: a refactorization replaced "
                    "the numeric state this callable was built on; call "
                    "make_f64_ldiv() again (generation "
                    f"{gen} -> {self._generation})")
            b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
            if b.dim() not in (1, 2) or b.shape[0] != n:
                raise ValueError(f"`b` does not have same size as F: "
                                 f"{tuple(b.shape)} vs n={n}")
            squeeze = b.dim() == 1
            if squeeze:
                b = b[:, None]
            b = b.contiguous()
            x = self._solve_once(b.float()).double()
            for _ in range(steps):
                r = b - A64 @ x
                x = x + self._solve_once(r.float()).double()
            return x[:, 0] if squeeze else x

        return solve

    # -- persistence --------------------------------------------------------
    def save_symbolic(self, path) -> None:
        """Write just the symbolic plan (``SymbolicPlan.save``, the JAX
        package's format); :meth:`save` writes the whole reusable state."""
        # after a device factorization the plan's Rs is read back first
        self._materialize_factors()
        self.plan.save(path)

    def save(self, path, *, compress: bool = False,
             values: object = "auto") -> None:
        """Write everything host-computed — the factor patterns (and
        values), ``p``, ``q``, ``Rs``, the symbolic plan, the nd embedding,
        the config (``tri_mode`` included) and A's pattern and CURRENT
        values — so :meth:`from_saved` rebuilds this solver without
        SuperLU or the planner. Uncompressed by default; ``compress=True``
        trades CPU time for disk.

        ``values`` — whether to write the factor values, the dominant
        bytes (nnz(L+U) ≫ nnz(A)):

        * ``"auto"`` (default): not when the solver has a device
          refactorization schedule (:attr:`has_device_refactor`), which is
          written instead (a light save, version 3): the reload computes
          the values from A's on the device, as this solver did.
        * ``False``: a light save in any case. Without a schedule, one is
          planned for the file alone (its memory guard may refuse); the
          solver itself is not changed.
        * ``True``: a full save (version 2), the values at the working
          precision; after a device factorization they are read back from
          the device first.
        """
        if values not in ("auto", True, False):
            raise ValueError(f"values must be 'auto', True or False, got "
                             f"{values!r}")
        light = values is False or (values == "auto"
                                    and self._refactor_plan is not None)
        plan = self.plan
        if not light:
            self._materialize_factors()
        elif self._refactor_plan is None:
            lplan, uplan, rp = self._plan_device_refactor()
            plan = dataclasses.replace(plan, lplan=lplan, uplan=uplan)
        else:
            rp = self._refactor_plan
        f = self._factors
        flat = {
            "version": np.int64(LIGHT_SAVE if light else FULL_SAVE),
            "n_orig": np.int64(self._n_orig),
            "config_json": np.frombuffer(
                json.dumps(dataclasses.asdict(self.config)).encode(),
                dtype=np.uint8),
            "nd_cutoff": np.int64(self._nd_cutoff
                                  if isinstance(self._nd_cutoff, int)
                                  else -1),
            "a_indptr": self._a_pattern[0],
            "a_indices": self._a_pattern[1],
            "a_data": self._a64.cpu().numpy(),
            "f_n": np.int64(f.n), "f_m": np.int64(f.m),
            "L_indptr": f.L.indptr, "L_indices": f.L.indices,
            "U_indptr": f.U.indptr, "U_indices": f.U.indices,
            "p": f.p, "q": f.q, "Rs": self.Rs,
        }
        if light:
            flat.update(rp.arrays())
        else:
            vdt = np.float32 if self.dtype == torch.float32 else np.float64
            flat["L_data"] = np.asarray(f.L.data, dtype=vdt)
            flat["U_data"] = np.asarray(f.U.data, dtype=vdt)
        if self._ext is not None:
            flat.update(
                ext_src=self._ext["src"], ext_pos=self._ext["pos"],
                ext_data_src=self._ext["data_src"],
                af_indptr=self._a_factor_pattern[0],
                af_indices=self._a_factor_pattern[1])
        flat.update(plan.arrays(top=_PLAN_TOP))
        (np.savez_compressed if compress else np.savez)(path, **flat)

    def close(self) -> None:
        """Release the device buffers, the refactorization's included (the
        reference's exported ``cleanup_ParallelSparseLU!``, src:31)."""
        self.ldata = self.udata = None
        self._scan_bands = self._scan_planes = None
        self._scan_perm_id = False
        self._A_dev = self._a64 = self._pidx = self._qidx = self._rs = None
        self._ldiv_sched = None
        self._csr_pattern = self._csc_to_csr = self._ext_pos_dev = None
        self._init_refactor_state()


def cleanup_ParallelSparseLU(F: ParallelSparseLU) -> None:
    """API-parity alias for the reference export (src:31)."""
    F.close()
