#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_sparse_lu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each; any failure raises and exits non-zero:

1. the card (name, power limit) and the build of the CUDA kernels (one
   ``nvcc`` per source, all started together);
2. the ldiv kernels (B1) against their plain PyTorch versions on the card:
   seeded random inputs at cs in {16, 128} and R in {1, 16, 64} in float32
   and float64, then the real waves of the headline plan (bound: max
   relative difference 1e-5 in float32, 1e-12 in float64 — summation order
   differs, no TF32 on either side);
3. the host-factorization path on the headline deployment (2D Poisson
   100x100, n=10,000, chunk_size=128, ordering="nd", nd_cutoff=512,
   float32): construct, then ``ldiv`` at R = 16, 1 and 64 and once with
   ``refine_steps=1``, checked by the normwise backward error in float64
   on the host (< 1e-3 direct, < 5e-6 refined), with both ldiv kernels
   launched;
4. the host lifecycle: ``refactor`` with new values then ``ldiv``, and a
   float64 solver held to 1e-9 of scipy's ``spsolve``;
5. the median ``ldiv`` time at R = 16 (CUDA events), kernels against the
   plain PyTorch path on the same CUDA tensors;
6. the refactorization kernels against their plain versions: span gather
   (B4, bit for bit), tile LU (B2) and the elimination's tile products
   (B3) on seeded random inputs at cs in {16, 128} in float32 and float64,
   then the real stores of both deployments — the headline and BASELINE
   config 2 (``block_banded(rng, 120, 30)``, colamd, chunk_size=128) —
   assembled and eliminated by the kernels and by the plain versions
   (bounds: ``LU_TOL`` and ``ELIM_TOL``, max relative difference over the
   real tiles);
7. the device lifecycle on the headline: construct with
   ``factorize="auto"`` (device under nd: no SuperLU), ``ldiv`` (same
   bars as phase 3), ``refactor_numeric`` with seeded same-pattern values
   then ``ldiv``, ``refactor_numeric(check=True)`` on benign values, and a
   float64 device-factorized solver held to 1e-9 of ``spsolve`` after
   ``refactor_numeric``; every kernel launched;
8. BASELINE config 2's fused step at full size: ``make_refactor_solve_step``
   at R = 8 on ``1.01 * A``, backward error < 1e-3 (the gate of
   ``bench.py:261-270``);
9. timing (CUDA events, medians): the config-2 step, ``refactor_numeric``
   on both deployments with the kernels against ``plain=True``, and each
   refactorization kernel at the headline's shapes.

Then one JSON line on the kernels, and last the device JSON line. Exits
non-zero with no result when CUDA is not available.
"""

import json
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(nx=100, ny=100, chunk_size=128, ordering="nd", nd_cutoff=512,
                R=16)
TOL = {"float32": 1e-5, "float64": 1e-12}
CONFIG2 = dict(nblocks=120, bs=30, chunk_size=128, R=8)
# the refactorization kernels against their plain versions, max relative
# difference (max |kernel - plain| / max |plain|). Both sides compute in
# the working precision with plain FP32/FP64 arithmetic, no TF32; they
# differ only in rounding order: FMA contraction and the order of the
# column updates in the tile LU, substitution instead of a library
# triangular solve for the inverses, and the order of the sums in the
# tile products. The elimination compounds that over its levels.
LU_TOL = {"float32": 1e-5, "float64": 1e-12}
ELIM_TOL = {"float32": 1e-4, "float64": 1e-11}
KERNELS = {
    # name: (route source, TPU kernel it replaces)
    "perm_gather": ("tpu_sparse_lu_torch/csrc/ldiv.cu",
                    "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "wave_apply": ("tpu_sparse_lu_torch/csrc/ldiv.cu",
                   "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "span_gather": ("tpu_sparse_lu_torch/csrc/span_gather.cu",
                    "tpu_sparse_lu/ops/pallas_span.py:72"),
    "lu_tile": ("tpu_sparse_lu_torch/csrc/lu_tile.cu",
                "tpu_sparse_lu/ops/pallas_factor.py:38"),
    "tile_mm": ("tpu_sparse_lu_torch/csrc/elim.cu",
                "tpu_sparse_lu/ops/pallas_elim.py:125"),
}


def _rel(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    ref = ref.double()
    scale = max(float(ref.abs().max()), 1e-300)
    return float((got.double() - ref).abs().max()) / scale


def _median_ms(fn, reps=50, warmup=5, setup=lambda: None) -> float:
    """Median of per-call CUDA-event times; ``setup`` runs outside them."""
    import torch

    for _ in range(warmup):
        fn(setup())
    marks = []
    for _ in range(reps):
        arg = setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(arg)
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in marks]))


def _backward_error(A, X, B) -> float:
    """max over columns of ||b - A x|| / (||A||_F ||x|| + ||b||), in f64."""
    import scipy.sparse.linalg as spla

    X = np.asarray(X, dtype=np.float64).reshape(A.shape[0], -1)
    B = np.asarray(B, dtype=np.float64).reshape(A.shape[0], -1)
    An = spla.norm(A)
    R = A @ X - B
    return max(
        np.linalg.norm(R[:, j]) / (An * np.linalg.norm(X[:, j])
                                   + np.linalg.norm(B[:, j]))
        for j in range(X.shape[1])
    )


def _headline_solver(dtype: str):
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import poisson_2d

    A = poisson_2d(HEADLINE["nx"], HEADLINE["ny"])
    cfg = SolverConfig(chunk_size=HEADLINE["chunk_size"],
                       ordering=HEADLINE["ordering"],
                       nd_cutoff=HEADLINE["nd_cutoff"], dtype=dtype)
    return A, ParallelSparseLU(A, config=cfg, device="cuda")


def phase_device():
    import torch

    from tpu_sparse_lu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built and loaded in "
          f"{build_s:.2f} s")
    print(smi)
    return name, smi


def phase_kernels_vs_plain():
    """Returns the max abs error of each kernel on the headline's real
    inputs (float32)."""
    import torch

    from tpu_sparse_lu_torch.ops.fused_ldiv import (
        make_wave, perm_gather, perm_gather_plain, wave_apply,
        wave_apply_plain,
    )

    rng = np.random.default_rng(0)
    worst = {"float32": 0.0, "float64": 0.0}

    def note(dt, got, ref):
        r = _rel(got, ref)
        if not r <= TOL[dt]:
            raise AssertionError(f"kernel differs from plain: {r:.3e} > "
                                 f"{TOL[dt]:g} ({dt})")
        worst[dt] = max(worst[dt], r)

    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        for cs in (16, 128):
            for R in (1, 16, 64):
                dev = "cuda"
                # perm_gather: 5 source blocks gathered into 6, some rows 0
                nv = 5 * cs
                v = torch.as_tensor(rng.standard_normal((nv, R)), dtype=tdt,
                                    device=dev)
                scale = torch.as_tensor(rng.random(nv) + 0.5, dtype=tdt,
                                        device=dev)
                idx = np.full(6 * cs, -1, dtype=np.int32)
                idx[: nv] = rng.permutation(nv)
                idx[nv] = nv  # outside [0, nv): read as 0 by both
                idx = torch.as_tensor(rng.permutation(idx), device=dev)
                note(dt, perm_gather(v, idx, scale),
                     perm_gather_plain(v, idx, scale))
                note(dt, perm_gather(v, idx), perm_gather_plain(v, idx))
                # wave_apply: a diagonal wave (acc=0, in place) and an
                # off-diagonal wave (acc=1, several entries per block)
                x0 = torch.as_tensor(rng.standard_normal((6, cs, R)),
                                     dtype=tdt, device=dev)
                tiles = torch.as_tensor(
                    rng.standard_normal((7, cs, cs)) / np.sqrt(cs),
                    dtype=tdt, device=dev)
                waves = [
                    make_wave([0, 2, 4], [[(1, 0)], [(3, 2)], [(6, 4)]],
                              False, dev),
                    make_wave([5, 1, 3],
                              [[(0, 0), (2, 2), (4, 4)], [(5, 2)],
                               [(6, 0), (1, 4)]], True, dev),
                ]
                for w in waves:
                    got = wave_apply(x0.clone(), tiles, w)
                    ref = wave_apply_plain(x0.clone(), tiles, w)
                    note(dt, got, ref)

    # the real waves and permutations of the headline plan, float32
    A, F = _headline_solver("float32")
    R = HEADLINE["R"]
    b = torch.as_tensor(rng.random((A.shape[0], R)), dtype=torch.float32,
                        device="cuda")
    err = {"perm_gather": 0.0, "wave_apply": 0.0}
    rel_real = 0.0
    xk = perm_gather(b, F._pidx, F._rs)
    xp = perm_gather_plain(b, F._pidx, F._rs)
    err["perm_gather"] = float((xk - xp).abs().max())
    rel_real = max(rel_real, _rel(xk, xp))
    x = xp.view(F.plan.lplan.K + 1, F.plan.cs, R)
    for data in (F.ldata, F.udata):
        for w in data.waves:
            got = wave_apply(x.clone(), data.tiles_t, w)
            x = wave_apply_plain(x, data.tiles_t, w)
            err["wave_apply"] = max(err["wave_apply"],
                                    float((got - x).abs().max()))
            rel_real = max(rel_real, _rel(got, x))
    yk = perm_gather(x.view(-1, R), F._qidx)
    yp = perm_gather_plain(x.view(-1, R), F._qidx)
    err["perm_gather"] = max(err["perm_gather"], float((yk - yp).abs().max()))
    rel_real = max(rel_real, _rel(yk, yp))
    if not rel_real <= TOL["float32"]:
        raise AssertionError(f"headline waves: kernel differs from plain "
                             f"{rel_real:.3e}")
    n_waves = len(F.ldata.waves) + len(F.udata.waves)
    print(f"phase 2 kernels vs plain: max rel diff random f32 "
          f"{worst['float32']:.3e} (bound 1e-5), f64 {worst['float64']:.3e} "
          f"(bound 1e-12); headline {n_waves} waves + 2 perms f32 "
          f"{rel_real:.3e}, max abs perm_gather {err['perm_gather']:.3e} "
          f"wave_apply {err['wave_apply']:.3e}")
    return err


def phase_main_path():
    import torch

    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather, wave_apply

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    A, F = _headline_solver("float32")
    build_s = time.perf_counter() - t0
    perm_gather.LAUNCHES = 0
    wave_apply.LAUNCHES = 0
    berr = {}
    for R, steps in ((16, 0), (1, 0), (64, 0), (16, 1)):
        shape = (A.shape[0],) if R == 1 else (A.shape[0], R)
        b = rng.random(shape).astype(np.float32)
        x = F.ldiv(b, refine_steps=steps)
        if x.device.type != "cuda" or x.shape != shape:
            raise AssertionError(f"ldiv result {x.shape} on {x.device}")
        x = x.cpu().numpy()
        if not np.isfinite(x).all():
            raise AssertionError("ldiv result is not finite")
        berr[(R, steps)] = _backward_error(A, x, b)
    torch.cuda.synchronize()
    launches = {"perm_gather": perm_gather.LAUNCHES,
                "wave_apply": wave_apply.LAUNCHES}
    for (R, steps), e in berr.items():
        bar = 1e-3 if steps == 0 else 5e-6
        if not e < bar:
            raise AssertionError(f"backward error {e:.3e} >= {bar:g} at R={R} "
                                 f"refine_steps={steps}")
    if min(launches.values()) == 0:
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}")
    print(f"phase 3 main path: n={F.n} n_factor={F.n_factor} "
          f"nnz(L+U)={F.L.nnz + F.U.nnz} K={F.plan.lplan.K} "
          f"T={F.plan.lplan.T}/{F.plan.uplan.T} levels="
          f"{F.plan.lplan.num_levels}/{F.plan.uplan.num_levels}, built in "
          f"{build_s:.2f} s; backward error R=16 {berr[16, 0]:.3e}, R=1 "
          f"{berr[1, 0]:.3e}, R=64 {berr[64, 0]:.3e}, R=16 refined "
          f"{berr[16, 1]:.3e}; launches {launches}")
    return A, F, launches


def phase_lifecycle(A, F):
    import scipy.sparse.linalg as spla
    import torch

    rng = np.random.default_rng(2)
    A2 = A.copy()
    A2.data *= 1.01
    F.refactor(A2)
    b = rng.random((A.shape[0], HEADLINE["R"])).astype(np.float32)
    x = F.ldiv(b)
    if x.device.type != "cuda":
        raise AssertionError(f"refactored ldiv result on {x.device}")
    e_refac = _backward_error(A2, x.cpu().numpy(), b)
    if not e_refac < 1e-3:
        raise AssertionError(f"refactored backward error {e_refac:.3e}")
    _, F64 = _headline_solver("float64")
    b64 = rng.random((A.shape[0], 4))
    x64 = F64.ldiv(b64)
    if x64.dtype != torch.float64 or x64.device.type != "cuda":
        raise AssertionError(f"f64 ldiv result {x64.dtype} on {x64.device}")
    ref = spla.spsolve(A.tocsc(), b64)
    rel = np.linalg.norm(x64.cpu().numpy() - ref) / np.linalg.norm(ref)
    if not rel <= 1e-9:
        raise AssertionError(f"f64 solve off scipy by {rel:.3e}")
    print(f"phase 4 lifecycle: refactor(1.01*A) then ldiv backward error "
          f"{e_refac:.3e} (bar 1e-3); float64 solver rel err vs spsolve "
          f"{rel:.3e} (bar 1e-9)")


def phase_timing(F, smi):
    import torch

    from tpu_sparse_lu_torch.ops.fused_ldiv import (
        perm_gather, perm_gather_plain,
    )
    from tpu_sparse_lu_torch.solve import blocked_tri_solve

    rng = np.random.default_rng(3)
    R = HEADLINE["R"]
    b = torch.as_tensor(rng.random((F.n, R)), dtype=F.dtype, device="cuda")
    shape = (F.plan.lplan.K + 1, F.plan.cs, R)
    ms = {
        "ldiv": _median_ms(lambda _: F._direct_solve(b)),
        "ldiv_plain": _median_ms(lambda _: F._direct_solve(b, plain=True)),
    }
    for name, fn in (("perm_gather", perm_gather),
                     ("perm_gather_plain", perm_gather_plain)):
        # perm-in and perm-out of one solve
        ms[name] = _median_ms(
            lambda _: fn(fn(b, F._pidx, F._rs), F._qidx))
    x0 = perm_gather(b, F._pidx, F._rs).view(shape)
    for name, plain in (("wave_apply", False), ("wave_apply_plain", True)):
        # the L and U waves of one solve
        ms[name] = _median_ms(
            lambda x: blocked_tri_solve(
                F.udata, blocked_tri_solve(F.ldata, x, plain=plain),
                plain=plain),
            setup=x0.clone)
    print(f"phase 5 timing on {smi}: median ldiv R={R} kernels "
          f"{ms['ldiv']:.4f} ms, plain torch {ms['ldiv_plain']:.4f} ms; "
          f"perm-in+out {ms['perm_gather']:.4f} / "
          f"{ms['perm_gather_plain']:.4f} ms; L+U waves "
          f"{ms['wave_apply']:.4f} / {ms['wave_apply_plain']:.4f} ms")
    return ms

def _config2_solver(dtype: str = "float32"):
    """BASELINE config 2 (bench.py:243-270): colamd, host factorization."""
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import block_banded

    A = block_banded(np.random.default_rng(0), CONFIG2["nblocks"],
                     CONFIG2["bs"])
    cfg = SolverConfig(chunk_size=CONFIG2["chunk_size"], dtype=dtype)
    return A, ParallelSparseLU(A, config=cfg, device="cuda")


def _device_headline(dtype: str):
    """The headline deployment with ``factorize="auto"``: device under nd."""
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import poisson_2d

    A = poisson_2d(HEADLINE["nx"], HEADLINE["ny"])
    cfg = SolverConfig(chunk_size=HEADLINE["chunk_size"],
                       ordering=HEADLINE["ordering"],
                       nd_cutoff=HEADLINE["nd_cutoff"], dtype=dtype,
                       factorize="auto")
    F = ParallelSparseLU(A, config=cfg, device="cuda")
    if F.config.factorize != "device":
        raise AssertionError(f"factorize='auto' resolved to "
                             f"{F.config.factorize!r} under nd")
    return A, F


def _same_pattern(rng, A, scale=0.05):
    A2 = A.copy()
    A2.data = A2.data * (1.0 + scale * rng.standard_normal(A2.data.shape))
    return A2


def _real_store(F, A, plain: bool):
    """The assembled store of F's refactor plan from the values of A."""
    import torch

    from tpu_sparse_lu_torch.assemble import assemble

    dev = F._refactor_dev
    a = torch.as_tensor(A.tocsc().data, dtype=F.dtype, device="cuda")
    return assemble(a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF, TF2=dev.TF2,
                    plain=plain)


def _elim_products(store, linv, uinv, sched, mm):
    """Every tile product of one elimination, in its launch order."""
    for lvl in sched.levels:
        if lvl.rows is not None:
            mm(store, store, uinv, lvl.rows, side="row", subtract=False)
        if lvl.cols is not None:
            mm(store, linv, store, lvl.cols, side="col", subtract=False)
        if lvl.schur is not None:
            mm(store, store, store, lvl.schur, side="row", subtract=True)
    return store


def phase_refactor_kernels_vs_plain():
    """Returns the max abs differences on the headline's real store
    (float32) and the worst relative differences."""
    import torch

    from tpu_sparse_lu_torch.ops.elimination import (
        eliminate, make_groups, tile_mm, tile_mm_plain,
    )
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain
    from tpu_sparse_lu_torch.ops.span_gather import (
        span_gather, span_gather_plain,
    )

    rng = np.random.default_rng(4)
    worst = {"lu_tile": {"float32": 0.0, "float64": 0.0},
             "tile_mm": {"float32": 0.0, "float64": 0.0}}

    def note(kind, dt, got, ref, bound):
        r = _rel(got, ref)
        if not r <= bound[dt]:
            raise AssertionError(f"{kind} differs from plain: {r:.3e} > "
                                 f"{bound[dt]:g} ({dt})")
        worst[kind][dt] = max(worst[kind][dt], r)

    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        for cs in (16, 128):
            # span gather: spans inside, across the ends of, and outside
            # the stream
            a = torch.as_tensor(rng.standard_normal(50 * cs), dtype=tdt,
                                device="cuda")
            n_rows = 300
            g = rng.integers(-cs, 51 * cs, n_rows)
            lo = rng.integers(0, cs, n_rows)
            hi = np.minimum(lo + rng.integers(0, cs + 1, n_rows), cs)
            gl = [torch.as_tensor(x.astype(np.int32), device="cuda")
                  for x in (g, lo, hi)]
            got = span_gather(a, *gl, cs)
            if not torch.equal(got, span_gather_plain(a, *gl, cs)):
                raise AssertionError(f"span_gather differs from plain "
                                     f"({dt}, cs={cs})")
            # tile LU of diagonally dominant tiles, in place, with inverses
            N = 7
            tiles = torch.as_tensor(
                rng.standard_normal((N, cs, cs)) + cs * np.eye(cs),
                dtype=tdt, device="cuda")
            ids = torch.as_tensor(np.array([5, 0, 3], np.int32),
                                  device="cuda")
            outs = []
            for fn in (lu_tile, lu_tile_plain):
                t = tiles.clone()
                li = torch.zeros((3, cs, cs), dtype=tdt, device="cuda")
                ui = torch.zeros_like(li)
                p = fn(t, ids, linv=li, uinv=ui)
                outs.append((t, p, li, ui))
            for got, ref in zip(outs[0], outs[1]):
                note("lu_tile", dt, got, ref, LU_TOL)
            # tile products: both strip sides, overwrite and subtract,
            # several entries per destination
            out0 = torch.as_tensor(rng.standard_normal((8, cs, cs)) / cs,
                                   dtype=tdt, device="cuda")
            b = torch.as_tensor(rng.standard_normal((5, cs, cs)) / cs,
                                dtype=tdt, device="cuda")
            cases = [
                # in place: output tile = a operand (row strips)
                (make_groups([1, 4], [[(1, 0)], [(4, 2)]], "cuda"),
                 "row", False, "out", "b"),
                # in place: output tile = b operand (column strips)
                (make_groups([2, 6], [[(3, 2)], [(0, 6)]], "cuda"),
                 "col", False, "b", "out"),
                # Schur-like: a shared destination, distinct operands
                (make_groups([7, 5], [[(0, 1), (2, 3), (4, 0)], [(3, 3)]],
                             "cuda"), "row", True, "out", "out"),
            ]
            for groups, side, sub, an, bn in cases:
                res = []
                for fn in (tile_mm, tile_mm_plain):
                    o = out0.clone()
                    ops = {"out": o, "b": b}
                    fn(o, ops[an], ops[bn], groups, side=side, subtract=sub)
                    res.append(o)
                note("tile_mm", dt, res[0], res[1], ELIM_TOL)

    # the real stores of both deployments, float32 and float64
    err = {"span_gather": 0.0, "lu_tile": 0.0, "tile_mm": 0.0}
    real = {}
    for name in ("headline", "config2"):
        for dt in ("float32", "float64"):
            if name == "headline":
                A, F = _device_headline(dt)
            else:
                A, F = _config2_solver(dt)
                F.enable_device_refactor()
            rp = F._refactor_plan
            TF = rp.TF
            sk, rk = _real_store(F, A, plain=False)
            sp_, rp_ = _real_store(F, A, plain=True)
            if not (torch.equal(sk, sp_) and torch.equal(rk, rp_)):
                raise AssertionError(f"{name} {dt}: assembly with the span "
                                     f"kernel differs from plain")
            # the first level's diagonal tiles alone through lu_tile
            lvl0 = F._refactor_dev.elim.levels[0]
            lu_out = []
            for fn in (lu_tile, lu_tile_plain):
                t = sp_.clone()
                nb = lvl0.diag.shape[0]
                li = torch.zeros((nb,) + tuple(t.shape[1:]), dtype=t.dtype,
                                 device="cuda")
                ui = torch.zeros_like(li)
                p = fn(t, lvl0.diag, linv=li, uinv=ui)
                lu_out.append((t[lvl0.diag.long()], p, li, ui))
            for got, ref in zip(lu_out[0], lu_out[1]):
                note("lu_tile", dt, got, ref, LU_TOL)
            # the whole elimination
            ek = eliminate(sp_.clone(), F._refactor_dev.elim)
            ep = eliminate(sp_.clone(), F._refactor_dev.elim, plain=True)
            note("tile_mm", dt, ek[0][:TF], ep[0][:TF], ELIM_TOL)
            note("tile_mm", dt, ek[1], ep[1], ELIM_TOL)
            for l in range(rp.NL):
                c = int(rp.diag_cnt[l])
                for i in (2, 3):
                    note("tile_mm", dt, ek[i][l, :c], ep[i][l, :c], ELIM_TOL)
            if name == "headline" and dt == "float32":
                err["lu_tile"] = max(float((g - r).abs().max())
                                     for g, r in zip(*lu_out))
                err["tile_mm"] = float((ek[0][:TF] - ep[0][:TF]).abs().max())
            real[name] = (rp.TF, rp.NL, int(rp.diag_ids.shape[1]),
                          sum(len(g[2]) for g in rp.schur_groups),
                          sum(len(g[2]) - len(g[0]) for g in rp.schur_groups))
            del F
    torch.cuda.synchronize()
    print(f"phase 6 refactor kernels vs plain: span_gather bit-exact "
          f"(random + both real assemblies); max rel diff lu_tile f32 "
          f"{worst['lu_tile']['float32']:.3e} f64 "
          f"{worst['lu_tile']['float64']:.3e} (bounds {LU_TOL['float32']:g}"
          f"/{LU_TOL['float64']:g}); elimination f32 "
          f"{worst['tile_mm']['float32']:.3e} f64 "
          f"{worst['tile_mm']['float64']:.3e} (bounds "
          f"{ELIM_TOL['float32']:g}/{ELIM_TOL['float64']:g}); real stores "
          f"(TF, levels, widest, Schur entries, shared destinations): "
          f"headline {real['headline']}, config 2 {real['config2']}; "
          f"headline f32 max abs lu_tile {err['lu_tile']:.3e} elimination "
          f"{err['tile_mm']:.3e}")
    return err


def _reset_launches():
    from tpu_sparse_lu_torch.ops.elimination import tile_mm
    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather, wave_apply
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile
    from tpu_sparse_lu_torch.ops.span_gather import span_gather

    fns = {"perm_gather": perm_gather, "wave_apply": wave_apply,
           "span_gather": span_gather, "lu_tile": lu_tile,
           "tile_mm": tile_mm}
    for f in fns.values():
        f.LAUNCHES = 0
    return lambda: {k: f.LAUNCHES for k, f in fns.items()}


def phase_device_lifecycle():
    import scipy.sparse.linalg as spla
    import torch

    rng = np.random.default_rng(5)
    R = HEADLINE["R"]
    read = _reset_launches()
    t0 = time.perf_counter()
    A, F = _device_headline("float32")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def solve_checked(M, tag):
        out = {}
        for steps in (0, 1):
            b = rng.random((A.shape[0], R)).astype(np.float32)
            x = F.ldiv(b, refine_steps=steps)
            if x.device.type != "cuda" or x.shape != b.shape:
                raise AssertionError(f"{tag}: ldiv result {x.shape} on "
                                     f"{x.device}")
            x = x.cpu().numpy()
            if not np.isfinite(x).all():
                raise AssertionError(f"{tag}: ldiv result is not finite")
            e = _backward_error(M, x, b)
            bar = 1e-3 if steps == 0 else 5e-6
            if not e < bar:
                raise AssertionError(f"{tag}: backward error {e:.3e} >= "
                                     f"{bar:g} at refine_steps={steps}")
            out[steps] = e
        return out

    e0 = solve_checked(A, "device factorization")
    A2 = _same_pattern(rng, A)
    F.refactor_numeric(A2)
    e1 = solve_checked(A2, "refactor_numeric")
    kept = F.refactor_numeric(_same_pattern(rng, A), check=True)
    if kept is not True:
        raise AssertionError("refactor_numeric(check=True) fell back on "
                             "benign values")
    d = {k: float(v) for k, v in F.refactor_diagnostics.items()}
    torch.cuda.synchronize()
    launches = read()
    if min(launches.values()) == 0:
        raise AssertionError(f"device lifecycle did not launch every "
                             f"kernel: {launches}")
    _, F64 = _device_headline("float64")
    A3 = _same_pattern(rng, A)
    F64.refactor_numeric(A3)
    b64 = rng.random((A.shape[0], 4))
    x64 = F64.ldiv(b64)
    if x64.dtype != torch.float64 or x64.device.type != "cuda":
        raise AssertionError(f"f64 ldiv result {x64.dtype} on {x64.device}")
    ref = spla.spsolve(A3.tocsc(), b64)
    rel = np.linalg.norm(x64.cpu().numpy() - ref) / np.linalg.norm(ref)
    if not rel <= 1e-9:
        raise AssertionError(f"f64 device-refactored solve off scipy by "
                             f"{rel:.3e}")
    print(f"phase 7 device lifecycle: factorize='auto' -> device, built in "
          f"{build_s:.2f} s (TF={F._refactor_plan.TF} levels="
          f"{F._refactor_plan.NL}); backward error R={R} {e0[0]:.3e}, "
          f"refined {e0[1]:.3e}; after refactor_numeric {e1[0]:.3e}, "
          f"refined {e1[1]:.3e}; check=True kept (min pivot "
          f"{d['min_pivot']:.3e}, growth {d['growth']:.3e}); float64 after "
          f"refactor_numeric rel err vs spsolve {rel:.3e} (bar 1e-9); "
          f"launches {launches}")
    return launches


def phase_config2_step():
    import torch

    rng = np.random.default_rng(6)
    read = _reset_launches()
    A, F = _config2_solver()
    step = F.make_refactor_solve_step()
    A_chk = A.copy()
    A_chk.data = A_chk.data * 1.01
    b = rng.random((A.shape[0], CONFIG2["R"])).astype(np.float32)
    x = step(A_chk.data, b)
    if x.device.type != "cuda" or x.shape != b.shape:
        raise AssertionError(f"step result {x.shape} on {x.device}")
    x = x.cpu().numpy()
    e = _backward_error(A_chk, x, b)
    # the bench gate is one normwise error over the whole panel
    bn = b.astype(np.float64)
    import scipy.sparse.linalg as spla

    r = np.linalg.norm(A_chk @ x - bn) / (
        spla.norm(A_chk) * np.linalg.norm(x) + np.linalg.norm(bn))
    if not (np.isfinite(x).all() and r < 1e-3 and e < 1e-3):
        raise AssertionError(f"config-2 fused step backward error {r:.3e} "
                             f"(per column max {e:.3e})")
    torch.cuda.synchronize()
    launches = read()
    rp = F._refactor_plan
    print(f"phase 8 config 2 fused step: n={A.shape[0]} nnz={A.nnz} "
          f"TF={rp.TF} levels={rp.NL}, R={CONFIG2['R']} on 1.01*A: "
          f"backward error {r:.3e} (per column max {e:.3e}, bar 1e-3); "
          f"launches {launches}")
    return A, F, step


def phase_refactor_timing(A2c, F2c, step, smi):
    import torch

    from tpu_sparse_lu_torch.ops.elimination import (
        eliminate, tile_mm, tile_mm_plain,
    )
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain
    from tpu_sparse_lu_torch.ops.span_gather import (
        span_gather, span_gather_plain,
    )
    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    rng = np.random.default_rng(7)
    ms = {}
    a2c = torch.as_tensor(A2c.data * 1.01, dtype=torch.float32,
                          device="cuda")
    b2c = torch.as_tensor(rng.random((A2c.shape[0], CONFIG2["R"])),
                          dtype=torch.float32, device="cuda")
    ms["config2_step"] = _median_ms(lambda _: step(a2c, b2c), reps=30)
    A, F = _device_headline("float32")
    for name, Fx, Ax in (("headline", F, A), ("config2", F2c, A2c)):
        a = torch.as_tensor(Ax.data, dtype=torch.float32, device="cuda")
        dev = Fx._refactor_dev
        for plain in (False, True):
            key = f"refactor_{name}" + ("_plain" if plain else "")
            ms[key] = _median_ms(
                lambda _: refactor_pipeline(a, dev, plain=plain),
                reps=20 if plain else 30, warmup=2)
    # each kernel alone at the headline's shapes
    dev = F._refactor_dev
    a = torch.as_tensor(A.data, dtype=torch.float32, device="cuda")
    cs = dev.cs
    a_pad = torch.zeros(cs + a.shape[0], dtype=a.dtype, device="cuda")
    a_pad[cs:] = a
    sg = (dev.asm["span_g"], dev.asm["span_lo"], dev.asm["span_hi"])
    for name, fn in (("span_gather", span_gather),
                     ("span_gather_plain", span_gather_plain)):
        ms[name] = _median_ms(lambda _: fn(a_pad, *sg, cs))
    store, _ = _real_store(F, A, plain=True)
    lvl0 = dev.elim.levels[0]
    nb = lvl0.diag.shape[0]
    li = torch.zeros((nb, cs, cs), dtype=store.dtype, device="cuda")
    ui = torch.zeros_like(li)
    for name, fn in (("lu_tile", lu_tile), ("lu_tile_plain", lu_tile_plain)):
        ms[name] = _median_ms(
            lambda t: fn(t, lvl0.diag, linv=li, uinv=ui), setup=store.clone,
            reps=30)
    _, _, linv, uinv = eliminate(store.clone(), dev.elim)
    linv, uinv = (x.reshape(-1, cs, cs) for x in (linv, uinv))
    for name, fn in (("tile_mm", tile_mm), ("tile_mm_plain", tile_mm_plain)):
        # every tile product of one elimination
        ms[name] = _median_ms(
            lambda t: _elim_products(t, linv, uinv, dev.elim, fn),
            setup=store.clone, reps=30)
    for name, plain in (("elimination", False), ("elimination_plain", True)):
        ms[name] = _median_ms(lambda t: eliminate(t, dev.elim, plain=plain),
                              setup=store.clone, reps=20 if plain else 30,
                              warmup=2)
    print(f"phase 9 refactor timing on {smi}: median config-2 fused step "
          f"R={CONFIG2['R']} {ms['config2_step']:.4f} ms; refactor_numeric "
          f"pipeline headline {ms['refactor_headline']:.4f} ms kernels / "
          f"{ms['refactor_headline_plain']:.4f} ms plain, config 2 "
          f"{ms['refactor_config2']:.4f} / {ms['refactor_config2_plain']:.4f}"
          f" ms; headline shapes: span_gather {ms['span_gather']:.4f} / "
          f"{ms['span_gather_plain']:.4f} ms, lu_tile on the {nb} level-0 "
          f"diagonal tiles with inverses {ms['lu_tile']:.4f} / "
          f"{ms['lu_tile_plain']:.4f} ms, the elimination's tile products "
          f"{ms['tile_mm']:.4f} / {ms['tile_mm_plain']:.4f} ms, whole "
          f"elimination {ms['elimination']:.4f} / "
          f"{ms['elimination_plain']:.4f} ms")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import tpu_sparse_lu_torch  # noqa: F401  (fails outside the repo)

    name, smi = phase_device()
    err = phase_kernels_vs_plain()
    A, F, launches = phase_main_path()
    phase_lifecycle(A, F)
    _, F = _headline_solver("float32")
    ms = phase_timing(F, smi)
    del F
    err.update(phase_refactor_kernels_vs_plain())
    launches.update({k: v for k, v in phase_device_lifecycle().items()
                     if k not in launches})
    A2c, F2c, step = phase_config2_step()
    ms.update(phase_refactor_timing(A2c, F2c, step, smi))
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[k], "max_abs_err": err[k], "ms": ms[k],
         "plain_ms": ms[k + "_plain"]}
        for k, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
