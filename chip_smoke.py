#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_sparse_lu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each; any failure raises and exits non-zero:

1. the card (name, power limit) and the build of the CUDA kernels;
2. each kernel against its plain PyTorch version on the card: seeded random
   inputs at cs in {16, 128} and R in {1, 16, 64} in float32 and float64,
   then the real waves of the headline plan (bound: max relative difference
   1e-5 in float32, 1e-12 in float64 — summation order differs, no TF32 on
   either side);
3. the main path on the headline deployment (2D Poisson 100x100, n=10,000,
   chunk_size=128, ordering="nd", nd_cutoff=512, float32): construct, then
   ``ldiv`` at R = 16, 1 and 64 and once with ``refine_steps=1``, checked by
   the normwise backward error in float64 on the host (< 1e-3 direct,
   < 5e-6 refined), with every kernel launched at least once;
4. the lifecycle: host ``refactor`` with new values then ``ldiv``, and a
   float64 solver held to 1e-9 of scipy's ``spsolve``;
5. the median ``ldiv`` time at R = 16 (CUDA events), kernels against the
   plain PyTorch path on the same CUDA tensors.

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
KERNEL_SOURCE = "tpu_sparse_lu_torch/csrc/ldiv.cu"
TPU_KERNEL = "tpu_sparse_lu/ops/pallas_ldiv.py:571"


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
    kernels = [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[k],
         "max_abs_err": err[k], "ms": ms[k], "plain_ms": ms[k + "_plain"]}
        for k in ("perm_gather", "wave_apply")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
