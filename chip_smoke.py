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
   differs, no TF32 on either side); then the one-launch solve
   ``ldiv_fused`` on the headline's real schedule, float32, float64 and
   bfloat16 tiles, R in {1, 3, 16, 64}: bit for bit equal to the 32-launch
   route (``perm_gather``, the waves, ``perm_gather``) at grid sizes 1, 7
   and the default, within ``TOL`` of the plain route, and 30 CUDA-graph
   replays at R = 16, a fresh ``b`` copied in before each, each bit for
   bit equal to the eager solve of that ``b``;
3. the host-factorization path on the headline deployment (2D Poisson
   100x100, n=10,000, chunk_size=128, ordering="nd", nd_cutoff=512,
   float32): construct, then ``ldiv`` at R = 16, 1 and 64 and once with
   ``refine_steps=1``, checked by the normwise backward error in float64
   on the host (< 1e-3 direct, < 5e-6 refined), each direct solve one
   ``ldiv_fused`` launch and no ``perm_gather`` or ``wave_apply``; then
   ``lsolve``/``rsolve`` (the waves) and the 32-launch route (bit for bit
   equal to the one-launch solve);
4. the host lifecycle: ``refactor`` with new values then ``ldiv``, and a
   float64 solver held to 1e-9 of scipy's ``spsolve``;
5. the median ``ldiv`` time at R = 16, the one-launch solve against the
   32-launch route, eager (CUDA events) and by CUDA-graph replay, and
   against the plain PyTorch path on the same CUDA tensors;
6. the refactorization kernels against their plain versions: span gather
   (bit for bit) at cs in {16, 128}, tile LU (B2) with both inverses
   and alone at cs in {16, 45, 100, 128} and the elimination's tile
   products (B3) at cs in {16, 45, 128}, on seeded random inputs in
   float32 and float64; the assembly (B4: ``assemble_tiles`` and
   ``assemble_closure``) bit for bit equal to the
   yardstick route (``span_gather`` and a PyTorch op per stage) and to the
   plain route on seeded random patterns at cs 16 and 128 and on the real
   stores of both deployments — the headline and BASELINE config 2
   (``block_banded(rng, 120, 30)``, colamd, chunk_size=128) — in float32
   and float64; then those stores eliminated by the per-level route
   (``lu_tile`` + three ``tile_mm`` a level) and by its plain version
   (bounds: ``LU_TOL`` and ``ELIM_TOL``, max relative difference over the
   real tiles), and by the one-launch elimination ``elim_fused`` at grid
   sizes 1, 7 and the default, each bit for bit equal to the per-level
   route and within ``ELIM_TOL`` of its plain twin; then
   ``refactor_numeric``'s pipeline captured in a CUDA graph on each
   deployment (float32), 10 replays on fresh seeded values, each bit for
   bit equal to its eager run;
7. the device lifecycle on the headline: construct with
   ``factorize="auto"`` (device under nd: no SuperLU), ``ldiv`` (same
   bars as phase 3), ``refactor_numeric`` with seeded same-pattern values
   then ``ldiv``, ``refactor_numeric(check=True)`` on benign values, and a
   float64 device-factorized solver held to 1e-9 of ``spsolve`` after
   ``refactor_numeric``; every kernel launched, every solve one
   ``ldiv_fused`` launch, every refactorization one ``elim_fused``
   launch, and no ``span_gather``, ``lu_tile`` or ``tile_mm``; then the
   yardstick assembly (``span_gather``) bit for bit equal to the two
   assembly kernels, and the per-level elimination (``lu_tile``,
   ``tile_mm``) to ``elim_fused``, on the last values;
8. BASELINE config 2's fused step at full size: ``make_refactor_solve_step``
   at R = 8 on ``1.01 * A``, backward error < 1e-3 (the gate of
   ``bench.py:261-270``), one ``elim_fused`` and one ``ldiv_fused``
   launch;
9. timing (CUDA events, medians): the config-2 step, ``refactor_numeric``
   on both deployments with the kernels against ``plain=True``, and each
   refactorization kernel at the headline's shapes; then device times by
   CUDA-graph replay: every tile product of one elimination (headline and
   config 2) against ``torch.bmm`` on the same products, the
   elimination as one ``elim_fused`` launch, as the per-level route and
   as the per-level route with ``bmm`` products, the config-2 step, the
   ``refactor_numeric`` pipeline, the per-level elimination less its
   tile products (its ``lu_tile`` launches), the one launch's chain bound
   (levels times ``lu_tile`` on one tile), the assembly alone (two launches against
   the yardstick route, eager and by replay) and the extraction (the
   pipeline less the elimination and the assembly) on both deployments,
   each assembly kernel alone, ``span_gather``/``lu_tile`` against
   ``index_select``/``lu_factor_ex(pivot=False)`` (TF32 off), and
   ``lu_tile`` with and without the inverses on the headline's 23
   level-0 tiles and on config 2's one-tile level 0, float32 and
   float64, and the identity residuals of its inverses on the headline's
   level-0 tiles (``||X L - I||``, ``||Y U - I||`` in float64 on the
   host, at most 10 times the plain twin's);
10. the chain kernel (B5, ``bidiag_ldiv``) against its plain version on
    seeded random bands (|a| <= 0.9) at n in {7, 128, 257, 5000, 20000,
    1,048,577} and R in {1, 3, 16} (and 64 up to n = 20,000, 300 at
    n = 257), float32 and float64, both sweeps and each alone (bound: max
    relative difference 1e-5 / 1e-12), bit for bit equal to itself at
    grids 1 and 7 and under 30 CUDA-graph replays; on config
    1's real float32 planes (a chain of near-unit multipliers) kernel and
    plain against the float64 scan of the same planes (1e-4); and
    ``wave_apply_bf16`` against its plain version on the headline's real
    waves with the bfloat16 tile stream (1e-5: both widen exactly);
11. BASELINE config 1 at full size (``laplacian_1d(20000)``, natural,
    ``pivot_threshold=0.0``, chunk_size=128, float32): bands and identity
    permutations detected, ``ldiv`` at R = 1 and 16 with one
    ``bidiag_ldiv`` launch and no wave per call and backward error < 1e-3,
    a float64 chain solver within 1e-10 of ``spsolve``, then host
    ``refactor`` (bands re-detected) and ``refactor_numeric`` (bands
    cleared, the waves serve), each followed by a checked ``ldiv``;
12. the f64 tier on the headline: float32 ``make_f64_ldiv`` within 1e-12
    of ``spsolve`` in <= 2 sweeps; ``stream_dtype="bfloat16"`` with a
    direct error in (1e-6, 3e-2), one ``ldiv_fused_bf16`` launch per
    solve, within 1e-12 after at most 8 sweeps (``BF16_SWEEPS``), and
    the 32-launch route through ``wave_apply_bf16`` bit for bit equal to
    it; after
    ``refactor_numeric`` (values scaled by 1 + 0.2 U(0, 1)) a fresh
    callable within 1e-12 of the new matrix's ``spsolve`` in <= 3 sweeps
    and the old one refused;
13. timing (CUDA events, medians): config 1's ``ldiv`` at R = 1 and 16
    through the chain kernel (eager and by graph replay), its plain scan
    and the tile waves; ``bidiag_ldiv`` at n = 1,048,577, float32 and
    float64, eager and by replay; the headline ``ldiv`` at R = 16 with
    the bfloat16 stream against float32 (one launch each, eager and by
    graph replay, and the 32-launch route beside them), its waves against
    their plain version; and ``make_f64_ldiv`` at R = 16 with the fewest
    sweeps that meet 1e-12, float32 and bfloat16 streams;
14. ``tri_mode="trsm"`` and ``"inv_refine"`` on the headline (host
    factorization): float64 ``ldiv``, ``ldiv`` after
    ``refactor_numeric(1.01·A)`` and the fused ``make_refactor_solve_step``
    on ``1.02·A`` within 1e-12 (relative 2-norm) of scipy's sparse LU
    solve refined with an extended-precision residual (``"inv"`` beside
    them at 1e-9; the fused step on seeded perturbed values, reported in
    the three modes), ``lsolve``/``rsolve`` within 1e-12 of
    ``spsolve_triangular``; float32 ``ldiv`` at R = 16 with
    backward error < 1e-3, two ``perm_gather`` launches and the waves
    (``wave_apply``: the off-diagonal waves, and under ``inv_refine`` the
    diagonal ones twice) and no ``ldiv_fused`` per solve, the kernel path
    within ``TOL`` of ``plain=True``; then each mode's ``ldiv`` at R = 16
    beside ``"inv"``, float32 and float64, eager and by CUDA-graph replay
    in two turns, the ``solve_triangular`` calls of one ``trsm`` solve
    alone (its share), and ``tri_inverse`` of both factors' diagonal tiles
    (the set-up the one bank layout costs ``trsm``); on the seeded
    perturbed values, one refinement step (the fused step with
    ``refine_steps=1``, and ``ldiv(refine_steps=1)`` after
    ``refactor_numeric``) held to 1e-12 in all three modes;
15. persistence on the headline (float32) and config 2: ``save`` full and
    light (``values=False``) into a directory of the checkout removed
    afterwards, ``from_saved`` on the card — the full reload's ``ldiv`` bit
    for bit equal to the saved solver's and launching no kernel, the light
    reload running the refactorization kernels and its ``ldiv`` bit for
    bit equal to ``refactor_numeric(A)`` on the saved solver, both with
    backward error < 1e-3 — and the headline's full file reloaded on the
    CPU (within ``TOL``); file sizes, save, reload and construction
    seconds, and the time a JAX light file's refactor plan takes to
    rebuild;
16. the native planner core (``utils/_symcore.cpp``, built with ``g++``):
    it must build; at the headline and at BASELINE config 5's one-device
    half (``block_banded(default_rng(0), 1600, 64)``, n = 102,400, colamd,
    chunk_size=128, float32) its host plan and refactor plan equal the
    NumPy planner's array by array, and the construction seconds split
    into SuperLU, host plan and refactor plan (native / NumPy forced);
17. the mesh engines over an NCCL process group of world size 1 (the one
    card): at the headline (R = 16) the psum engine, the data-parallel
    engine and the halo pipeline, at config 5 the pipeline and the psum
    engine, each within ``TOL`` of ``F.ldiv`` and timed eagerly (CUDA
    events, medians) beside it, with its collectives per solve and the
    psum engine's bytes per solve; the engines' run counted from zero
    must launch ``perm_gather`` and ``ldiv_fused``; then two ranks on the
    one card over gloo with CUDA tensors, each running the three engines,
    reported as they went (not gated).

Then one JSON line on the kernels (each with its time, its bound from
this run's bytes and FLOP against the card's published peaks, and its
library call's time or null), and last the device JSON line. Exits
non-zero with no result when CUDA is not available.
``--phases 2,3,5`` runs phase 1 and only the phases named, of 2-17, with
no result line (for iterating on one kernel: 2,3,5 for the ldiv kernels,
6,9 for the refactorization kernels and the assembly, 6,7,9 for the
one-launch elimination, 10,11,13 for the
chain kernel, 14,15 for the tri modes and persistence, 16,17 for the
planner core and the mesh engines).
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
# tile sizes of the random tile-LU checks: one partial panel of 32
# columns, ragged last panels, whole panels
LU_SIZES = (16, 45, 100, 128)
KERNELS = {
    # name: (route source, TPU kernel it replaces)
    "perm_gather": ("tpu_sparse_lu_torch/csrc/ldiv.cu",
                    "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "wave_apply": ("tpu_sparse_lu_torch/csrc/ldiv.cu",
                   "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "span_gather": ("tpu_sparse_lu_torch/csrc/span_gather.cu",
                    "tpu_sparse_lu/ops/pallas_span.py:72"),
    "assemble_tiles": ("tpu_sparse_lu_torch/csrc/assemble.cu",
                       "tpu_sparse_lu/ops/pallas_span.py:72"),
    "assemble_closure": ("tpu_sparse_lu_torch/csrc/assemble.cu",
                         "tpu_sparse_lu/ops/pallas_span.py:72"),
    "lu_tile": ("tpu_sparse_lu_torch/csrc/lu_tile.cu",
                "tpu_sparse_lu/ops/pallas_factor.py:38"),
    "tile_mm": ("tpu_sparse_lu_torch/csrc/elim.cu",
                "tpu_sparse_lu/ops/pallas_elim.py:125"),
    "elim_fused": ("tpu_sparse_lu_torch/csrc/elim_fused.cu",
                   "tpu_sparse_lu/ops/pallas_elim.py:125"),
    "wave_apply_bf16": ("tpu_sparse_lu_torch/csrc/ldiv.cu",
                        "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "bidiag_ldiv": ("tpu_sparse_lu_torch/csrc/bidiag.cu",
                    "tpu_sparse_lu/ops/scan_solve.py:181"),
    "ldiv_fused": ("tpu_sparse_lu_torch/csrc/ldiv_fused.cu",
                   "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
    "ldiv_fused_bf16": ("tpu_sparse_lu_torch/csrc/ldiv_fused.cu",
                        "tpu_sparse_lu/ops/pallas_ldiv.py:571"),
}
# R of the one-launch solve's checks, and its grid sizes (None: as many
# blocks as the card holds at once); the one-launch elimination is held to
# the per-level route at the same grids
FUSED_RS = (1, 3, 16, 64)
FUSED_GRIDS = (1, 7, None)
GRAPH_REPLAYS = 30
# CUDA-graph replays of refactor_numeric's pipeline, each on fresh values,
# held bit for bit to its eager run
REFACTOR_REPLAYS = 10
# BASELINE config 1 (bench.py:225-241): the 1-D chain, single RHS
CONFIG1 = dict(n=20000, chunk_size=128)
CHAIN_NS = (7, 128, 257, 5000, 20000, 1_048_577)
CHAIN_RS = (1, 3, 16)
# the assembly's two kernels (B4), in launch order
ASSEMBLY = ("assemble_tiles", "assemble_closure")
# grid sizes the chain kernel is held bit for bit equal at (besides the
# default, as many blocks as the card holds at once)
CHAIN_GRIDS = (1, 7)
# make_f64_ldiv sweeps tried with the bfloat16 stream at the headline:
# each contracts the error by ~0.03 there (kappa(A) ~ 6e3 against bf16's
# 8-bit mantissa), so 1e-12 takes ~6-8 sweeps
BF16_SWEEPS = (2, 4, 6, 8)
# config 1's real float32 planes against the float64 scan of the same
# planes (max relative difference); the plain scan itself reads ~6e-5
CHAIN_REAL_TOL = 1e-4


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


def _capture(fn, setup=lambda: None):
    """``fn`` captured once in a CUDA graph; returns the graph and what
    the captured call returned (each replay rewrites it). Warm-up runs
    first on the stream that is then captured, so one-time work (library
    handles, workspaces, the one-launch solve's per-stream ready flags)
    stays out of the capture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            setup()
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    setup()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


def _graph_ms(fn, reps=30, setup=lambda: None) -> float:
    """Median device time of ``fn``'s launches, captured once in a CUDA
    graph and replayed (CUDA events around each replay): no host launch
    cost. ``setup`` runs before each replay, outside the events and the
    graph."""
    graph, _ = _capture(fn, setup)
    return _median_ms(lambda _: graph.replay(), reps=reps, warmup=3,
                      setup=setup)


def _lu_tile_ms(store, diag, inverses: bool) -> float:
    """Device time (CUDA-graph replay) of one ``lu_tile`` launch on
    ``store[diag]``, with both inverses or the LU alone; the tiles are
    put back before each replay."""
    import torch

    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile

    nb, cs = diag.shape[0], store.shape[1]
    rows = diag.long()
    tiles0 = store[rows]
    piv = torch.empty(nb, dtype=store.dtype, device="cuda")
    inv = ({k: torch.empty((nb, cs, cs), dtype=store.dtype, device="cuda")
            for k in ("linv", "uinv")} if inverses else {})
    return _graph_ms(lambda: lu_tile(store, diag, piv=piv, **inv),
                     setup=lambda: store.index_copy_(0, rows, tiles0))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the card's published peaks (H100 SXM data sheet, at 700 W): HBM3 and
# FP32 FMAs outside the tensor cores (TF32 is not allowed here)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# (bytes, FLOP) of each kernel's timed call, from this run's inputs: each
# input read once, each output written once; filled by the timing phases
WORK = {}
# a latency bound beside the bytes and FLOP, where a chain of dependent
# steps sets the time (ms, from this run's measurements)
CHAIN_MS = {}
# the one PyTorch call that computes a kernel's function, timed beside it
# as a yardstick (never on the port's path), or why there is none
LIBRARY = {
    "perm_gather": "none: a gather, a scale and a -1 mask in one pass",
    "wave_apply": "none: a gather-product-scatter per wave",
    "span_gather": "torch.index_select(a_pad, 0, flat_idx), flat_idx "
                   "precomputed from the spans",
    "lu_tile": "torch.linalg.lu_factor_ex(tiles, pivot=False), eager "
               "(not capturable): the LU alone, the kernel also writes "
               "both inverses",
    "tile_mm": "torch.bmm per launch on operands gathered once; the "
               "gather, the sum by destination and the subtraction are "
               "not timed",
    "wave_apply_bf16": "none: a gather-product-scatter per wave",
    "bidiag_ldiv": "none: two affine prefix scans",
    "assemble_tiles": "none: a span gather, per-tile scatters, block-row "
                      "maxima and a transposed write in one pass",
    "assemble_closure": "none: a row gather times a per-row reciprocal, "
                        "then scattered ones",
    "ldiv_fused": "none: the whole solve in one launch",
    "ldiv_fused_bf16": "none: the whole solve in one launch",
    "elim_fused": "the per-level route with library products: per level "
                  "one lu_tile launch, the products by torch.bmm and "
                  "index_add_ (tile_mm_plain), in one CUDA graph",
}


def _bound(name):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FLOP over the FP32 peak."""
    nbytes, flop = WORK[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _headline_solver(dtype: str, stream_dtype: str = "float32"):
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import poisson_2d

    A = poisson_2d(HEADLINE["nx"], HEADLINE["ny"])
    cfg = SolverConfig(chunk_size=HEADLINE["chunk_size"],
                       ordering=HEADLINE["ordering"],
                       nd_cutoff=HEADLINE["nd_cutoff"], dtype=dtype,
                       stream_dtype=stream_dtype)
    return A, ParallelSparseLU(A, config=cfg, device="cuda")


def _fused(F, b, grid=None):
    """One launch of the one-launch solve on F's schedule and tile stream
    (what ``F.ldiv`` runs), at a given grid size."""
    from tpu_sparse_lu_torch.ops.fused_ldiv import fused_ldiv, fused_ldiv_bf16

    L, U = F.ldata, F.udata
    if L.tiles_bf16 is not None:
        return fused_ldiv_bf16(b, F._ldiv_sched, L.tiles_bf16, U.tiles_bf16,
                               F._rs, grid=grid)
    return fused_ldiv(b, F._ldiv_sched, L.tiles_t, U.tiles_t, F._rs,
                      grid=grid)


def _route32(F, b):
    """The 32-launch route on F's data and tile stream: ``perm_gather``
    (perm-in with Rs), the L and U waves of ``blocked_tri_solve``,
    ``perm_gather`` (perm-out). No entry point runs it since the one-launch
    solve; it is the yardstick that solve is held to, bit for bit."""
    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather
    from tpu_sparse_lu_torch.solve import blocked_tri_solve

    R = b.shape[1]
    xw = perm_gather(b, F._pidx, F._rs).view(F.plan.lplan.K + 1, F.plan.cs,
                                             R)
    blocked_tri_solve(F.ldata, xw, stream=True)
    blocked_tri_solve(F.udata, xw, stream=True)
    return perm_gather(xw.view(-1, R), F._qidx)


def _fused_work(F, b):
    """(bytes, FLOP) of one solve: every tile of the stream read once, b
    read and y written once, the carrier written and read once; 2 R FLOP
    per tile element."""
    banks = [d.tiles_t if d.tiles_bf16 is None else d.tiles_bf16
             for d in (F.ldata, F.udata)]
    carrier = (F.plan.lplan.K + 1) * F.plan.cs * b.shape[1] * b.element_size()
    return (_nbytes(*banks) + 2 * _nbytes(b) + 2 * carrier,
            2 * b.shape[1] * sum(t.numel() for t in banks))


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
    err.update(_phase_fused_vs_route32())
    return err


def _phase_fused_vs_route32():
    """The one-launch solve against the 32-launch route (bit for bit) and
    the plain route (``TOL``) at the headline; returns its max abs
    difference from the plain route at R = 16, float32 stream and bf16
    stream."""
    import torch

    rng = np.random.default_rng(20)
    err, worst, n_graph = {}, {}, 0
    for name, dt, stream in (("ldiv_fused", "float32", "float32"),
                             ("ldiv_fused", "float64", "float32"),
                             ("ldiv_fused_bf16", "float32", "bfloat16")):
        A, F = _headline_solver(dt, stream)
        n, tag = A.shape[0], f"{name} {dt}/{stream}"
        for R in FUSED_RS:
            b = torch.as_tensor(rng.standard_normal((n, R)), dtype=F.dtype,
                                device="cuda")
            ref = _route32(F, b)
            for grid in FUSED_GRIDS:
                got = _fused(F, b, grid)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{tag} R={R} grid={grid}: differs from the "
                        f"32-launch route by "
                        f"{float((got - ref).abs().max()):.3e}")
            plain = F._direct_solve(b, plain=True)
            r = _rel(got, plain)
            if not r <= TOL[dt]:
                raise AssertionError(f"{tag} R={R}: differs from the plain "
                                     f"route by {r:.3e} > {TOL[dt]:g}")
            worst[tag] = max(worst.get(tag, 0.0), r)
            if R == HEADLINE["R"] and dt == "float32":
                err[name] = float((got - plain).abs().max())
        # graph replays: the ready flags must read fresh in every replay
        R = HEADLINE["R"]
        sb = torch.zeros((n, R), dtype=F.dtype, device="cuda")
        graph, out = _capture(lambda: _fused(F, sb))
        for _ in range(GRAPH_REPLAYS):
            bi = torch.as_tensor(rng.standard_normal((n, R)), dtype=F.dtype,
                                 device="cuda")
            sb.copy_(bi)
            graph.replay()
            if not torch.equal(out, _fused(F, bi)):
                raise AssertionError(f"{tag}: a graph replay differs from "
                                     f"the eager solve")
            n_graph += 1
        del F
    torch.cuda.synchronize()
    print(f"phase 2 ldiv_fused vs the 32-launch route: bit for bit at R in "
          f"{list(FUSED_RS)}, grids {list(FUSED_GRIDS)} (None: resident "
          f"capacity), {n_graph} graph replays bit for bit with eager; max "
          f"rel diff from the plain route "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (bounds {TOL['float32']:g}/{TOL['float64']:g}); max abs at "
          f"R={HEADLINE['R']} f32 {err['ldiv_fused']:.3e}, bf16 stream "
          f"{err['ldiv_fused_bf16']:.3e}")
    return err


def phase_main_path():
    import torch

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    A, F = _headline_solver("float32")
    build_s = time.perf_counter() - t0
    read = _reset_launches("ldiv_fused", "perm_gather", "wave_apply")

    def launched(fn):
        before = read()
        out = fn()
        return out, {k: v - before[k] for k, v in read().items()}

    berr = {}
    for R, steps in ((16, 0), (1, 0), (64, 0), (16, 1)):
        shape = (A.shape[0],) if R == 1 else (A.shape[0], R)
        b = rng.random(shape).astype(np.float32)
        x, d = launched(lambda: F.ldiv(b, refine_steps=steps))
        if d != {"ldiv_fused": 1 + steps, "perm_gather": 0, "wave_apply": 0}:
            raise AssertionError(f"ldiv at R={R} refine_steps={steps} "
                                 f"launched {d}")
        if x.device.type != "cuda" or x.shape != shape:
            raise AssertionError(f"ldiv result {x.shape} on {x.device}")
        x = x.cpu().numpy()
        if not np.isfinite(x).all():
            raise AssertionError("ldiv result is not finite")
        berr[(R, steps)] = _backward_error(A, x, b)
    for (R, steps), e in berr.items():
        bar = 1e-3 if steps == 0 else 5e-6
        if not e < bar:
            raise AssertionError(f"backward error {e:.3e} >= {bar:g} at R={R} "
                                 f"refine_steps={steps}")
    # lsolve/rsolve run the waves; the 32-launch route is the yardstick
    n_waves = len(F.ldata.waves) + len(F.udata.waves)
    bt = rng.random((F.n_factor, 4)).astype(np.float32)
    tri = {}
    for name, M, fn in (("lsolve", F.L, F.lsolve), ("rsolve", F.U, F.rsolve)):
        y, d = launched(lambda: fn(bt))
        if d["wave_apply"] == 0 or d["ldiv_fused"] != 0:
            raise AssertionError(f"{name} launched {d}")
        tri[name] = _backward_error(M, y.cpu().numpy(), bt)
        if not tri[name] < 1e-3:
            raise AssertionError(f"{name} backward error {tri[name]:.3e}")
    b = torch.as_tensor(rng.random((A.shape[0], HEADLINE["R"])),
                        dtype=torch.float32, device="cuda")
    xs, d = launched(lambda: _route32(F, b))
    if d != {"ldiv_fused": 0, "perm_gather": 2, "wave_apply": n_waves}:
        raise AssertionError(f"the 32-launch route launched {d}")
    if not torch.equal(xs, F.ldiv(b)):
        raise AssertionError("the 32-launch route differs from ldiv")
    torch.cuda.synchronize()
    launches = read()
    print(f"phase 3 main path: n={F.n} n_factor={F.n_factor} "
          f"nnz(L+U)={F.L.nnz + F.U.nnz} K={F.plan.lplan.K} "
          f"T={F.plan.lplan.T}/{F.plan.uplan.T} levels="
          f"{F.plan.lplan.num_levels}/{F.plan.uplan.num_levels}, built in "
          f"{build_s:.2f} s; tasks {F._ldiv_sched.n_tasks}, dependencies "
          f"{F._ldiv_sched.dep.size}; backward error R=16 {berr[16, 0]:.3e}, "
          f"R=1 {berr[1, 0]:.3e}, R=64 {berr[64, 0]:.3e}, R=16 refined "
          f"{berr[16, 1]:.3e}, one ldiv_fused launch per solve and no wave; "
          f"lsolve {tri['lsolve']:.3e}, rsolve {tri['rsolve']:.3e} through "
          f"the waves; the 32-launch route ({n_waves} waves + 2 perms) bit "
          f"for bit equal; launches {launches}")
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
    routes = {"ldiv_fused": lambda: F._direct_solve(b),
              "ldiv_route32": lambda: _route32(F, b)}
    turns = {k: [] for k in routes}
    for order in (list(routes), list(routes)[::-1]):  # in turns
        for k in order:
            turns[k].append((_median_ms(lambda _: routes[k]()),
                             _graph_ms(routes[k])))
    ms = {}
    for k, t in turns.items():
        ms[k] = float(np.mean([e for e, _ in t]))
        ms[k + "_device"] = float(np.mean([g for _, g in t]))
    ms["ldiv"] = ms["ldiv_fused"]
    ms["ldiv_plain"] = ms["ldiv_fused_plain"] = _median_ms(
        lambda _: F._direct_solve(b, plain=True))
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
    x_bytes = x0.numel() * x0.element_size()
    WORK["perm_gather"] = (
        _nbytes(b, F._pidx, F._rs) + x_bytes          # perm-in
        + x_bytes + _nbytes(F._qidx) + _nbytes(b),    # perm-out
        b.numel())
    tiles = [d.tiles_t for d in (F.ldata, F.udata)]
    WORK["wave_apply"] = (_nbytes(*tiles) + 2 * x_bytes,
                          2 * R * sum(t.numel() for t in tiles))
    WORK["ldiv_fused"] = _fused_work(F, b)
    fmt = lambda k: ", ".join(f"{e:.4f} / {g:.4f}" for e, g in turns[k])
    print(f"phase 5 timing on {smi}: ldiv R={R} per solve, eager / graph "
          f"replay ms, two turns: one launch (ldiv_fused) {fmt('ldiv_fused')}"
          f"; 32-launch route {fmt('ldiv_route32')}; plain torch "
          f"{ms['ldiv_plain']:.4f} ms eager; perm-in+out "
          f"{ms['perm_gather']:.4f} / {ms['perm_gather_plain']:.4f} ms; L+U "
          f"waves {ms['wave_apply']:.4f} / {ms['wave_apply_plain']:.4f} ms "
          f"(kernels / plain, eager)")
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


def _real_store(F, A, plain: bool = False, yardstick: bool = False):
    """The assembled store of F's refactor plan from the values of A: the
    two assembly kernels, the yardstick route or the plain route."""
    import torch

    from tpu_sparse_lu_torch.assemble import assemble

    dev = F._refactor_dev
    a = torch.as_tensor(A.tocsc().data, dtype=F.dtype, device="cuda")
    return assemble(a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF, TF2=dev.TF2,
                    plain=plain, yardstick=yardstick)


def _assembly_equal(F, A, tag):
    """The two assembly kernels bit for bit equal to the yardstick and
    the plain routes on F's plan and A's values; returns TF."""
    import torch

    got = _real_store(F, A)
    for kw in ({"yardstick": True}, {"plain": True}):
        ref = _real_store(F, A, **kw)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{tag}: the assembly kernels differ from "
                                 f"the {sorted(kw)[0]} route")
    return F._refactor_plan.TF


def _assembly_checks(quick: bool = False) -> str:
    """The assembly kernels against the yardstick and plain routes on
    seeded random patterns at cs 16 and 128 (colamd, and nd for its
    identity entries) and on both deployments' real stores, float32 and
    float64 (``quick``: float32, cs 128 and the headline)."""
    import scipy.sparse as sp

    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig

    rng = np.random.default_rng(21)
    seen = []
    for dt in ("float32",) if quick else ("float32", "float64"):
        for cs, n, ordering in ((16, 300, "colamd"), (128, 900, "colamd"),
                                (128, 900, "nd"))[1 if quick else 0:]:
            A = (sp.random(n, n, density=0.01, random_state=rng,
                           format="csc") + 10 * sp.eye(n, format="csc"))
            F = ParallelSparseLU(A, config=SolverConfig(
                chunk_size=cs, ordering=ordering, nd_cutoff=64, dtype=dt),
                device="cuda")
            F.enable_device_refactor()
            seen.append(f"random cs={cs} {ordering} {dt} TF="
                        + str(_assembly_equal(F, A, f"random cs={cs} {dt}")))
        for name in ("headline",) if quick else ("headline", "config2"):
            if name == "headline":
                A, F = _device_headline(dt)
            else:
                A, F = _config2_solver(dt)
                F.enable_device_refactor()
            seen.append(f"{name} {dt} TF={_assembly_equal(F, A, name)}")
    return "bit for bit with the yardstick and plain routes: " + \
        ", ".join(seen)


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


def _lu_tile_pairs(rng, tdt, cs):
    """(kernel, plain) pairs of every output of ``lu_tile`` on seeded
    diagonally dominant tiles (3 of a bank of 7, in place), with both
    inverses and then the LU alone."""
    import torch

    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain

    tiles = torch.as_tensor(rng.standard_normal((7, cs, cs)) + cs * np.eye(cs),
                            dtype=tdt, device="cuda")
    ids = torch.as_tensor(np.array([5, 0, 3], np.int32), device="cuda")
    for inverses in (True, False):
        outs = []
        for fn in (lu_tile, lu_tile_plain):
            t = tiles.clone()
            inv = ({k: torch.zeros((3, cs, cs), dtype=tdt, device="cuda")
                    for k in ("linv", "uinv")} if inverses else {})
            p = fn(t, ids, **inv)
            outs.append((t, p, *inv.values()))
        yield from zip(*outs)


def _elim_fused_equal(store, sched, want, tag):
    """The one launch on a copy of ``store`` at every grid of
    ``FUSED_GRIDS``, each output bit for bit equal to ``want`` (the
    per-level route's); returns the default grid's outputs."""
    import torch

    from tpu_sparse_lu_torch.ops.elimination import eliminate

    for grid in FUSED_GRIDS:
        got = eliminate(store.clone(), sched, grid=grid)
        torch.cuda.synchronize()
        for what, g, w in zip(("store", "min_piv", "linv", "uinv"), got,
                              want):
            if not torch.equal(g, w):
                bad = (g != w).sum().item()
                raise AssertionError(
                    f"{tag}: elim_fused at grid {grid} differs from the "
                    f"per-level route in {what} ({bad} elements, max abs "
                    f"{float((g.double() - w.double()).abs().max()):.3e})")
    return got


def _refactor_replays(F, A, rng) -> str:
    """``refactor_numeric``'s device pipeline captured once in a CUDA
    graph on a static value tensor, then ``REFACTOR_REPLAYS`` replays,
    fresh seeded same-pattern values copied in before each, every output
    bit for bit equal to an eager run on the same values."""
    import torch

    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    dev = F._refactor_dev

    def values():
        return torch.as_tensor(_same_pattern(rng, A).tocsc().data,
                               dtype=F.dtype, device="cuda")

    a = values()
    graph, out = _capture(lambda: refactor_pipeline(a, dev))
    for r in range(REFACTOR_REPLAYS):
        fresh = values()
        a.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        want = refactor_pipeline(fresh, dev)
        for k, w in want.items():
            if not torch.equal(out[k], w):
                raise AssertionError(f"refactor_numeric replay {r}: {k} "
                                     f"differs from the eager run")
    return f"TF={dev.TF} ok"


def phase_refactor_kernels_vs_plain():
    """Returns the max abs differences on the headline's real store
    (float32) and the worst relative differences."""
    import torch

    from tpu_sparse_lu_torch.ops import elimination
    from tpu_sparse_lu_torch.ops.elimination import (
        eliminate, make_groups, tile_mm, tile_mm_plain,
    )
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain
    from tpu_sparse_lu_torch.ops.span_gather import (
        span_gather, span_gather_plain,
    )

    rng = np.random.default_rng(4)
    n_shapes = 0
    worst = {k: {"float32": 0.0, "float64": 0.0}
             for k in ("lu_tile", "tile_mm", "elim_fused")}

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
        # tile LU of diagonally dominant tiles, in place, with inverses and
        # alone: one partial panel of 32 columns (16), ragged last panels
        # (45, 100) and whole ones (128)
        for cs in LU_SIZES:
            for got, ref in _lu_tile_pairs(rng, tdt, cs):
                note("lu_tile", dt, got, ref, LU_TOL)
        # tile products: in place on a (whole rows), in place on b (whole
        # columns) and Schur-like (any split), overwrite and subtract,
        # several entries per destination; every sub-tile shape the kernel
        # is built for, then the wrapper's own pick; cs = 45 takes the
        # element-wise copies (not a multiple of 16 bytes)
        pick = elimination.pick_tile
        try:
            for cs in (16, 45, 128):
                out0 = torch.as_tensor(rng.standard_normal((8, cs, cs)) / cs,
                                       dtype=tdt, device="cuda")
                b = torch.as_tensor(rng.standard_normal((5, cs, cs)) / cs,
                                    dtype=tdt, device="cuda")
                cases = [
                    (make_groups([1, 4], [[(1, 0)], [(4, 2)]], "cuda"),
                     "row", False, "out", "b", "rows"),
                    (make_groups([2, 6], [[(3, 2)], [(0, 6)]], "cuda"),
                     "col", False, "b", "out", "cols"),
                    (make_groups([7, 5], [[(0, 1), (2, 3), (4, 0)],
                                          [(3, 3)]], "cuda"),
                     "row", True, "out", "out", None),
                ]
                for groups, side, sub, an, bn, owner in cases:
                    shapes = list(elimination.TILE_SHAPES[owner])
                    for shape in shapes + [None]:
                        elimination.pick_tile = (
                            pick if shape is None
                            else lambda *_, s=shape: s)
                        res = []
                        for fn in (tile_mm, tile_mm_plain):
                            o = out0.clone()
                            ops = {"out": o, "b": b}
                            fn(o, ops[an], ops[bn], groups, side=side,
                               subtract=sub)
                            res.append(o)
                        note("tile_mm", dt, res[0], res[1], ELIM_TOL)
                        n_shapes += 1
        finally:
            elimination.pick_tile = pick

    # the real stores of both deployments, float32 and float64
    err = {"span_gather": 0.0, "lu_tile": 0.0, "tile_mm": 0.0,
           "elim_fused": 0.0, "assemble_tiles": 0.0, "assemble_closure": 0.0}
    real, replays = {}, {}
    for name in ("headline", "config2"):
        for dt in ("float32", "float64"):
            if name == "headline":
                A, F = _device_headline(dt)
            else:
                A, F = _config2_solver(dt)
                F.enable_device_refactor()
            rp = F._refactor_plan
            TF = rp.TF
            sp_, _ = _real_store(F, A, plain=True)
            # the first level's diagonal tiles alone through lu_tile, with
            # both inverses, then the LU alone
            lvl0 = F._refactor_dev.elim.levels[0]
            nb = lvl0.diag.shape[0]
            for inverses in (True, False):
                outs = []
                for fn in (lu_tile, lu_tile_plain):
                    t = sp_.clone()
                    inv = ({k: torch.zeros((nb,) + tuple(t.shape[1:]),
                                           dtype=t.dtype, device="cuda")
                            for k in ("linv", "uinv")} if inverses else {})
                    p = fn(t, lvl0.diag, **inv)
                    outs.append((t[lvl0.diag.long()], p, *inv.values()))
                for got, ref in zip(outs[0], outs[1]):
                    note("lu_tile", dt, got, ref, LU_TOL)
                if inverses:
                    lu_out = outs
            # the whole elimination: the per-level route against its plain
            # version, the one launch bit for bit against the per-level
            # route at every grid and within ELIM_TOL of its plain twin
            sched = F._refactor_dev.elim
            ek = eliminate(sp_.clone(), sched, route="levels")
            ep = eliminate(sp_.clone(), sched, route="levels", plain=True)
            ef = _elim_fused_equal(sp_, sched, ek, f"{name} {dt}")
            efp = eliminate(sp_.clone(), sched, plain=True)
            for kind, got, ref in (("tile_mm", ek, ep),
                                   ("elim_fused", ef, efp)):
                note(kind, dt, got[0][:TF], ref[0][:TF], ELIM_TOL)
                note(kind, dt, got[1], ref[1], ELIM_TOL)
                for l in range(rp.NL):
                    c = int(rp.diag_cnt[l])
                    for i in (2, 3):
                        note(kind, dt, got[i][l, :c], ref[i][l, :c],
                             ELIM_TOL)
            if name == "headline" and dt == "float32":
                err["lu_tile"] = max(float((g - r).abs().max())
                                     for g, r in zip(*lu_out))
                err["tile_mm"] = float((ek[0][:TF] - ep[0][:TF]).abs().max())
                err["elim_fused"] = float(
                    (ef[0][:TF] - efp[0][:TF]).abs().max())
            if dt == "float32":
                replays[name] = _refactor_replays(F, A, rng)
            real[name] = (rp.TF, rp.NL, int(rp.diag_ids.shape[1]),
                          sum(len(g[2]) for g in rp.schur_groups),
                          sum(len(g[2]) - len(g[0]) for g in rp.schur_groups))
            del F
    torch.cuda.synchronize()
    asm = _assembly_checks()
    print(f"phase 6 refactor kernels vs plain: span_gather bit-exact "
          f"(random); assembly kernels {asm}; max rel diff lu_tile f32 "
          f"{worst['lu_tile']['float32']:.3e} f64 "
          f"{worst['lu_tile']['float64']:.3e} (bounds {LU_TOL['float32']:g}"
          f"/{LU_TOL['float64']:g}); elimination f32 "
          f"{worst['tile_mm']['float32']:.3e} f64 "
          f"{worst['tile_mm']['float64']:.3e} (bounds "
          f"{ELIM_TOL['float32']:g}/{ELIM_TOL['float64']:g}; {n_shapes} "
          f"random tile_mm launches over every sub-tile shape); real stores "
          f"(TF, levels, widest, Schur entries, shared destinations): "
          f"headline {real['headline']}, config 2 {real['config2']}; "
          f"headline f32 max abs lu_tile {err['lu_tile']:.3e} elimination "
          f"{err['tile_mm']:.3e}")
    print(f"phase 6 elim_fused: one launch bit for bit equal to the "
          f"per-level route (lu_tile + 3 tile_mm a level) on both real "
          f"stores, float32 and float64, at grids "
          f"{[g or 'default' for g in FUSED_GRIDS]}; against its plain twin "
          f"max rel diff f32 {worst['elim_fused']['float32']:.3e} f64 "
          f"{worst['elim_fused']['float64']:.3e} (bounds "
          f"{ELIM_TOL['float32']:g}/{ELIM_TOL['float64']:g}), headline f32 "
          f"max abs {err['elim_fused']:.3e}; refactor_numeric's pipeline "
          f"captured in a CUDA graph, {REFACTOR_REPLAYS} replays on fresh "
          f"values each bit for bit equal to its eager run: " + ", ".join(
              f"{k} {v}" for k, v in replays.items()))
    return err


def _reset_launches(*names):
    """Set every kernel's launch count to 0; returns a reader of the
    counts of ``names``."""
    from tpu_sparse_lu_torch.ops import assembly
    from tpu_sparse_lu_torch.ops.bidiag_ldiv import bidiag_ldiv
    from tpu_sparse_lu_torch.ops.elim_fused import elim_fused
    from tpu_sparse_lu_torch.ops.elimination import tile_mm
    from tpu_sparse_lu_torch.ops.fused_ldiv import (
        fused_ldiv, fused_ldiv_bf16, perm_gather, wave_apply, wave_apply_bf16,
    )
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile
    from tpu_sparse_lu_torch.ops.span_gather import span_gather

    fns = {"perm_gather": perm_gather, "wave_apply": wave_apply,
           "span_gather": span_gather, "lu_tile": lu_tile,
           "tile_mm": tile_mm, "wave_apply_bf16": wave_apply_bf16,
           "bidiag_ldiv": bidiag_ldiv, "ldiv_fused": fused_ldiv,
           "ldiv_fused_bf16": fused_ldiv_bf16, "elim_fused": elim_fused,
           "assemble_tiles": assembly.assemble_tiles,
           "assemble_closure": assembly.assemble_closure}
    for f in fns.values():
        f.LAUNCHES = 0
    return lambda: {k: fns[k].LAUNCHES for k in names}


def phase_device_lifecycle():
    import scipy.sparse.linalg as spla
    import torch

    rng = np.random.default_rng(5)
    R = HEADLINE["R"]
    read = _reset_launches("ldiv_fused", *ASSEMBLY, "elim_fused", "lu_tile",
                           "tile_mm", "span_gather", "perm_gather",
                           "wave_apply")
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
    # the fused step of a time-stepper: refactorization + refined solve
    A4 = _same_pattern(rng, A)
    b = rng.random((A.shape[0], R)).astype(np.float32)
    x = F.make_refactor_solve_step(refine_steps=1)(A4.data, b)
    e_step = _backward_error(A4, x.cpu().numpy(), b)
    if not e_step < 5e-6:
        raise AssertionError(f"refactor-solve step backward error "
                             f"{e_step:.3e}")
    kept = F.refactor_numeric(_same_pattern(rng, A), check=True)
    if kept is not True:
        raise AssertionError("refactor_numeric(check=True) fell back on "
                             "benign values")
    d = {k: float(v) for k, v in F.refactor_diagnostics.items()}
    torch.cuda.synchronize()
    launches = read()
    # four checked ldiv calls (two refined) and the refined step: 8 solves;
    # every refactorization (one assembly each) one elim_fused launch
    waves = {k: launches.pop(k)
             for k in ("span_gather", "perm_gather", "wave_apply",
                       "lu_tile", "tile_mm")}
    if (min(launches.values()) == 0 or launches["ldiv_fused"] != 8
            or launches["elim_fused"] != launches["assemble_tiles"]
            or any(waves.values())):
        raise AssertionError(f"device lifecycle did not launch every "
                             f"kernel, or not one ldiv_fused per solve, or "
                             f"not one elim_fused per refactorization, or "
                             f"a yardstick: {launches}, {waves}")
    # the yardstick assembly on the last values, bit for bit (it launches
    # span_gather once; no entry point does since the assembly kernels)
    a_last = F._a64.to(F.dtype)
    dev = F._refactor_dev
    kw = dict(n=dev.n, cs=dev.cs, TF=dev.TF, TF2=dev.TF2)
    from tpu_sparse_lu_torch.assemble import assemble

    mine, yard = (assemble(a_last, dev.asm, yardstick=y, **kw)
                  for y in (False, True))
    if not all(torch.equal(p, q) for p, q in zip(mine, yard)):
        raise AssertionError("the assembly kernels differ from the yardstick "
                             "on the lifecycle's values")
    # the per-level elimination (lu_tile, tile_mm) on the last values'
    # store, bit for bit (it launches both; no entry point does since the
    # one-launch elimination)
    from tpu_sparse_lu_torch.ops.elimination import eliminate

    store = mine[0]
    _elim_fused_equal(store, dev.elim,
                      eliminate(store.clone(), dev.elim, route="levels"),
                      "device lifecycle")
    torch.cuda.synchronize()
    yard = read()
    for k in ("span_gather", "lu_tile", "tile_mm"):
        launches[k] = yard[k]
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
          f"refined {e1[1]:.3e}; refactor-solve step refined "
          f"{e_step:.3e}; check=True kept (min pivot "
          f"{d['min_pivot']:.3e}, growth {d['growth']:.3e}); float64 after "
          f"refactor_numeric rel err vs spsolve {rel:.3e} (bar 1e-9); "
          f"launches {launches}")
    return launches


def phase_config2_step():
    import torch

    rng = np.random.default_rng(6)
    read = _reset_launches("ldiv_fused", *ASSEMBLY, "elim_fused",
                           "span_gather", "lu_tile", "tile_mm", "perm_gather",
                           "wave_apply")
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
    if ((launches["ldiv_fused"], launches["elim_fused"],
         launches["span_gather"], launches["lu_tile"], launches["tile_mm"],
         launches["perm_gather"], launches["wave_apply"])
            != (1, 1, 0, 0, 0, 0, 0)
            or any(launches[k] != 1 for k in ASSEMBLY)):
        raise AssertionError(f"config-2 step launched {launches}")
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
    for name, kw, reps in (("elimination", {}, 30),
                           ("elimination_plain", {"plain": True}, 10),
                           ("elimination_levels", {"route": "levels"}, 30)):
        ms[name] = _median_ms(lambda t: eliminate(t, dev.elim, **kw),
                              setup=store.clone, reps=reps, warmup=2)
    ms["elim_fused"] = ms["elimination"]
    ms["elim_fused_plain"] = ms["elimination_plain"]
    ms["config2_step_graph"] = _graph_ms(lambda: step(a2c, b2c), reps=20)
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
          f"elimination (one elim_fused launch) {ms['elimination']:.4f} / "
          f"{ms['elimination_plain']:.4f} ms plain twin, per-level route "
          f"{ms['elimination_levels']:.4f} ms; config-2 fused step by "
          f"CUDA-graph replay {ms['config2_step_graph']:.4f} ms")
    rows = sg[0].shape[0]
    WORK["span_gather"] = (_nbytes(a_pad, *sg) + rows * cs * a.element_size(),
                           0)
    # read the tiles, write them and both inverses; LU 2/3 cs^3 and each
    # triangular inverse 1/3 cs^3 FLOP
    WORK["lu_tile"] = (4 * nb * cs * cs * store.element_size(),
                       nb * 4 / 3 * cs ** 3)
    ms.update(_refactor_device_times(
        (("headline", F, A), ("config2", F2c, A2c)), ms, smi))
    ms.update(_assembly_times((("headline", F, A), ("config2", F2c, A2c)),
                              ms, smi))
    # the library calls of B4 and B2 at the same shapes, device times
    g, lo, hi = (x.long() for x in sg)
    k = torch.arange(cs, device="cuda")
    idx = g[:, None] + k[None, :]
    inside = ((k >= lo[:, None]) & (k < hi[:, None]) & (idx >= 0)
              & (idx < a_pad.numel()))
    flat_idx = torch.where(inside, idx, 0).reshape(-1)  # a_pad[0] == 0
    if not torch.equal(torch.index_select(a_pad, 0, flat_idx).view(rows, cs),
                       span_gather_plain(a_pad, *sg, cs)):
        raise AssertionError("index_select yardstick differs from the span "
                             "gather")
    ms["span_gather_library"] = _graph_ms(
        lambda: torch.index_select(a_pad, 0, flat_idx))
    ms["span_gather_device"] = _graph_ms(lambda: span_gather(a_pad, *sg, cs))
    tiles0 = store[lvl0.diag.long()]
    eye = torch.eye(cs, dtype=store.dtype, device="cuda").expand(nb, cs, cs)

    def lu_and_inverses():
        lu = torch.linalg.lu_factor_ex(tiles0, pivot=False).LU
        torch.linalg.solve_triangular(lu, eye, upper=False,
                                      unitriangular=True)
        torch.linalg.solve_triangular(lu, eye, upper=True)

    # lu_factor_ex cannot be captured in a CUDA graph (it refuses the
    # capture on the card): CUDA events around the one eager call
    ms["lu_tile_library"] = _median_ms(
        lambda _: torch.linalg.lu_factor_ex(tiles0, pivot=False), reps=30)
    ms["lu_tile_library_inv"] = _median_ms(lambda _: lu_and_inverses(),
                                           reps=30)
    ms["lu_tile_device"] = _lu_tile_ms(store, lvl0.diag, True)
    ms["lu_tile_device_lu"] = _lu_tile_ms(store, lvl0.diag, False)
    # config 2's level 0: the one-tile launch its elimination pays per level
    store2, _ = _real_store(F2c, A2c, plain=True)
    diag2 = F2c._refactor_dev.elim.levels[0].diag
    ms["lu_tile_config2_device"] = _lu_tile_ms(store2, diag2, True)
    ms["lu_tile_config2_device_lu"] = _lu_tile_ms(store2, diag2, False)
    # the one launch's chain bound: a level's diagonal LU waits for the
    # last level's, so NL one-tile LUs (with inverses) in a row at
    # lu_tile's measured time for one tile
    CHAIN_MS["elim_fused"] = dev.elim.NL * ms["lu_tile_config2_device"]
    print(f"phase 9 elim_fused chain bound on {smi}: headline "
          f"{dev.elim.NL} levels x {ms['lu_tile_config2_device']:.4f} ms "
          f"(lu_tile on one tile with inverses) = "
          f"{CHAIN_MS['elim_fused']:.4f} ms; config 2 "
          f"{F2c._refactor_dev.elim.NL} levels = "
          f"{F2c._refactor_dev.elim.NL * ms['lu_tile_config2_device']:.4f}"
          f" ms; FLOP/byte bound {_bound('elim_fused')[0]:.4f} ms "
          f"({_bound('elim_fused')[1]})")
    res = {"float32": _identity_residuals(store, lvl0.diag)}
    # the same in float64
    A64, F64 = _device_headline("float64")
    store64, _ = _real_store(F64, A64, plain=True)
    diag64 = F64._refactor_dev.elim.levels[0].diag
    res["float64"] = _identity_residuals(store64, diag64)
    A2_64, F2_64 = _config2_solver("float64")
    F2_64.enable_device_refactor()
    store2_64, _ = _real_store(F2_64, A2_64, plain=True)
    diag2_64 = F2_64._refactor_dev.elim.levels[0].diag
    for tag, st, dg in (("", store64, diag64),
                        ("config2_", store2_64, diag2_64)):
        for inverses, suffix in ((True, ""), (False, "_lu")):
            ms[f"lu_tile_{tag}device{suffix}_f64"] = _lu_tile_ms(st, dg,
                                                                 inverses)
    del F64, F2_64
    print(f"phase 9 library calls on {smi} (CUDA-graph replay, TF32 off): "
          f"span_gather kernel {ms['span_gather_device']:.4f} ms vs "
          f"index_select {ms['span_gather_library']:.4f} ms; lu_tile on the "
          f"{nb} level-0 tiles kernel (LU + both inverses) "
          f"{ms['lu_tile_device']:.4f} ms vs lu_factor_ex(pivot=False) "
          f"{ms['lu_tile_library']:.4f} ms (the LU alone; eager CUDA events,"
          f" it cannot be captured), with two solve_triangular against I "
          f"{ms['lu_tile_library_inv']:.4f} ms; lu_tile LU alone "
          f"{ms['lu_tile_device_lu']:.4f} ms; config 2's level 0 "
          f"({diag2.shape[0]} tile) with inverses "
          f"{ms['lu_tile_config2_device']:.4f} ms, LU alone "
          f"{ms['lu_tile_config2_device_lu']:.4f} ms")
    print(f"phase 9 lu_tile float64 on {smi} (CUDA-graph replay): the {nb} "
          f"level-0 tiles with inverses {ms['lu_tile_device_f64']:.4f} ms, "
          f"LU alone {ms['lu_tile_device_lu_f64']:.4f} ms; config 2's "
          f"level 0 with inverses {ms['lu_tile_config2_device_f64']:.4f} ms,"
          f" LU alone {ms['lu_tile_config2_device_lu_f64']:.4f} ms; "
          f"identity residuals max_t ||X L - I||_F / ||I||_F, "
          f"||Y U - I||_F / ||I||_F on the headline's {nb} level-0 tiles "
          f"(float64 on the host), kernel / plain: " + "; ".join(
              f"{dt} L {r['lu_tile'][0]:.3e} / {r['lu_tile_plain'][0]:.3e}, "
              f"U {r['lu_tile'][1]:.3e} / {r['lu_tile_plain'][1]:.3e}"
              for dt, r in res.items()))
    return ms


def _identity_residuals(store, diag):
    """``{"lu_tile": (rl, ru), "lu_tile_plain": ...}``: the largest over
    the tiles ``store[diag]`` of ``||X L - I||_F / ||I||_F`` and
    ``||Y U - I||_F / ||I||_F``, X and Y the inverses each writes beside
    the factor L\\U it writes, in float64 on the host. The kernel's must
    be finite and at most 10 times the plain twin's (its triangular solves
    against I): the blocked inverses as accurate as a substitution to
    within an order of magnitude."""
    import torch

    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain

    nb, cs = diag.shape[0], store.shape[1]
    eye = torch.eye(cs, dtype=torch.float64)
    out = {}
    for name, fn in (("lu_tile", lu_tile), ("lu_tile_plain", lu_tile_plain)):
        t = store.clone()
        inv = [torch.zeros((nb, cs, cs), dtype=t.dtype, device="cuda")
               for _ in range(2)]
        fn(t, diag, linv=inv[0], uinv=inv[1])
        M = t[diag.long()].double().cpu()
        X, Y = (x.double().cpu() for x in inv)
        L = torch.tril(M, -1) + eye
        U = torch.triu(M)
        out[name] = tuple(
            float(torch.linalg.matrix_norm(P @ F - eye).max()) / cs ** 0.5
            for P, F in ((X, L), (Y, U)))
    for k, (got, ref) in enumerate(zip(out["lu_tile"],
                                       out["lu_tile_plain"])):
        if not (np.isfinite(got) and got <= 10 * ref):
            raise AssertionError(
                f"lu_tile's {'LU'[k]} inverse: identity residual {got:.3e} "
                f"against the plain twin's {ref:.3e} ({store.dtype})")
    return out


def _assembly_times(deployments, ms, smi):
    """The assembly alone, its two kernels against the yardstick route
    (eager and by CUDA-graph replay), the extraction (the pipeline less the
    elimination and the assembly, by replay) on each deployment; each
    assembly kernel alone at the headline (replay) and its plain twin
    (eager), with the work of each."""
    import torch

    from tpu_sparse_lu_torch.assemble import assemble
    from tpu_sparse_lu_torch.ops import assembly as AS

    out = {}
    for name, Fx, Ax in deployments:
        dev = Fx._refactor_dev
        a = torch.as_tensor(Ax.data, dtype=torch.float32, device="cuda")
        kw = dict(n=dev.n, cs=dev.cs, TF=dev.TF, TF2=dev.TF2)
        for key, yard in (("assembly", False), ("assembly_yardstick", True)):
            def fn():
                return assemble(a, dev.asm, yardstick=yard, **kw)
            out[f"{key}_{name}_graph"] = _graph_ms(fn)
            out[f"{key}_{name}"] = _median_ms(lambda _: fn(), reps=30)
        out[f"extraction_{name}_graph"] = (
            ms[f"refactor_{name}_graph"] - ms[f"elimination_{name}_graph"]
            - out[f"assembly_{name}_graph"])
        if name != "headline":
            continue
        # each kernel alone on the headline's real inputs
        rows2, rowmax = AS.assemble_tiles(a, dev.asm, dev.cs, dev.TF2)
        store, rs = AS.assemble_closure(rows2, rowmax, dev.asm, dev.n,
                                        dev.cs, dev.TF)
        calls = {
            "assemble_tiles": (AS.assemble_tiles, AS.assemble_tiles_plain,
                               (a, dev.asm, dev.cs, dev.TF2)),
            "assemble_closure": (AS.assemble_closure,
                                 AS.assemble_closure_plain,
                                 (rows2, rowmax, dev.asm, dev.n, dev.cs,
                                  dev.TF)),
        }
        for k, (fn, plain, args) in calls.items():
            out[f"{k}_device"] = _graph_ms(lambda: fn(*args))
            out[k] = _median_ms(lambda _: fn(*args))
            out[f"{k}_plain"] = _median_ms(lambda _: plain(*args), reps=20)
        asm = dev.asm
        idx = lambda *keys: _nbytes(*(asm[k] for k in keys))  # noqa: E731
        # each input read once, each output written once; one multiply per
        # closure element and one reciprocal per row of rowmax
        WORK["assemble_tiles"] = (
            _nbytes(a, rows2, rowmax) + idx(
                "k_tile_brow2", "span_g", "span_lo", "span_hi", "k_left_ptr",
                "k_left_src", "k_left_pos", "k_ones_ptr", "k_ones_pos"), 0)
        WORK["assemble_closure"] = (
            _nbytes(rows2, rowmax, store, rs) + idx(
                "k_permrow_src", "k_tile_brow2", "k_pad_ptr", "k_pad_pos"),
            store.numel() + rowmax.numel())
        out["assembly_bound_ms"] = (_nbytes(a, store, rs)
                                    / HBM_BYTES_PER_S * 1e3)
        out["assembly_store_mb"] = (_nbytes(rows2) / 1e6, _nbytes(store) / 1e6)
    print(f"phase 9 assembly on {smi} (two kernels vs the yardstick "
          f"span_gather + PyTorch route, ms eager / CUDA-graph replay): "
          + "; ".join(
              f"{n} {out[f'assembly_{n}']:.4f} / "
              f"{out[f'assembly_{n}_graph']:.4f} vs "
              f"{out[f'assembly_yardstick_{n}']:.4f} / "
              f"{out[f'assembly_yardstick_{n}_graph']:.4f}, extraction "
              f"{out[f'extraction_{n}_graph']:.4f} (pipeline "
              f"{ms[f'refactor_{n}_graph']:.4f} less elimination "
              f"{ms[f'elimination_{n}_graph']:.4f} less assembly)"
              for n, _, _ in deployments)
          + "; headline kernels alone, replay / eager / plain: "
          + ", ".join(f"{k} {out[k + '_device']:.4f} / {out[k]:.4f} / "
                      f"{out[k + '_plain']:.4f}" for k in ASSEMBLY)
          + f"; bound (value stream read, closure store and Rs written) "
          f"{out['assembly_bound_ms'] * 1e3:.2f} us; unpermuted / closure "
          f"store {out['assembly_store_mb'][0]:.1f} / "
          f"{out['assembly_store_mb'][1]:.1f} MB")
    return out


def _refactor_device_times(deployments, ms, smi):
    """Device times (CUDA-graph replay) of every tile product of one
    elimination and of the same products through ``torch.bmm``, and of
    the whole ``refactor_numeric`` pipeline, for each deployment."""
    import torch

    from tpu_sparse_lu_torch.ops.elimination import eliminate, tile_mm
    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    out, shapes = {}, {}
    for name, Fx, Ax in deployments:
        dev = Fx._refactor_dev
        cs = dev.cs
        store, _ = _real_store(Fx, Ax, plain=True)
        _, _, linv, uinv = eliminate(store.clone(), dev.elim)
        linv, uinv = (x.reshape(-1, cs, cs) for x in (linv, uinv))
        work = store.clone()
        out[f"tile_mm_{name}_device"] = _graph_ms(
            lambda: _elim_products(work, linv, uinv, dev.elim, tile_mm),
            setup=lambda: work.copy_(store))
        # each launch's operands gathered once, outside the timed window
        ops, read, inv, wrote = [], set(), 0, set()
        for lvl in dev.elim.levels:
            for g, x, y in ((lvl.rows, work, uinv), (lvl.cols, linv, work),
                            (lvl.schur, work, work)):
                if g is None:
                    continue
                ai, bi = g.a_idx.long(), g.b_idx.long()
                ops.append((x[ai], y[bi]))
                d = set(g.dst.tolist())
                wrote |= d
                if g is lvl.rows:
                    read |= set(ai.tolist())
                    inv += len(set(bi.tolist()))
                elif g is lvl.cols:
                    read |= set(bi.tolist())
                    inv += len(set(ai.tolist()))
                else:
                    read |= set(ai.tolist()) | set(bi.tolist()) | d
        prods = [torch.empty_like(x) for x, _ in ops]

        def bmm_all():
            for (x, y), p in zip(ops, prods):
                torch.bmm(x, y, out=p)

        out[f"tile_mm_{name}_library"] = _graph_ms(bmm_all)
        n_prod = sum(x.shape[0] for x, _ in ops)
        tile = cs * cs * store.element_size()
        if name == "headline":
            # store tiles read and written once, inverse tiles read once
            WORK["tile_mm"] = ((len(read) + inv + len(wrote)) * tile,
                               2 * cs ** 3 * n_prod)
        shapes[name] = (len(ops), n_prod)
        if name == "headline":
            rp, sched = Fx._refactor_plan, dev.elim
            WORK["elim_fused"] = (
                (2 * rp.TF + 2 * sched.n_diag) * tile,
                2 * cs ** 3 * n_prod + 4 / 3 * cs ** 3 * sched.n_diag)
        # the one launch, the per-level route (lu_tile + tile_mm), and the
        # per-level route with the library's products, in turns
        for key, fn in (
                ("graph", lambda: eliminate(work, dev.elim)),
                ("levels_graph",
                 lambda: eliminate(work, dev.elim, route="levels")),
                ("levels_bmm_graph", lambda: _levels_bmm(work, dev.elim))):
            out[f"elimination_{name}_{key}"] = _graph_ms(
                fn, setup=lambda: work.copy_(store), reps=20)
        a = torch.as_tensor(Ax.data, dtype=torch.float32, device="cuda")
        out[f"refactor_{name}_graph"] = _graph_ms(
            lambda: refactor_pipeline(a, dev), reps=20)
    r = {n: out[f"tile_mm_{n}_device"] / out[f"tile_mm_{n}_library"]
         for n in shapes}
    lu_sum = {n: out[f"elimination_{n}_levels_graph"]
              - out[f"tile_mm_{n}_device"] for n in shapes}
    gflop = WORK["tile_mm"][1] / 1e9
    print(f"phase 9 tile products on {smi} (CUDA-graph replay; "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}): headline "
          f"{shapes['headline'][0]} launches, {shapes['headline'][1]} "
          f"products of 128^3 ({gflop:.2f} GFLOP): tile_mm_device_ms "
          f"{out['tile_mm_headline_device']:.4f} "
          f"({gflop / out['tile_mm_headline_device']:.2f} TFLOP/s of 67), "
          f"bmm library_ms {out['tile_mm_headline_library']:.4f}, ratio "
          f"{r['headline']:.3f}; config 2 {shapes['config2'][0]} launches, "
          f"{shapes['config2'][1]} products: tile_mm_device_ms "
          f"{out['tile_mm_config2_device']:.4f}, bmm library_ms "
          f"{out['tile_mm_config2_library']:.4f}, ratio {r['config2']:.3f}; "
          f"config-2 fused step / its bmm "
          f"{ms['config2_step'] / out['tile_mm_config2_library']:.2f}; "
          f"per-level elimination graph replay headline "
          f"{out['elimination_headline_levels_graph']:.4f} ms, config 2 "
          f"{out['elimination_config2_levels_graph']:.4f} ms, of which "
          f"lu_tile (the elimination less its tile products: every lu_tile "
          f"launch, two zero-fills and a min) "
          f"{lu_sum['headline']:.4f} ms and {lu_sum['config2']:.4f} ms; "
          f"refactor_numeric pipeline graph replay headline "
          f"{out['refactor_headline_graph']:.4f} ms (eager "
          f"{ms['refactor_headline']:.4f}), config 2 "
          f"{out['refactor_config2_graph']:.4f} ms (eager "
          f"{ms['refactor_config2']:.4f})")
    print(f"phase 9 elim_fused on {smi} (CUDA-graph replay): the one launch "
          f"headline {out['elimination_headline_graph']:.4f} ms, config 2 "
          f"{out['elimination_config2_graph']:.4f} ms; the per-level route "
          f"(lu_tile + 3 tile_mm a level) "
          f"{out['elimination_headline_levels_graph']:.4f} / "
          f"{out['elimination_config2_levels_graph']:.4f} ms; the per-level "
          f"route with bmm products "
          f"{out['elimination_headline_levels_bmm_graph']:.4f} / "
          f"{out['elimination_config2_levels_bmm_graph']:.4f} ms")
    return out


def _levels_bmm(store, sched):
    """The per-level route with the library's products (the yardstick of
    ``elim_fused``, used nowhere in the port): per level one ``lu_tile``
    launch, the products by ``tile_mm_plain`` (``torch.bmm`` and
    ``index_add_``)."""
    import torch

    from tpu_sparse_lu_torch.ops.elimination import tile_mm_plain
    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile

    cs = sched.cs
    linv = torch.zeros((sched.NL * sched.BL, cs, cs), dtype=store.dtype,
                       device=store.device)
    uinv = torch.zeros_like(linv)
    piv = torch.full((max(sched.n_diag, 1),), float("inf"),
                     dtype=store.dtype, device=store.device)
    off = 0
    for lvl in sched.levels:
        n = lvl.diag.shape[0]
        s = slice(lvl.slot0, lvl.slot0 + n)
        lu_tile(store, lvl.diag, piv=piv[off:off + n], linv=linv[s],
                uinv=uinv[s])
        off += n
        for g, a, b, sub in ((lvl.rows, store, uinv, False),
                             (lvl.cols, linv, store, False),
                             (lvl.schur, store, store, True)):
            if g is not None:
                tile_mm_plain(store, a, b, g, side="row", subtract=sub)
    return store, piv.amin(), linv, uinv


def _random_planes(rng, n, tdt):
    """Seeded affine planes of a stable chain: |a| <= 0.9, s in [0.5, 1.5]."""
    import torch

    def t(v):
        return torch.as_tensor(v, dtype=tdt, device="cuda")

    return ((t(rng.uniform(-0.9, 0.9, n)), t(rng.uniform(0.5, 1.5, n))),
            (t(rng.uniform(-0.9, 0.9, n)), t(rng.uniform(0.5, 1.5, n))))


def _bidiag_checks(quick: bool = False) -> str:
    """``bidiag_ldiv`` against its plain version on seeded random planes
    (``TOL``), both sweeps and each alone, at ``CHAIN_NS`` x ``CHAIN_RS``
    (and R = 64 up to n = 20,000, R = 300 at n = 257), float32 and
    float64; bit for bit equal to itself at ``CHAIN_GRIDS``; and
    ``GRAPH_REPLAYS`` CUDA-graph replays, a fresh b copied in before
    each, bit for bit equal to the eager solve. ``quick``: n in {257,
    20000, 1,048,577}, R in {1, 16}, 10 replays."""
    import torch

    from tpu_sparse_lu_torch.ops.bidiag_ldiv import (
        bidiag_ldiv, bidiag_ldiv_plain,
    )

    rng = np.random.default_rng(10)
    worst = {"float32": 0.0, "float64": 0.0}
    n_cases = 0
    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        for n in (257, 20000, 1_048_577) if quick else CHAIN_NS:
            lower, upper = _random_planes(rng, n, tdt)
            Rs = (1, 16) if quick else (
                CHAIN_RS + ((64,) if n <= 20000 else ())
                + ((300,) if n == 257 else ()))
            for R in Rs:
                b = torch.as_tensor(rng.standard_normal((n, R)), dtype=tdt,
                                    device="cuda")
                for planes in ({"lower": lower, "upper": upper},
                               {"lower": lower}, {"upper": upper}):
                    tag = f"{dt}, n={n}, R={R}, {sorted(planes)}"
                    got = bidiag_ldiv(b, **planes)
                    r = _rel(got, bidiag_ldiv_plain(b, **planes))
                    if not r <= TOL[dt]:
                        raise AssertionError(
                            f"bidiag_ldiv differs from plain: {r:.3e} > "
                            f"{TOL[dt]:g} ({tag})")
                    worst[dt] = max(worst[dt], r)
                    for grid in CHAIN_GRIDS:
                        if not torch.equal(bidiag_ldiv(b, grid=grid,
                                                       **planes), got):
                            raise AssertionError(f"bidiag_ldiv at grid "
                                                 f"{grid} differs ({tag})")
                    n_cases += 1
    replays = 10 if quick else GRAPH_REPLAYS
    for dt, n, R in (("float32", 20000, 16), ("float64", 1_048_577, 1)):
        tdt = getattr(torch, dt)
        lower, upper = _random_planes(rng, n, tdt)
        sb = torch.zeros((n, R), dtype=tdt, device="cuda")
        graph, out = _capture(lambda: bidiag_ldiv(sb, lower, upper))
        for _ in range(replays):
            bi = torch.as_tensor(rng.standard_normal((n, R)), dtype=tdt,
                                 device="cuda")
            sb.copy_(bi)
            graph.replay()
            if not torch.equal(out, bidiag_ldiv(bi, lower, upper)):
                raise AssertionError(f"bidiag_ldiv {dt} n={n} R={R}: a graph "
                                     f"replay differs from the eager solve")
    torch.cuda.synchronize()
    return (f"max rel diff from plain f32 {worst['float32']:.3e} f64 "
            f"{worst['float64']:.3e} (bounds {TOL['float32']:g}/"
            f"{TOL['float64']:g}) over {n_cases} cases, each bit for bit "
            f"equal at grids {list(CHAIN_GRIDS)} and the default; "
            f"{2 * replays} graph replays bit for bit with eager")


def phase_chain_and_bf16_kernels_vs_plain():
    """Returns the max abs differences on the real inputs: config 1's
    planes at R = 1 (``bidiag_ldiv``) and the headline's waves with the
    bfloat16 stream (``wave_apply_bf16``)."""
    import torch

    from tpu_sparse_lu_torch.ops.bidiag_ldiv import bidiag_ldiv_plain
    from tpu_sparse_lu_torch.ops.fused_ldiv import (
        perm_gather_plain, wave_apply_bf16, wave_apply_plain,
    )

    rng = np.random.default_rng(10)
    chain = _bidiag_checks()
    # the real planes of config 1, float32, R = 1
    A, F = _config1_solver()
    sp_ = F._scan_planes
    b = torch.as_tensor(rng.random((A.shape[0], 1)), dtype=torch.float32,
                        device="cuda")
    got = F._chain_solve(b)
    ref = F._chain_solve(b, plain=True)
    err = {"bidiag_ldiv": float((got - ref).abs().max())}
    rel_chain = _rel(got, ref)
    # both against the float64 scan of the same float32 planes: a chain of
    # near-unit multipliers (kappa(A) ~ 1.6e8) keeps float32 rounding of
    # the order of 1e-5 in any evaluation order
    ref64 = bidiag_ldiv_plain(
        b.double(), lower=(sp_["aL"].double(), sp_["sL"].double()),
        upper=(sp_["aU"].double(), sp_["sU"].double()))
    acc = {"kernel": _rel(got, ref64), "plain": _rel(ref, ref64)}
    if not (acc["kernel"] <= CHAIN_REAL_TOL
            and rel_chain <= 2 * CHAIN_REAL_TOL):
        raise AssertionError(f"config 1 chain: kernel differs from plain "
                             f"{rel_chain:.3e}, from the float64 scan "
                             f"{acc['kernel']:.3e}")
    if sp_["aL"].shape != (A.shape[0],):
        raise AssertionError(f"config 1 planes {tuple(sp_['aL'].shape)}")

    # the headline's real waves with the bfloat16 tile stream
    A, Fb = _headline_solver("float32", stream_dtype="bfloat16")
    R = HEADLINE["R"]
    b = torch.as_tensor(rng.random((A.shape[0], R)), dtype=torch.float32,
                        device="cuda")
    x = perm_gather_plain(b, Fb._pidx, Fb._rs).view(
        Fb.plan.lplan.K + 1, Fb.plan.cs, R)
    err["wave_apply_bf16"] = 0.0
    rel_bf = 0.0
    for data in (Fb.ldata, Fb.udata):
        if data.tiles_bf16.dtype != torch.bfloat16:
            raise AssertionError(f"stream is {data.tiles_bf16.dtype}")
        for w in data.waves:
            got = wave_apply_bf16(x.clone(), data.tiles_bf16, w)
            x = wave_apply_plain(x, data.tiles_bf16, w)
            err["wave_apply_bf16"] = max(err["wave_apply_bf16"],
                                         float((got - x).abs().max()))
            rel_bf = max(rel_bf, _rel(got, x))
    if not rel_bf <= TOL["float32"]:
        raise AssertionError(f"headline bf16 waves: kernel differs from "
                             f"plain {rel_bf:.3e}")
    print(f"phase 10 chain + bf16 kernels vs plain: bidiag_ldiv {chain}; "
          f"config 1 real planes R=1 "
          f"kernel vs plain {rel_chain:.3e} (bound {2 * CHAIN_REAL_TOL:g}), "
          f"max abs {err['bidiag_ldiv']:.3e}, vs the float64 scan kernel "
          f"{acc['kernel']:.3e} (bound {CHAIN_REAL_TOL:g}) plain "
          f"{acc['plain']:.3e}; headline "
          f"bf16 stream {len(Fb.ldata.waves) + len(Fb.udata.waves)} waves "
          f"{rel_bf:.3e} (bound 1e-5), max abs "
          f"{err['wave_apply_bf16']:.3e}")
    return err


def _config1_solver(dtype: str = "float32", A=None):
    """BASELINE config 1 (bench.py:225-241): the 1-D Laplacian chain,
    natural ordering, no pivoting, host factorization."""
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import laplacian_1d

    A = laplacian_1d(CONFIG1["n"]) if A is None else A
    cfg = SolverConfig(chunk_size=CONFIG1["chunk_size"], ordering="natural",
                       pivot_threshold=0.0, dtype=dtype)
    return A, ParallelSparseLU(A, config=cfg, device="cuda")


def phase_config1():
    import scipy.sparse.linalg as spla
    import torch

    from tpu_sparse_lu_torch.ops.bidiag_ldiv import bidiag_ldiv
    from tpu_sparse_lu_torch.ops.fused_ldiv import fused_ldiv, wave_apply

    rng = np.random.default_rng(11)
    read = _reset_launches("bidiag_ldiv", "wave_apply", "perm_gather")
    t0 = time.perf_counter()
    A, F = _config1_solver()
    build_s = time.perf_counter() - t0
    if F._scan_bands is None or not F._scan_perm_id:
        raise AssertionError("config 1: bands or identity perms not "
                             "detected")

    def solve_checked(M, tag, R, chain=True):
        shape = (M.shape[0],) if R == 1 else (M.shape[0], R)
        b = rng.random(shape).astype(np.float32)
        fns = (bidiag_ldiv, wave_apply, fused_ldiv)
        before = [f.LAUNCHES for f in fns]
        x = F.ldiv(b)
        torch.cuda.synchronize()
        d = tuple(f.LAUNCHES - n for f, n in zip(fns, before))
        if d != ((1, 0, 0) if chain else (0, 0, 1)):
            raise AssertionError(f"{tag}: ldiv at R={R} launched {d[0]} "
                                 f"bidiag_ldiv, {d[1]} waves and {d[2]} "
                                 f"ldiv_fused")
        if x.device.type != "cuda" or x.shape != shape:
            raise AssertionError(f"{tag}: ldiv result {x.shape} on "
                                 f"{x.device}")
        x = x.cpu().numpy()
        if not np.isfinite(x).all():
            raise AssertionError(f"{tag}: ldiv result is not finite")
        e = _backward_error(M, x, b)
        if not e < 1e-3:
            raise AssertionError(f"{tag}: backward error {e:.3e} at R={R}")
        return e

    e = {R: solve_checked(A, "config 1", R) for R in (1, 16)}
    launches = read()
    # float64 chain solver against scipy
    _, F64 = _config1_solver("float64", A)
    if F64._scan_bands is None or not F64._scan_perm_id:
        raise AssertionError("config 1 float64: chain not detected")
    b64 = rng.random((A.shape[0], 3))
    x64 = F64.ldiv(b64)
    if x64.dtype != torch.float64:
        raise AssertionError(f"f64 chain result {x64.dtype}")
    ref = spla.spsolve(A.tocsc(), b64)
    rel64 = np.linalg.norm(x64.cpu().numpy() - ref) / np.linalg.norm(ref)
    if not rel64 <= 1e-10:
        raise AssertionError(f"f64 chain solve off scipy by {rel64:.3e}")
    # host refactor with new values: the bands are detected anew
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.1 * rng.random(A2.nnz))
    F.refactor(A2)
    if F._scan_bands is None or not F._scan_perm_id:
        raise AssertionError("host refactor: bands not re-detected")
    e_ref = solve_checked(A2, "host refactor", 1)
    # device refactorization: the bands are stale and cleared
    A3 = A.copy()
    A3.data = A3.data * (1.0 + 0.1 * rng.random(A3.nnz))
    F.refactor_numeric(A3)
    if F._scan_bands is not None or F._scan_perm_id:
        raise AssertionError("refactor_numeric left the chain path on")
    e_num = solve_checked(A3, "refactor_numeric", 1, chain=False)
    if launches != {"bidiag_ldiv": 2, "wave_apply": 0, "perm_gather": 0}:
        raise AssertionError(f"config 1's two ldiv calls launched "
                             f"{launches}")
    print(f"phase 11 config 1: n={A.shape[0]} nnz(L+U)={F64.L.nnz + F64.U.nnz}"
          f" K={F64.plan.lplan.K} T={F64.plan.lplan.T}/{F64.plan.uplan.T} "
          f"levels={F64.plan.lplan.num_levels}/{F64.plan.uplan.num_levels}, "
          f"built in {build_s:.2f} s; bands + identity perms detected; "
          f"backward error R=1 {e[1]:.3e}, R=16 {e[16]:.3e} (bar 1e-3), one "
          f"bidiag_ldiv and no wave per ldiv; float64 chain rel err vs "
          f"spsolve {rel64:.3e} (bar 1e-10); host refactor -> bands "
          f"re-detected, backward error {e_ref:.3e}; refactor_numeric -> "
          f"bands cleared, one ldiv_fused launch serves, backward error "
          f"{e_num:.3e}; "
          f"launches {launches}")
    return {"bidiag_ldiv": launches["bidiag_ldiv"]}


def _rel_err(x, ref) -> float:
    x = np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def phase_f64_tier():
    import scipy.sparse.linalg as spla
    import torch

    rng = np.random.default_rng(12)
    R = HEADLINE["R"]
    A, F = _headline_solver("float32")
    b = rng.random((A.shape[0], R))
    xs = spla.spsolve(A.tocsc(), b)
    names = ("ldiv_fused", "ldiv_fused_bf16", "wave_apply_bf16",
             "wave_apply", "perm_gather")
    read = _reset_launches(*names)
    f32 = {s: _rel_err(F.make_f64_ldiv(refine_steps=s)(b), xs)
           for s in (1, 2)}
    f32_steps = min((s for s, r in f32.items() if r < 1e-12), default=None)
    if f32_steps is None:
        raise AssertionError(f"f32 make_f64_ldiv misses 1e-12 in 2 sweeps: "
                             f"{f32}")
    # one ldiv_fused launch per direct solve and per sweep
    launches = read()
    if launches != dict.fromkeys(names, 0) | {"ldiv_fused": 2 + 3}:
        raise AssertionError(f"f32 make_f64_ldiv launches {launches}")
    # the bfloat16 stream: one ldiv_fused_bf16 launch per solve and sweep
    read = _reset_launches(*names)
    _, Fb = _headline_solver("float32", stream_dtype="bfloat16")
    b32 = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    x = Fb.ldiv(b32)
    direct = _rel_err(x, xs)
    bf = {s: _rel_err(Fb.make_f64_ldiv(refine_steps=s)(b), xs)
          for s in BF16_SWEEPS}
    torch.cuda.synchronize()
    launches = read()
    want = 1 + sum(1 + s for s in BF16_SWEEPS)
    if launches != dict.fromkeys(names, 0) | {"ldiv_fused_bf16": want}:
        raise AssertionError(f"bf16 stream launches {launches}")
    # the 32-launch route, through wave_apply_bf16
    n_waves = len(Fb.ldata.waves) + len(Fb.udata.waves)
    if not torch.equal(_route32(Fb, b32), x):
        raise AssertionError("the bf16 32-launch route differs from ldiv")
    torch.cuda.synchronize()
    waves = read()
    if (waves["wave_apply_bf16"] - launches["wave_apply_bf16"] != n_waves
            or waves["perm_gather"] != 2):
        raise AssertionError(f"the bf16 32-launch route launches {waves}")
    launches = waves
    if not 1e-6 < direct < 3e-2:
        raise AssertionError(f"bf16 direct rel err {direct:.3e} outside "
                             f"(1e-6, 3e-2)")
    bf_steps = min((s for s, r in bf.items() if r < 1e-12), default=None)
    if bf_steps is None or not bf[2] < direct:
        raise AssertionError(f"bf16 stream + f64 sweeps: {bf} (direct "
                             f"{direct:.3e}) never meets 1e-12")
    if Fb.ldata.tiles_t.dtype != torch.float32:
        raise AssertionError("the bank was quantized")
    # after a device refactorization: refine against the new matrix
    old = F.make_f64_ldiv()
    # values scaled by 1 + 0.2 U(0, 1): the case where the JAX tier
    # refines against the old matrix
    A3 = A.copy()
    A3.data = A3.data * (1.0 + 0.2 * rng.random(A3.nnz))
    F.refactor_numeric(A3)
    try:
        old(b)
    except RuntimeError as exc:
        if "stale make_f64_ldiv" not in str(exc):
            raise
    else:
        raise AssertionError("a stale make_f64_ldiv callable ran")
    x3 = spla.spsolve(A3.tocsc(), b)
    new = {s: _rel_err(F.make_f64_ldiv(refine_steps=s)(b), x3)
           for s in (2, 3)}
    new_steps = min((s for s, r in new.items() if r < 1e-12), default=None)
    if new_steps is None:
        raise AssertionError(f"make_f64_ldiv after refactor_numeric rel err "
                             f"{new} against the new matrix")
    print(f"phase 12 f64 tier (headline, R={R}): float32 stream rel err vs "
          f"spsolve 1 sweep {f32[1]:.3e}, 2 sweeps {f32[2]:.3e} (bar 1e-12, "
          f"met in {f32_steps}); bfloat16 stream direct {direct:.3e} (in "
          f"(1e-6, 3e-2)), "
          + ", ".join(f"{k} sweeps {v:.3e}" for k, v in bf.items())
          + f" (1e-12 met in {bf_steps}); after refactor_numeric: stale "
          f"callable refused, fresh one vs the new matrix 2 sweeps "
          f"{new[2]:.3e}, 3 sweeps {new[3]:.3e} (1e-12 met in {new_steps}); "
          f"one ldiv_fused(_bf16) launch per solve and sweep; bf16 "
          f"32-launch route bit for bit equal; launches {launches}")
    return ({k: launches[k] for k in ("wave_apply_bf16", "ldiv_fused_bf16")},
            f32_steps, bf_steps)


def phase_chain_bf16_timing(smi, f32_steps, bf_steps):
    import torch

    from tpu_sparse_lu_torch.ops.bidiag_ldiv import (
        bidiag_ldiv, bidiag_ldiv_plain,
    )
    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather
    from tpu_sparse_lu_torch.solve import blocked_tri_solve

    rng = np.random.default_rng(13)
    ms = {}
    _, F1 = _config1_solver()
    for R in (1, 16):
        b = torch.as_tensor(rng.random((F1.n, R)), dtype=torch.float32,
                            device="cuda")
        ms[f"c1_chain_R{R}"] = _median_ms(lambda _: F1._chain_solve(b))
        ms[f"c1_chain_R{R}_device"] = _graph_ms(lambda: F1._chain_solve(b))
        ms[f"c1_plain_R{R}"] = _median_ms(
            lambda _: F1._chain_solve(b, plain=True), reps=20)
        ms[f"c1_tile_R{R}"] = _median_ms(lambda _: F1._direct_solve(b),
                                         reps=10, warmup=2)
        ms[f"c1_route32_R{R}"] = _median_ms(
            lambda _: _route32(F1, b), reps=5, warmup=1)
    read = _reset_launches("perm_gather", "wave_apply", "ldiv_fused")
    _route32(F1, b)
    waves_launches = sum(read().values())
    ms["bidiag_ldiv"], ms["bidiag_ldiv_plain"] = (ms["c1_chain_R1"],
                                                  ms["c1_plain_R1"])
    ms["bidiag_ldiv_device"] = ms["c1_chain_R1_device"]
    n = CHAIN_NS[-1]
    for dt in (torch.float32, torch.float64):
        lower, upper = _random_planes(rng, n, dt)
        for R in (1, 16):
            b = torch.as_tensor(rng.random((n, R)), dtype=dt, device="cuda")
            key = f"big_{str(dt)[6:]}_R{R}"
            ms[key] = _median_ms(
                lambda _: bidiag_ldiv(b, lower=lower, upper=upper), reps=20,
                warmup=2)
            ms[key + "_device"] = _graph_ms(
                lambda: bidiag_ldiv(b, lower=lower, upper=upper))
            if dt == torch.float32:
                ms[f"big_plain_R{R}"] = _median_ms(
                    lambda _: bidiag_ldiv_plain(b, lower=lower, upper=upper),
                    reps=5, warmup=1)
    # the headline: bfloat16 stream against float32
    R = HEADLINE["R"]
    A, F = _headline_solver("float32")
    _, Fb = _headline_solver("float32", stream_dtype="bfloat16")
    b = torch.as_tensor(rng.random((A.shape[0], R)), dtype=torch.float32,
                        device="cuda")
    for key, Fx in (("f32", F), ("bf16", Fb)):
        ms[f"ldiv_{key}"] = _median_ms(lambda _: Fx._direct_solve(b))
        ms[f"ldiv_{key}_route32"] = _median_ms(
            lambda _: _route32(Fx, b))
        ms[f"ldiv_{key}_device"] = _graph_ms(lambda: Fx._direct_solve(b))
        ms[f"ldiv_{key}_route32_device"] = _graph_ms(
            lambda: _route32(Fx, b))
    ms["ldiv_fused_bf16"] = ms["ldiv_bf16"]
    ms["ldiv_fused_bf16_device"] = ms["ldiv_bf16_device"]
    ms["ldiv_fused_bf16_plain"] = _median_ms(
        lambda _: Fb._direct_solve(b, plain=True), reps=20)
    WORK["ldiv_fused_bf16"] = _fused_work(Fb, b)
    shape = (Fb.plan.lplan.K + 1, Fb.plan.cs, R)
    x0 = perm_gather(b, Fb._pidx, Fb._rs).view(shape)
    for name, plain in (("wave_apply_bf16", False),
                        ("wave_apply_bf16_plain", True)):
        ms[name] = _median_ms(
            lambda x: blocked_tri_solve(
                Fb.udata, blocked_tri_solve(Fb.ldata, x, plain=plain,
                                            stream=True),
                plain=plain, stream=True),
            setup=x0.clone)
    b64 = b.double()
    sf = F.make_f64_ldiv(refine_steps=f32_steps)
    sb = Fb.make_f64_ldiv(refine_steps=bf_steps)
    ms["f64_f32"] = _median_ms(lambda _: sf(b64), reps=20)
    ms["f64_bf16"] = _median_ms(lambda _: sb(b64), reps=20)
    nbytes = {
        "f32": sum(d.tiles_t.numel() * 4 for d in (F.ldata, F.udata)),
        "bf16": sum(d.tiles_bf16.numel() * 2 for d in (Fb.ldata, Fb.udata)),
    }
    WORK["wave_apply_bf16"] = (
        nbytes["bf16"] + 2 * _nbytes(x0),
        2 * R * sum(d.tiles_bf16.numel() for d in (Fb.ldata, Fb.udata)))
    # config 1 at R = 1: four planes and b read, x written; two FMAs a
    # row per sweep
    WORK["bidiag_ldiv"] = (_nbytes(*F1._scan_planes.values()) + 2 * F1.n * 4,
                           4 * F1.n)
    big = ", ".join(
        f"{dt} R={R} {ms[f'big_{dt}_R{R}']:.4f} / "
        f"{ms[f'big_{dt}_R{R}_device']:.4f}"
        for dt in ("float32", "float64") for R in (1, 16))
    print(f"phase 13 chain + bf16 timing on {smi}: config 1 ldiv R=1 chain "
          f"kernel {ms['c1_chain_R1']:.4f} ms eager, "
          f"{ms['c1_chain_R1_device']:.4f} ms by graph replay, plain scan "
          f"{ms['c1_plain_R1']:.4f} ms, tile solve in one ldiv_fused launch "
          f"{ms['c1_tile_R1']:.4f} ms, in {waves_launches} launches "
          f"{ms['c1_route32_R1']:.4f} ms; R=16 {ms['c1_chain_R16']:.4f} / "
          f"{ms['c1_chain_R16_device']:.4f} / "
          f"{ms['c1_plain_R16']:.4f} / {ms['c1_tile_R16']:.4f} / "
          f"{ms['c1_route32_R16']:.4f} ms; "
          f"bidiag_ldiv n={n}, eager / graph replay: {big} ms (plain f32 "
          f"R=1 {ms['big_plain_R1']:.4f}, R=16 {ms['big_plain_R16']:.4f}); "
          f"headline ldiv R={R}, eager / graph "
          f"replay, one launch and 32 launches: f32 stream "
          f"{ms['ldiv_f32']:.4f} / {ms['ldiv_f32_device']:.4f} and "
          f"{ms['ldiv_f32_route32']:.4f} / {ms['ldiv_f32_route32_device']:.4f}"
          f" ms ({nbytes['f32'] / 1e6:.1f} MB of tiles), bf16 stream "
          f"{ms['ldiv_bf16']:.4f} / {ms['ldiv_bf16_device']:.4f} and "
          f"{ms['ldiv_bf16_route32']:.4f} / "
          f"{ms['ldiv_bf16_route32_device']:.4f} ms "
          f"({nbytes['bf16'] / 1e6:.1f} MB), bf16 plain "
          f"{ms['ldiv_fused_bf16_plain']:.4f} ms; bf16 L+U waves "
          f"{ms['wave_apply_bf16']:.4f} / plain "
          f"{ms['wave_apply_bf16_plain']:.4f} ms; make_f64_ldiv R={R} f32 "
          f"stream {f32_steps} sweeps {ms['f64_f32']:.4f} ms, bf16 stream "
          f"{bf_steps} sweeps {ms['f64_bf16']:.4f} ms")
    return ms


# ---------------------------------------------------------------------------
# phases 14-15: the tri modes, persistence
# ---------------------------------------------------------------------------


def _mode_solver(dtype: str, mode: str):
    """The headline deployment (host factorization) at ``tri_mode=mode``;
    returns (A, F, construction seconds)."""
    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu_torch.models import poisson_2d

    A = poisson_2d(HEADLINE["nx"], HEADLINE["ny"])
    cfg = SolverConfig(chunk_size=HEADLINE["chunk_size"],
                       ordering=HEADLINE["ordering"],
                       nd_cutoff=HEADLINE["nd_cutoff"], dtype=dtype,
                       tri_mode=mode)
    t0 = time.perf_counter()
    F = ParallelSparseLU(A, config=cfg, device="cuda")
    import torch

    torch.cuda.synchronize()
    return A, F, time.perf_counter() - t0


def _exact_solve(A, b):
    """scipy's sparse LU solve of ``A x = b`` refined twice with the
    residual in extended precision (``np.longdouble``): x to ~1e-16
    relative, whatever cond(A), so a comparison measures the solver
    under test alone. Returns (refined x, the unrefined ``spsolve`` x)."""
    import scipy.sparse.linalg as spla

    A = A.tocsc()
    lu = spla.splu(A)
    x0 = x = lu.solve(b)
    Al, bl = A.astype(np.longdouble), np.asarray(b, np.longdouble)
    for _ in range(2):
        x = x + lu.solve(np.asarray(bl - Al @ x.astype(np.longdouble),
                                    np.float64))
    return x, x0


def _trsm_steps(F):
    """The ``"trsm"`` diagonal steps of one solve alone, on operands
    gathered beforehand: one ``solve_triangular`` per level of L and of
    U. Returns the callable and the (bytes, FLOP) of its work."""
    import torch

    R = HEADLINE["R"]
    ops, nbytes, flop = [], 0, 0
    for data in (F.ldata, F.udata):
        for w in data.waves:
            if w.accumulate:
                continue
            D = data.diag[w.dst_long].contiguous()
            r = torch.ones((D.shape[0], D.shape[1], R), dtype=D.dtype,
                           device="cuda")
            ops.append((D, r, not data.lower))
            nbytes += _nbytes(D) + 2 * _nbytes(r)
            flop += D.shape[0] * D.shape[1] ** 2 * R

    def run():
        return [torch.linalg.solve_triangular(D, r, upper=up)
                for D, r, up in ops]

    return run, (nbytes, flop)


def phase_tri_modes(smi):
    """``tri_mode="trsm"`` and ``"inv_refine"`` at the headline: float64
    within 1e-12 of scipy's sparse LU solve refined in extended precision
    (:func:`_exact_solve`; the unrefined ``spsolve`` is itself ~cond(A)·eps
    off) for ``ldiv``, after ``refactor_numeric(1.01·A)`` and the fused
    step on ``1.02·A`` (``"inv"`` beside them at its 1e-9 bar; the step on
    randomly perturbed values is reported in all three),
    ``lsolve``/``rsolve`` against ``spsolve_triangular``, float32
    backward error, the kernel path against ``plain=True``, the
    launches of the main path, and the timing beside ``"inv"``. Returns
    the launches of the float32 solves of both modes (the main path of
    this phase)."""
    import scipy.sparse.linalg as spla
    import torch

    from tpu_sparse_lu_torch.ops.tri_inverse import tri_inverse

    rng = np.random.default_rng(14)
    R = HEADLINE["R"]
    modes = ("trsm", "inv_refine")
    f64, f64_raw, perturbed, refined, build_s = {}, {}, {}, {}, {}
    b = rng.random((HEADLINE["nx"] * HEADLINE["ny"], R))
    bt = None
    for mode in ("inv",) + modes:
        A, F, build_s[mode, "float64"] = _mode_solver("float64", mode)
        if (F._ldiv_sched is None) is (mode == "inv"):
            raise AssertionError(f"{mode}: the solver took another path")
        e, raw, xs = {}, {}, {}
        A2, A4 = A.copy(), A.copy()
        A2.data *= 1.01
        A4.data *= 1.02
        # seeded random values of the same pattern, the same in each mode
        A3 = _same_pattern(np.random.default_rng(140), A)
        xs["ldiv"] = F.ldiv(b)
        F.refactor_numeric(A2)
        xs["refactor_numeric"] = F.ldiv(b)
        step = F.make_refactor_solve_step()
        xs["step"] = step(A4.data, b)
        # reported, not held to 1e-12: the static-pivot elimination of
        # perturbed values, whatever the diagonal step
        xs["perturbed"] = step(A3.data, b)
        # one refinement step meets 1e-12 on those values, in the fused
        # step and after refactor_numeric, in every mode (held below)
        xs["perturbed step+1"] = F.make_refactor_solve_step(
            refine_steps=1)(A3.data, b)
        F.refactor_numeric(A3)
        xs["perturbed ldiv+1"] = F.ldiv(b, refine_steps=1)
        for k, M in (("ldiv", A), ("refactor_numeric", A2), ("step", A4),
                     ("perturbed", A3), ("perturbed step+1", A3),
                     ("perturbed ldiv+1", A3)):
            ref, plain = _exact_solve(M, b)
            e[k], raw[k] = _rel_err(xs[k], ref), _rel_err(xs[k], plain)
        perturbed[mode] = e.pop("perturbed")
        refined[mode] = {k: e.pop(k) for k in ("perturbed step+1",
                                               "perturbed ldiv+1")}
        if not max(refined[mode].values()) <= 1e-12:
            raise AssertionError(f"{mode}: one refinement step on perturbed "
                                 f"values misses 1e-12: {refined[mode]}")
        for k in ("perturbed step+1", "perturbed ldiv+1"):
            raw.pop(k)
        if bt is None:
            bt = rng.random((F.n_factor, 4))
        for name, M, lower in (("lsolve", F.L, True), ("rsolve", F.U, False)):
            e[name] = _rel_err(getattr(F, name)(bt), spla.spsolve_triangular(
                M.tocsr(), bt, lower=lower))
        bar = 1e-9 if mode == "inv" else 1e-12
        bad = {k: v for k, v in e.items() if not v <= bar}
        if bad:
            raise AssertionError(f"{mode} float64 misses {bar:g}: {bad}")
        f64[mode] = e
        f64_raw[mode] = raw
        del F, step
    # float32: the main path of the two modes, its launches counted
    f32, solvers, kernel_vs_plain = {}, {}, 0.0
    names = ("ldiv_fused", "perm_gather", "wave_apply", "wave_apply_bf16")
    read = _reset_launches(*names)
    for mode in modes:
        A, F, build_s[mode, "float32"] = _mode_solver("float32", mode)
        before = read()
        b = rng.random((A.shape[0], R)).astype(np.float32)
        x = F.ldiv(b)
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in read().items()}
        diag_waves = sum(not w.accumulate
                         for data in (F.ldata, F.udata) for w in data.waves)
        off_waves = sum(w.accumulate
                        for data in (F.ldata, F.udata) for w in data.waves)
        want = {"ldiv_fused": 0, "perm_gather": 2, "wave_apply_bf16": 0,
                "wave_apply": off_waves + (2 * diag_waves
                                           if mode == "inv_refine" else 0)}
        if d != want:
            raise AssertionError(f"{mode} ldiv launched {d}, not {want}")
        f32[mode] = _backward_error(A, x.cpu().numpy(), b)
        if not f32[mode] < 1e-3:
            raise AssertionError(f"{mode} float32 backward error "
                                 f"{f32[mode]:.3e}")
        bt = torch.as_tensor(b, device="cuda")
        kernel_vs_plain = max(kernel_vs_plain, _rel(
            F._direct_solve(bt), F._direct_solve(bt, plain=True)))
        solvers[mode] = F
    launches = read()
    if not kernel_vs_plain <= TOL["float32"]:
        raise AssertionError(f"the modes' kernel path differs from plain "
                             f"by {kernel_vs_plain:.3e}")
    # timing beside "inv", float32 and float64, eager and by graph replay
    _, solvers["inv"], _ = _mode_solver("float32", "inv")
    ms, share = {}, {}
    for dt in ("float32", "float64"):
        sv = solvers if dt == "float32" else {
            m: _mode_solver(dt, m)[1] for m in ("inv",) + modes}
        b = torch.as_tensor(rng.random((A.shape[0], R)),
                            dtype=getattr(torch, dt), device="cuda")
        for turn in (0, 1):
            for m in (("inv",) + modes)[::1 if turn == 0 else -1]:
                fn = lambda F=sv[m]: F._direct_solve(b)
                ms.setdefault((m, dt), []).append(
                    (_median_ms(lambda _: fn()), _graph_ms(fn)))
        run, work = _trsm_steps(sv["trsm"])
        share[dt] = (_median_ms(lambda _: run()), _graph_ms(run))
        WORK["solve_triangular_" + dt] = work
        ms["plain", dt] = _median_ms(
            lambda _: sv["trsm"]._direct_solve(b, plain=True))
        # the set-up the one bank layout costs "trsm": both factors'
        # diagonal-tile inverses
        diags = [d.diag for d in (sv["trsm"].ldata, sv["trsm"].udata)]
        ms["tri_inverse", dt] = _median_ms(
            lambda _: [tri_inverse(D, lower=lw)
                       for D, lw in zip(diags, (True, False))], reps=20)
        if dt == "float64":
            del sv
    torch.cuda.synchronize()
    fmt = lambda m, dt: "/".join(f"{e:.4f}|{g:.4f}" for e, g in ms[m, dt])
    print(f"phase 14 tri modes (headline, R={R}, host factorization): "
          + "; ".join(f"{m} float64 rel err vs refined spsolve ldiv "
                      f"{e['ldiv']:.3e}, after refactor_numeric(1.01*A) "
                      f"{e['refactor_numeric']:.3e}, fused step on 1.02*A "
                      f"{e['step']:.3e} (vs plain spsolve "
                      + "/".join(f"{v:.3e}" for v in f64_raw[m].values())
                      + f"), lsolve {e['lsolve']:.3e}, rsolve "
                      f"{e['rsolve']:.3e} vs spsolve_triangular"
                      for m, e in f64.items())
          + " (bar 1e-12, inv 1e-9); the fused step on seeded perturbed "
          "values (1 + 0.05 N(0, 1), not held to a bar: the static-pivot "
          "elimination's own error) "
          + ", ".join(f"{m} {v:.3e}" for m, v in perturbed.items())
          + "; with one refinement step (bar 1e-12), fused step / ldiv "
          "after refactor_numeric "
          + ", ".join(f"{m} " + "/".join(f"{v:.3e}" for v in r.values())
                      for m, r in refined.items())
          + "; float32 backward error "
          + ", ".join(f"{m} {v:.3e}" for m, v in f32.items())
          + f" (bar 1e-3); kernel path vs plain {kernel_vs_plain:.3e} "
          f"(bound {TOL['float32']:g}); each solve 2 perm_gather and the "
          f"waves, no ldiv_fused; launches {launches}; construction s "
          + ", ".join(f"{m}/{dt} {v:.2f}" for (m, dt), v in build_s.items()))
    for dt in ("float32", "float64"):
        e, g = share[dt]
        bound_us = _bound("solve_triangular_" + dt)[0] * 1e3
        t_e = np.mean([x for x, _ in ms["trsm", dt]])
        t_g = np.mean([x for _, x in ms["trsm", dt]])
        print(f"phase 14 timing on {smi}, {dt}: ldiv R={R} per solve, "
              f"eager|graph replay ms, two turns: inv {fmt('inv', dt)}; "
              f"trsm {fmt('trsm', dt)}; inv_refine {fmt('inv_refine', dt)}; "
              f"trsm plain {ms['plain', dt]:.4f} eager; its solve_triangular "
              f"calls alone {e:.4f}|{g:.4f} ms = {e / t_e:.1%}|{g / t_g:.1%} "
              f"of the trsm solve (bound {bound_us:.1f} us); "
              f"tri_inverse of both factors' diagonal tiles (the set-up of "
              f"the one bank layout under trsm) {ms['tri_inverse', dt]:.4f} "
              f"ms eager")
    del solvers
    return {k: launches[k] for k in ("perm_gather", "wave_apply")}


def _file_mb(path) -> float:
    import os

    return os.path.getsize(path) / 1e6


def _persist_case(tag, A, F, build_s, R, tmp, rng, cpu_reload=False):
    """Full and light save of F, reloaded on the card: the full reload
    solves bit for bit like F, the light one like ``refactor_numeric(A)``
    on F. Returns one line of results."""
    import torch

    from tpu_sparse_lu_torch import ParallelSparseLU

    b = torch.as_tensor(rng.random((A.shape[0], R)), dtype=F.dtype,
                        device="cuda")
    out = {}
    for kind, values in (("full", True), ("light", False)):
        path = f"{tmp}/{tag}_{kind}.npz"
        t0 = time.perf_counter()
        F.save(path, values=values)
        out[kind, "save_s"] = time.perf_counter() - t0
        out[kind, "mb"] = _file_mb(path)
        read = _reset_launches("ldiv_fused", *ASSEMBLY, "elim_fused",
                               "lu_tile", "tile_mm")
        t0 = time.perf_counter()
        G = ParallelSparseLU.from_saved(A, path, device="cuda")
        torch.cuda.synchronize()
        out[kind, "load_s"] = time.perf_counter() - t0
        ran = read()
        if kind == "full":
            ref = F.ldiv(b)
            if any(ran.values()):
                raise AssertionError(f"{tag} full reload launched {ran}")
        else:
            if (any(ran[k] == 0 for k in (*ASSEMBLY, "elim_fused"))
                    or ran["lu_tile"] or ran["tile_mm"]):
                raise AssertionError(f"{tag} light reload did not run the "
                                     f"refactorization kernels (one "
                                     f"elim_fused launch, no per-level "
                                     f"route): {ran}")
            F.refactor_numeric(A)
            ref = F.ldiv(b)
        x = G.ldiv(b)
        if not torch.equal(x, ref):
            raise AssertionError(f"{tag} {kind} reload differs from the "
                                 f"saved solver by "
                                 f"{float((x - ref).abs().max()):.3e}")
        e = _backward_error(A, x.cpu().numpy(), b.cpu().numpy())
        if not e < 1e-3:
            raise AssertionError(f"{tag} {kind} reload backward error "
                                 f"{e:.3e}")
        out[kind, "berr"] = e
        if kind == "full" and cpu_reload:
            # a reload on another device than the save's
            H = ParallelSparseLU.from_saved(A, path, device="cpu")
            r = _rel(H.ldiv(b.cpu()), ref.cpu())
            if not r <= TOL["float32"]:
                raise AssertionError(f"{tag} full reload on the CPU differs "
                                     f"by {r:.3e}")
            out["cpu_rel"] = r
            del H
        del G
    # what a JAX light file adds: the port's refactor plan rebuilt on the
    # saved closure solve plans
    t0 = time.perf_counter()
    F._build_refactor_plan(F.plan.lplan, F.plan.uplan)
    out["jax_light_plan_s"] = time.perf_counter() - t0
    full = {k[1]: v for k, v in out.items() if k[0] == "full"}
    light = {k[1]: v for k, v in out.items() if k[0] == "light"}
    return (f"{tag} (built in {build_s:.2f} s): full save {full['mb']:.1f} "
            f"MB in {full['save_s']:.3f} s, reload {full['load_s']:.3f} s, "
            f"ldiv bit for bit, backward error {full['berr']:.3e}; light "
            f"save {light['mb']:.2f} MB in {light['save_s']:.3f} s (the "
            f"refactor plan planned for the file), reload "
            f"{light['load_s']:.3f} s (refactorization included), ldiv bit "
            f"for bit with refactor_numeric(A), backward error "
            f"{light['berr']:.3e}; a JAX light file's refactor plan rebuilt "
            f"in {out['jax_light_plan_s']:.3f} s"
            + (f"; full reload on the CPU rel diff {out['cpu_rel']:.3e}"
               if cpu_reload else ""))


def phase_persistence():
    """``save``/``from_saved`` at the headline and config 2, into a
    directory of the checkout removed afterwards."""
    import os
    import tempfile

    rng = np.random.default_rng(15)
    here = os.path.dirname(os.path.abspath(__file__))
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=here) as tmp:
        t0 = time.perf_counter()
        A, F = _headline_solver("float32")
        lines.append(_persist_case("headline", A, F,
                                   time.perf_counter() - t0, HEADLINE["R"],
                                   tmp, rng, cpu_reload=True))
        del F
        t0 = time.perf_counter()
        A, F = _config2_solver()
        lines.append(_persist_case("config 2", A, F, time.perf_counter() - t0,
                                   CONFIG2["R"], tmp, rng))
        del F
    print("phase 15 persistence: " + "; ".join(lines))


# ---------------------------------------------------------------------------
# phases 16-17: the native planner core, the mesh engines
# ---------------------------------------------------------------------------

CONFIG5 = dict(nblocks=1600, bs=64, chunk_size=128, R=16)


def _config5_matrix():
    from tpu_sparse_lu_torch.models import block_banded

    return block_banded(np.random.default_rng(0), CONFIG5["nblocks"],
                        CONFIG5["bs"])


def _config5_solver():
    """BASELINE config 5's one-device half (``bench.py:459-475``):
    ``block_banded(default_rng(0), 1600, 64)`` (n = 102,400), colamd,
    chunk_size=128, float32; returns (A, F, construction seconds)."""
    import torch

    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig

    A = _config5_matrix()
    t0 = time.perf_counter()
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=CONFIG5["chunk_size"], dtype="float32"), device="cuda")
    torch.cuda.synchronize()
    return A, F, time.perf_counter() - t0


def _same_arrays(a: dict, b: dict, what: str) -> None:
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: fields differ")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {k} differs between the native "
                                 f"core and the NumPy planner")


def _planner_split(A, F):
    """Construction seconds by layer for a built solver ``F``: SuperLU on
    the factored matrix, the host plan (``build_symbolic_plan``) and the
    refactor plan (closure plans + ``build_refactor_plan``), each with
    the native core and with the NumPy planner forced; the native and
    NumPy plans must be equal array by array."""
    from tpu_sparse_lu_torch.ordering import staged_extension
    from tpu_sparse_lu_torch.symbolic import build_symbolic_plan
    from tpu_sparse_lu_torch.utils import _symcore_build

    cs = F.plan.cs
    A_factor = A if F._ext is None else staged_extension(
        A, cs, cutoff=F._nd_cutoff)[0]
    t0 = time.perf_counter()
    factors = F._factorize(A_factor)
    s = {"superlu": time.perf_counter() - t0}
    plans, rplans = {}, {}
    native = _symcore_build.native
    try:
        for how in ("native", "numpy"):
            if how == "numpy":
                _symcore_build.native = lambda: None
            t0 = time.perf_counter()
            plans[how] = build_symbolic_plan(factors, cs).arrays()
            s["host plan " + how] = time.perf_counter() - t0
            t0 = time.perf_counter()
            lp, up, rp = F._plan_device_refactor()
            s["refactor plan " + how] = time.perf_counter() - t0
            rplans[how] = {**rp.arrays(), **{
                f"{t}_{k}": v for t, p in (("l", lp), ("u", up))
                for k, v in p.__dict__.items()}}
    finally:
        _symcore_build.native = native
    _same_arrays(plans["native"], plans["numpy"], "host plan")
    _same_arrays(rplans["native"], rplans["numpy"], "refactor plan")
    return s


def phase_planner():
    """The native planner core (A12) at the headline and at config 5's
    one-device half: it built, its plans equal the NumPy planner's, and
    the construction seconds split into SuperLU, host plan and refactor
    plan (native / NumPy forced)."""
    from tpu_sparse_lu_torch.utils import _symcore_build

    t0 = time.perf_counter()
    if _symcore_build.native() is None:
        raise AssertionError("the native planner core did not build")
    build_s = time.perf_counter() - t0
    lines = []
    for tag, make in (("headline", lambda: _mode_solver("float32", "inv")),
                      ("config 5", _config5_solver)):
        A, F, total = make()
        s = _planner_split(A, F)
        lines.append(
            f"{tag} (n={A.shape[0]}, K={F.plan.lplan.K}) construction "
            f"{total:.3f} s: SuperLU {s['superlu']:.3f} s, host plan native "
            f"{s['host plan native']:.3f} s / NumPy "
            f"{s['host plan numpy']:.3f} s, refactor plan native "
            f"{s['refactor plan native']:.3f} s / NumPy "
            f"{s['refactor plan numpy']:.3f} s")
        del F
    print(f"phase 16 planner: native core built in {build_s:.2f} s; plans "
          f"equal to the NumPy planner's array by array; " + "; ".join(lines))


_GLOO_TWO_RANKS = r"""
import datetime, faulthandler, sys
faulthandler.enable()
import numpy as np
import torch
import torch.distributed as dist
rank, url, name = int(sys.argv[1]), sys.argv[2], sys.argv[3]
def say(*a):
    print(f"GLOO2 {name} rank {rank}:", *a, flush=True)
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=url, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig
from tpu_sparse_lu_torch.models import block_banded, poisson_2d
from tpu_sparse_lu_torch.parallel.dp import make_dp_ldiv
from tpu_sparse_lu_torch.parallel.mesh import make_mesh
from tpu_sparse_lu_torch.parallel.pipeline_solve import make_pipeline_ldiv
from tpu_sparse_lu_torch.parallel.sharded_solve import make_sharded_ldiv
say("group up")
t = torch.ones(4, device="cuda")
try:
    dist.all_reduce(t)
    say(f"all_reduce of a CUDA tensor gave {t.tolist()}")
except Exception as e:
    say(f"all_reduce of a CUDA tensor refused: {type(e).__name__}: "
        f"{str(e)[:200]}")
mesh = make_mesh(device_type="cuda")
A, make = {"sharded": (poisson_2d(100, 100), make_sharded_ldiv),
           "dp": (poisson_2d(100, 100), make_dp_ldiv),
           "pipeline": (block_banded(np.random.default_rng(0), 120, 30),
                        make_pipeline_ldiv)}[name]
F = ParallelSparseLU(A, config=SolverConfig(chunk_size=128,
                                            dtype="float32"), device="cuda")
b = torch.as_tensor(np.random.default_rng(1).random((A.shape[0], 16)),
                    dtype=torch.float32, device="cuda")
solve = make(F, mesh)
if solve is None:
    say("no plan at D=2")
else:
    say("solving")
    try:
        x = solve(b)
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        ref = F.ldiv(b)
        err = float((x - ref).abs().max() / ref.abs().max())
        say(f"ran, max rel diff to F.ldiv {err:.1e}, collectives "
            f"{solve.collectives.counts}")
    except Exception as e:
        say(f"refused: {type(e).__name__}: {str(e)[:300]}")
dist.destroy_process_group()
"""


def _gloo_two_ranks(tmp) -> str:
    """Two ranks on the one card over gloo with CUDA tensors (NCCL refuses
    two ranks on one GPU), one pair of processes per engine: what each
    rank reported, or how it ended. Printed, not gated."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    report = []
    for name in ("sharded", "dp", "pipeline"):
        url = "file://" + os.path.join(tmp, "gloo2_" + name)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _GLOO_TWO_RANKS, str(r), url, name],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=here) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=150)[0])
        except subprocess.TimeoutExpired:
            outs.append("deadline of 150 s passed")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        said = [ln[6:] for o in outs for ln in o.splitlines()
                if ln.startswith("GLOO2 ")]
        codes = [p.returncode for p in procs]
        if codes != [0, 0]:
            # a crash: the first lines of its fault report
            said.append(f"exit codes {codes}: " + " / ".join(
                ln.strip() for o in outs for ln in o.splitlines()
                if not ln.startswith("GLOO2 ") and ln.strip())[:600])
        report.append(name + ": " + " | ".join(said))
    return "; ".join(report)


def _engine_case(tag, F, b, engines, reps, smi):
    """Each engine held to ``F.ldiv`` within ``TOL``, its eager median
    time beside ``F.ldiv``'s, its collectives per solve."""
    import torch

    ref = F.ldiv(b)
    parts = []
    ms_ldiv = _median_ms(lambda _: F.ldiv(b), reps=reps, warmup=1)
    for name, solve in engines.items():
        if solve is None:
            parts.append(f"{name}: no plan")
            continue
        x = solve(b)
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        err = _rel(x, ref)
        if not err <= TOL["float32"]:
            raise AssertionError(f"phase 17 {tag} {name} differs from "
                                 f"F.ldiv by {err:.3e}")
        counts = dict(solve.collectives.counts)
        ms = _median_ms(lambda _: solve(b), reps=reps, warmup=1)
        extra = ""
        if hasattr(solve, "lsplan"):
            R, cs = b.shape[1], F.plan.cs
            nbytes = sum(p.psum_bytes_per_solve(cs, R, b.element_size())
                         for p in (solve.lsplan, solve.usplan))
            extra = f", psum_bytes_per_solve {nbytes}"
        parts.append(f"{name} {ms:.4f} ms (max rel diff {err:.1e}; "
                     f"all_reduce {counts['all_reduce']}, send_recv "
                     f"{counts['send_recv']} per solve{extra})")
    torch.cuda.synchronize()
    return (f"{tag}: F.ldiv {ms_ldiv:.4f} ms; " + "; ".join(parts)
            + f" [{smi}]")


def _engine_profile(solve, b, n=3):
    """``n`` solves under ``torch.profiler``: wall ms per solve, the
    device kernels' ms per solve (their busy share of the wall) and the
    ops of most host self time (ms and calls per solve)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solve(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            solve(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    ka = prof.key_averages()
    dev = sum(getattr(e, "self_device_time_total", 0) or 0
              for e in ka) / n / 1e3
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    return (f"{wall:.3f} ms a solve under the profiler, device kernels "
            f"{dev:.3f} ms ({dev / wall:.1%} busy); host self time "
            + ", ".join(f"{e.key} {e.self_cpu_time_total / n / 1e3:.3f} ms "
                        f"({e.count / n:.0f} calls)" for e in top))


def phase_mesh_engines(smi):
    """The three mesh engines (A13) over an NCCL group of world size 1 on
    the card: at the headline (nd, R = 16, float32) the psum engine, DP
    and the pipeline, at config 5's one-device half the pipeline and the
    psum engine, each held to ``F.ldiv`` within ``TOL`` and timed eagerly
    beside it; then two ranks on the card over gloo (reported). Returns
    the launches of the engines' run (perm_gather, ldiv_fused)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_sparse_lu_torch.parallel.dp import make_dp_ldiv
    from tpu_sparse_lu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )
    from tpu_sparse_lu_torch.parallel.pipeline_solve import make_pipeline_ldiv
    from tpu_sparse_lu_torch.parallel.sharded_solve import make_sharded_ldiv

    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=here) as tmp:
        dev = initialize_multihost("file://" + os.path.join(tmp, "nccl"), 1,
                                   0, device="cuda")
        try:
            if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                raise AssertionError("not an NCCL group of world size 1")
            mesh = make_mesh()
            A, F = _headline_solver("float32")
            b = torch.as_tensor(rng.random((A.shape[0], HEADLINE["R"])),
                                dtype=torch.float32, device=dev)
            engines = {"psum engine": make_sharded_ldiv(F, mesh),
                       "dp": make_dp_ldiv(F, mesh),
                       "pipeline": make_pipeline_ldiv(F, mesh)}
            # the mesh path's launches: counts from 0, one solve each
            read = _reset_launches("perm_gather", "ldiv_fused")
            for solve in engines.values():
                if solve is not None:
                    x = solve(b)
            torch.cuda.synchronize()
            launches = read()
            if not all(launches.values()):
                raise AssertionError(f"the mesh engines did not run the "
                                     f"kernels: {launches}")
            del x
            lines = [_engine_case("headline nd R=16", F, b, engines, 20, smi)]
            prof = {k: _engine_profile(engines[k], b)
                    for k in ("psum engine", "pipeline")}
            del F, engines
            A5, F5, _ = _config5_solver()
            b5 = torch.as_tensor(rng.random((A5.shape[0], CONFIG5["R"])),
                                 dtype=torch.float32, device=dev)
            lines.append(_engine_case(
                f"config 5 (n={A5.shape[0]}, K={F5.plan.lplan.K}) R=16", F5,
                b5, {"pipeline": make_pipeline_ldiv(F5, mesh),
                     "psum engine": make_sharded_ldiv(F5, mesh)}, 3, smi))
            del F5
        finally:
            dist.destroy_process_group()
        two = _gloo_two_ranks(tmp)
    print(f"phase 17 mesh engines over NCCL, world size D = 1 (one card): "
          + " | ".join(lines) + f"; launches of the engines' run {launches}")
    for k, v in prof.items():
        print(f"phase 17 profile of the headline {k} on {smi}: {v}")
    print(f"phase 17 two ranks on the one card over gloo with CUDA tensors: "
          f"{two}")
    return launches


def _some_phases(phases, smi) -> int:
    """Only the phases named, of 2-17 (4 runs 3 first, 9 runs 8, 13 runs
    12); prints no result line."""
    if not phases or not phases <= set(range(2, 18)):
        raise SystemExit(f"--phases takes a subset of 2-17, got "
                         f"{sorted(phases)}")
    if 2 in phases:
        phase_kernels_vs_plain()
    if phases & {3, 4}:
        A, F, _ = phase_main_path()
        if 4 in phases:
            phase_lifecycle(A, F)
        del A, F
    if 5 in phases:
        phase_timing(_headline_solver("float32")[1], smi)
    if 6 in phases:
        phase_refactor_kernels_vs_plain()
    if 7 in phases:
        phase_device_lifecycle()
    if phases & {8, 9}:
        A2c, F2c, step = phase_config2_step()
        if 9 in phases:
            phase_refactor_timing(A2c, F2c, step, smi)
        del A2c, F2c, step
    if 10 in phases:
        phase_chain_and_bf16_kernels_vs_plain()
    if 11 in phases:
        phase_config1()
    if phases & {12, 13}:
        _, f32_steps, bf_steps = phase_f64_tier()
        if 13 in phases:
            phase_chain_bf16_timing(smi, f32_steps, bf_steps)
    if 14 in phases:
        phase_tri_modes(smi)
    if 15 in phases:
        phase_persistence()
    if 16 in phases:
        phase_planner()
    if 17 in phases:
        phase_mesh_engines(smi)
    print(f"chip_smoke: phases {sorted(phases | {1})} passed (a partial run: "
          f"no result line)")
    return 0


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=None,
                        help="run only these of phases 2-17 after phase 1, "
                             "comma-separated (no result line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import tpu_sparse_lu_torch  # noqa: F401  (fails outside the repo)

    name, smi = phase_device()
    if args.phases is not None:
        return _some_phases({int(p) for p in args.phases.split(",")}, smi)
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
    del A2c, F2c, step
    err.update(phase_chain_and_bf16_kernels_vs_plain())
    launches.update(phase_config1())
    bf_launches, f32_steps, bf_steps = phase_f64_tier()
    launches.update(bf_launches)
    ms.update(phase_chain_bf16_timing(smi, f32_steps, bf_steps))
    # perm_gather and wave_apply are on the main path of tri_mode="trsm"
    # and "inv_refine": their launches are those solves'
    launches.update(phase_tri_modes(smi))
    phase_persistence()
    phase_planner()
    # the mesh engines run perm_gather (psum engine, pipeline) and
    # ldiv_fused (DP): their launches are that path's
    for k, v in phase_mesh_engines(smi).items():
        launches[k] = launches.get(k, 0) + v
    # these kernels are timed by CUDA-graph replay (device time); the others
    # by eager CUDA events (host included)
    graph = {"span_gather": "span_gather_device", "lu_tile": "lu_tile_device",
             "tile_mm": "tile_mm_headline_device",
             "elim_fused": "elimination_headline_graph",
             "bidiag_ldiv": "bidiag_ldiv_device",
             **{k: k + "_device" for k in ASSEMBLY},
             "ldiv_fused": "ldiv_fused_device",
             "ldiv_fused_bf16": "ldiv_fused_bf16_device"}
    library = {"span_gather": "span_gather_library",
               "lu_tile": "lu_tile_library",
               "tile_mm": "tile_mm_headline_library",
               "elim_fused": "elimination_headline_levels_bmm_graph"}
    kernels = []
    for k, (src, tpu) in KERNELS.items():
        bound_ms, bound_by = _bound(k)
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[k], "max_abs_err": err[k],
            "ms": ms[graph.get(k, k)], "plain_ms": ms[k + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ms[library[k]] if k in library else None,
            "timing": "graph replay" if k in graph else "eager",
            "eager_ms": ms[k], "library": LIBRARY[k],
            **({"chain_bound_ms": CHAIN_MS[k]} if k in CHAIN_MS else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
