"""The one-launch ldiv's task list and its plain executor.

``build_ldiv_schedule`` turns the waves of both factors into one list of
tasks (perm-in blocks, one task per destination block of every wave,
perm-out blocks) with the earlier tasks each one waits for; the CUDA kernel
``ldiv_fused`` runs that list by ticket, and ``fused_ldiv_plain`` runs it
task by task on CPU tensors. Here the dependencies are held against every
read/write conflict of the wave sequence, the plain executor against itself
in random valid orders (bit for bit), against the plain wave route, and
against the JAX package's ``pallas_fused_ldiv`` in interpret mode on the
very same factorization, in float32 and with bfloat16 tiles.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from _approx import assert_isapprox
from _deep_plan import DEEP, READ_AHEAD, RUN_BATCH, batch_waits, padded_waits

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.models import fe_block_matrix, laplacian_1d, poisson_2d
from tpu_sparse_lu.ops.pallas_ldiv import (
    SRC_LDINV,
    SRC_LOFF,
    SRC_PERMP,
    SRC_PERMQ,
    SRC_UDINV,
    SRC_UOFF,
    build_ldiv_ops,
    build_lu_stream,
    build_perm_stream,
    pallas_fused_ldiv,
    stream_gather_spec,
)
from tpu_sparse_lu.solve import block_rhs as jax_block_rhs
from tpu_sparse_lu.solve import unblock_rhs as jax_unblock_rhs
from tpu_sparse_lu_torch.models import block_banded
from tpu_sparse_lu_torch.ops import fused_ldiv as FL

# the cases of tests/test_torch_ldiv.py, and the headline's pattern (2D
# Poisson, nd) at a small size
CASES = {
    "poisson": (lambda rng: poisson_2d(10, 8), dict(chunk_size=8)),
    "laplace1d": (lambda rng: laplacian_1d(50), dict(chunk_size=8)),
    "fe": (lambda rng: fe_block_matrix(rng, 10, 5), dict(chunk_size=8)),
    "poisson_nd": (lambda rng: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd")),
    "headline_nd": (lambda rng: poisson_2d(24, 24),
                    dict(chunk_size=16, ordering="nd")),
}
JAX_CASES = ("poisson", "laplace1d", "fe", "poisson_nd")


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _solver(case, rng, **extra):
    make, cfg = CASES[case]
    A = make(rng)
    return A, tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg, **extra),
                                   device="cpu")


def _deps(S, t):
    return S.dep[S.dep_ptr[t]:S.dep_ptr[t + 1]].tolist()


def _ancestors(S):
    """Every task's ancestors in the dependency graph, as bit sets."""
    anc = []
    for t in range(S.n_tasks):
        a = 0
        for d in _deps(S, t):
            a |= anc[d] | (1 << d)
        anc.append(a)
    return anc


def _wave_route(F):
    """Today's 32-launch route, one entry per task: (flags, dst, entries,
    carrier blocks read, written), from the solver's waves and perms."""
    K, cs = F.plan.lplan.K, F.plan.cs
    ops = [(FL.PERM_IN, k, [], set(), {k}) for k in range(K + 1)]
    N = F._numeric
    for bank, data in ((0, N.ldata), (FL.BANK_U, N.udata)):
        for w in data.waves:
            ptr = w.ptr.tolist()
            flags = FL.WAVE | bank | (FL.ACCUMULATE if w.accumulate else 0)
            for i, d in enumerate(w.dst.tolist()):
                ent = list(zip(w.ent_tile[ptr[i]:ptr[i + 1]].tolist(),
                               w.ent_src[ptr[i]:ptr[i + 1]].tolist()))
                reads = {s for _, s in ent} | ({d} if w.accumulate else set())
                ops.append((flags, d, ent, reads, {d}))
    q = N.qidx.numpy()
    for m in range(-(-F.n // cs)):
        ops.append((FL.PERM_OUT, m, [], set((q[m * cs:(m + 1) * cs] // cs)
                                            .tolist()), set()))
    return ops


@pytest.mark.parametrize("case", sorted(CASES))
def test_dependencies_order_every_conflict(rng, case):
    """The task list is today's wave sequence, task by task, and every
    read-after-write, write-after-write and write-after-read pair of it
    on a carrier block is ordered by a path of dependencies, each to an
    earlier ticket and each itself such a conflict."""
    _, F = _solver(case, rng)
    S = F._numeric.sched
    ops = _wave_route(F)
    assert S.n_tasks == len(ops)
    for t, (flags, d, ent, _, _) in enumerate(ops):
        f, dst, e0, e1 = S.task[t].tolist()
        assert (f, dst) == (flags, d)
        assert list(zip(S.ent_tile[e0:e1].tolist(),
                        S.ent_src[e0:e1].tolist())) == ent
    anc = _ancestors(S)
    conflicts = 0
    for j, (_, _, _, rj, wj) in enumerate(ops):
        deps = _deps(S, j)
        assert all(d < j for d in deps)
        for d in deps:  # no task waits for one it does not conflict with
            _, _, _, rd, wd = ops[d]
            assert (wd & rj) or (wd & wj) or (rd & wj), (case, d, j)
        for i in range(j):
            _, _, _, ri, wi = ops[i]
            if (wi & rj) or (wi & wj) or (ri & wj):
                conflicts += 1
                assert (anc[j] >> i) & 1, (case, i, j)
    assert conflicts > S.n_tasks


def _random_order(S, rng):
    """A seeded random topological order of the task graph."""
    children = [[] for _ in range(S.n_tasks)]
    indeg = np.zeros(S.n_tasks, dtype=int)
    for t in range(S.n_tasks):
        for d in _deps(S, t):
            children[d].append(t)
            indeg[t] += 1
    ready = [t for t in range(S.n_tasks) if indeg[t] == 0]
    order = []
    while ready:
        i = int(rng.integers(len(ready)))
        ready[i], ready[-1] = ready[-1], ready[i]
        t = ready.pop()
        order.append(t)
        for c in children[t]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    assert len(order) == S.n_tasks
    return order


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("R", [1, 4, 17])
@pytest.mark.parametrize("case", sorted(CASES))
def test_any_valid_order_gives_the_same_bits(rng, case, R, dtype):
    """The plain executor in three random valid orders equals ticket order
    bit for bit, and the plain wave route up to the rounding of the
    batched product."""
    A, F = _solver(case, rng, dtype=dtype)
    N = F._numeric
    S = N.sched
    b = torch.as_tensor(rng.standard_normal((A.shape[0], R)), dtype=F.dtype)
    args = (b, S, N.ldata.tiles_t, N.udata.tiles_t, N.rs)
    want = FL.fused_ldiv_plain(*args)
    moved = 0
    for seed in range(3):
        order = _random_order(S, np.random.default_rng(seed))
        moved += order != list(range(S.n_tasks))
        assert torch.equal(FL.fused_ldiv_plain(*args, order=order), want)
    assert moved
    rtol = 1e-6 if dtype == "float32" else 1e-14
    ref = N.tiles(b, plain=True)
    torch.testing.assert_close(want, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max()))
    assert torch.equal(N.tiles(b), want)


def _jax_ldiv(F, b):
    """The JAX fused Pallas ldiv in interpret mode, with the solver's own
    tile stream (float32 or bfloat16), as tests/test_pallas.py runs it."""
    ops = build_ldiv_ops(F._pvec, F.plan.lplan, F.plan.uplan, F._qvec,
                         KA=F._K_in)
    sizes = {
        SRC_PERMP: ops.res_p.shape[0],
        SRC_LDINV: F.plan.lplan.K + 1,
        SRC_LOFF: F.plan.lplan.T + 1,
        SRC_UDINV: F.plan.uplan.K + 1,
        SRC_UOFF: F.plan.uplan.T + 1,
        SRC_PERMQ: ops.res_q.shape[0],
    }
    s_perm = build_perm_stream(
        jnp.asarray(stream_gather_spec(ops, sizes, 0)),
        jnp.asarray(ops.res_p), jnp.asarray(ops.res_q))
    s_lu = build_lu_stream(
        jnp.asarray(stream_gather_spec(ops, sizes, 1)),
        F.ldata.diag_inv, F.ldata.offdiag,
        F.udata.diag_inv, F.udata.offdiag, dtype=F._stream_dt)
    xw = jax_block_rhs(b, F.n, F._K_in, F.plan.cs) * F._rs_blk
    out = pallas_fused_ldiv(ops, s_perm, s_lu, xw, interpret=True)
    return np.asarray(jax_unblock_rhs(out, F.n))


def _jax_bank(jdata, dtype):
    """The JAX solver's tile inverses and negated off-diagonal tiles as a
    port tile bank (transposed)."""
    bank = np.concatenate([np.asarray(jdata.diag_inv),
                           np.asarray(jdata.offdiag)])
    return torch.as_tensor(bank.transpose(0, 2, 1).copy()).to(dtype)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_matches_jax_fused_ldiv(rng, tmp_path, case, R, stream):
    """``fused_ldiv_plain`` on the JAX solver's own tiles against the JAX
    TPU kernel in interpret mode: only the order of the sums differs (the
    bar of tests/test_pallas.py:82, normwise as the reference suite
    compares; elementwise too, except on the FE system, whose smallest
    solution components carry f32 noise above 1e-6 absolute)."""
    make, cfg = CASES[case]
    A = make(rng)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
        tri_mode="inv", dtype="float32", stream_dtype=stream, **cfg))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        tf = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    b = rng.random((A.shape[0], R)).astype(np.float32)
    ref = _jax_ldiv(jf, jnp.asarray(b))
    tdt = getattr(torch, stream)
    got = FL.fused_ldiv_plain(torch.as_tensor(b), tf._numeric.sched,
                              _jax_bank(jf.ldata, tdt),
                              _jax_bank(jf.udata, tdt),
                              tf._numeric.rs).numpy()
    assert_isapprox(got, ref, rtol=1e-5, atol=1e-6)
    if case != "fe":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_schedule_lifetime(rng):
    """A device refactorization keeps the schedule (the same object: only
    the banks change); a host ``refactor`` that re-plans rebuilds it."""
    A = poisson_2d(12, 12)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", dtype="float64"), device="cpu")
    b = rng.random(A.shape[0])
    F.refactor_numeric(A)  # the first one re-plans on the closure
    S = F._numeric.sched
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.1 * rng.random(A2.nnz))
    F.refactor_numeric(A2)
    assert F._numeric.sched is S
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A2, b),
                               rtol=1e-9, atol=1e-12)
    x = F.make_refactor_solve_step()(A2.data, b)
    assert F._numeric.sched is S
    np.testing.assert_allclose(x.numpy(), spla.spsolve(A2, b), rtol=1e-9,
                               atol=1e-12)
    # a new pattern: the host refactorization re-plans, the list follows
    A3 = (A2 + sp.diags([0.01] * (A.shape[0] - 3), 3)
          + sp.diags([0.01] * (A.shape[0] - 3), -3)).tocsc()
    F.refactor(A3)
    S3 = F._numeric.sched
    assert S3 is not S
    K, cs = F.plan.lplan.K, F.plan.cs
    n_wave = sum(int(w.dst.shape[0])
                 for d in (F._numeric.ldata, F._numeric.udata)
                 for w in d.waves)
    assert S3.n_tasks == K + 1 + n_wave + -(-F.n // cs)
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A3, b),
                               rtol=1e-9, atol=1e-12)


def test_refined_ldiv_matches_the_wave_route(rng):
    """``ldiv`` with and without refinement against the same sweeps
    composed from the plain wave route."""
    A, F = _solver("poisson_nd", rng)
    b = torch.as_tensor(rng.random((A.shape[0], 3)), dtype=F.dtype)
    want = F._numeric.tiles(b, plain=True)
    for steps in (0, 1):
        if steps:
            want = want + F._numeric.tiles(b - F.matvec(want), plain=True)
        torch.testing.assert_close(F.ldiv(b, refine_steps=steps), want,
                                   rtol=1e-6, atol=1e-6)


def test_state_per_stream():
    """The kernel's counters and flags: one set per (tickets, device,
    stream), made fresh (generation 1, nothing done) and then kept."""
    F = tlu.ParallelSparseLU(poisson_2d(6, 6), config=tlu.SolverConfig(
        chunk_size=8), device="cpu")
    S = F._numeric.sched
    a, b = S.state(4, "cpu", 11), S.state(4, "cpu", 12)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert a is S.state(4, "cpu", 11) and b is S.state(4, "cpu", 12)
    assert S.state(4, "cpu") is S.state(4, "cpu", 0)
    for s in (a, b, S.state(6, "cpu", 11)):
        assert s.dtype == torch.int32
        assert s.tolist() == [0, 0, 1] + [0] * (s.numel() - 3)


def test_clock_patch_fits_the_shipped_kernel():
    """``tools/ldiv_sweep.py --clocks`` patches its stamps into a copy of
    ``csrc/ldiv_fused.cu`` at fixed anchors: each must occur exactly once
    in the shipped source, which itself carries no stamp."""
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "ldiv_sweep", root / "tools" / "ldiv_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = (root / "tpu_sparse_lu_torch" / "csrc" / "ldiv_fused.cu").read_text()
    assert "CLOCK" not in src and "globaltimer" not in src
    patched = sweep._with_clocks(src)
    assert patched.count("CLOCK(") == 18
    assert "int ldiv_fused_clocks(void* host, int n)" in patched
    with pytest.raises(SystemExit, match="not once"):
        sweep._with_clocks(src.replace("    // 3. the task\n", ""))


def test_wrappers_on_cpu_launch_nothing(rng):
    A, F = _solver("poisson_nd", rng, dtype="float32")
    N = F._numeric
    S, rs = N.sched, N.rs
    b = torch.as_tensor(rng.random((A.shape[0], 2)), dtype=torch.float32)
    before = (FL.fused_ldiv.LAUNCHES, FL.fused_ldiv_bf16.LAUNCHES)
    L, U = N.ldata.tiles_t, N.udata.tiles_t
    Lb, Ub = L.bfloat16(), U.bfloat16()
    assert torch.equal(FL.fused_ldiv(b, S, L, U, rs),
                       FL.fused_ldiv_plain(b, S, L, U, rs))
    assert torch.equal(FL.fused_ldiv_bf16(b, S, Lb, Ub, rs),
                       FL.fused_ldiv_plain(b, S, Lb, Ub, rs))
    assert (FL.fused_ldiv.LAUNCHES, FL.fused_ldiv_bf16.LAUNCHES) == before
    with pytest.raises(ValueError, match="bfloat16 banks"):
        FL.fused_ldiv_bf16(b, S, L, U, rs)
    with pytest.raises(ValueError, match="device type 'meta'"):
        FL.fused_ldiv(b.to("meta"), S, L.to("meta"), U.to("meta"),
                      rs.to("meta"))


def test_schedule_rejects_bad_maps():
    F = tlu.ParallelSparseLU(poisson_2d(6, 6), config=tlu.SolverConfig(
        chunk_size=8), device="cpu")
    lp, up, cs = F.plan.lplan, F.plan.uplan, F.plan.cs
    p, q = F._numeric.pidx.numpy(), F._numeric.qidx.numpy()
    with pytest.raises(ValueError, match="pidx"):
        FL.build_ldiv_schedule(lp, up, p[:-1], q, F.n, cs, "cpu")
    with pytest.raises(ValueError, match="qidx outside"):
        FL.build_ldiv_schedule(lp, up, p, q + (lp.K + 1) * cs, F.n, cs, "cpu")
    S = FL.build_ldiv_schedule(lp, up, p, q, F.n, cs, "cpu")
    assert S.state(5, "cpu").tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    assert S.state(5, "cpu") is S.state(5, "cpu")


def _longest_path(n_tasks, deps):
    """Tasks on the longest dependency path, by relaxing every edge until
    nothing changes (Bellman-Ford on the negated lengths), in no
    particular order."""
    depth = [1] * n_tasks
    edges = [(d, t) for t in range(n_tasks) for d in deps[t]]
    changed = True
    while changed:
        changed = False
        for d, t in edges[::-1]:
            if depth[d] + 1 > depth[t]:
                depth[t] = depth[d] + 1
                changed = True
    return max(depth, default=0)


@pytest.mark.parametrize("name, make, cfg, want", [
    ("banded_120x30", lambda: block_banded(np.random.default_rng(0), 120, 30),
     dict(chunk_size=128, ordering="colamd"), 116),
    ("poisson2d_100", lambda: poisson_2d(100, 100),
     dict(chunk_size=128, ordering="nd", nd_cutoff=512), 32),
])
def test_critical_path_of_the_deployments(name, make, cfg, want):
    """The stored critical path of the benchmark's deep, narrow plan (two
    dependent tasks a level: the diagonal wave, then the off-diagonal
    wave into the next chunk) and of its wide Poisson plan."""
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype="float32", **cfg), device="cpu")
    S = F._numeric.sched
    assert S.critical_path == want
    assert S.critical_path == _longest_path(
        S.n_tasks, [_deps(S, t) for t in range(S.n_tasks)])


@pytest.mark.parametrize("seed", range(6))
def test_critical_path_is_the_longest_path(seed):
    """On random task graphs (each task waits for a random set of earlier
    ones) the one pass in ticket order equals a brute-force longest
    path."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    p = float(rng.choice([0.01, 0.05, 0.3]))
    deps = [sorted(np.flatnonzero(rng.random(t) < p).tolist())
            for t in range(n)]
    dep_ptr = np.concatenate([[0], np.cumsum([len(d) for d in deps])])
    dep = np.asarray([x for d in deps for x in d], dtype=np.int64)
    assert FL.critical_path(dep_ptr, dep) == _longest_path(n, deps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_critical_path_of_the_cases(rng, case):
    _, F = _solver(case, rng)
    S = F._numeric.sched
    assert 1 < S.critical_path < S.n_tasks
    assert S.critical_path == _longest_path(
        S.n_tasks, [_deps(S, t) for t in range(S.n_tasks)])


def test_strip_rule_adapts_to_the_schedule():
    """A chain of dependent tasks goes narrow; a schedule bound by its
    tickets over the resident blocks (many tasks, a short path, R = 64)
    or by staging its tiles once a strip (the 2D Poisson plan: 629 tasks,
    502 tiles of 64 KB, a path of 32) keeps wider strips; R = 1 stays 1;
    the resident grid can differ by width."""
    widest, tile = max(FL.TASK_US), 128 * 128 * 4
    G = lambda rb: 132  # one block an SM of an H100 at every width
    # banded_1600x64 and banded_120x30: 3,200 and 116 dependent tasks
    for cp, n_tasks, tiles, R in ((3200, 4799, 3198, 16), (116, 173, 114, 8),
                                  (116, 173, 114, 16)):
        assert FL.strip_width(R, cp, n_tasks, tiles * tile, G) == 1
    for R in (8, 16):
        assert FL.strip_width(R, 32, 629, 502 * tile, G) == 4
    assert FL.strip_width(64, 32, 629, 502 * tile, G) == widest
    assert FL.strip_width(64, 40, 200_000, 0, G) == widest
    # more resident blocks at a width make it cheaper there
    assert FL.strip_width(64, 40, 200_000, 0,
                          lambda rb: 132 * (8 if rb == 8 else 1)) == 8
    for cp, n_tasks in ((3200, 4799), (40, 200_000), (1, 1)):
        assert FL.strip_width(1, cp, n_tasks, n_tasks * tile, G) == 1
    # one block: every ticket in turn, so the fewest tickets win
    assert FL.strip_width(16, 3200, 4799, 3198 * tile,
                          lambda rb: 1) == widest
    # the widest of equal costs
    assert FL.strip_width(16, 10, 10, 0, lambda rb: 10**9) == min(
        FL.TASK_US, key=lambda rb: (FL.TASK_US[rb], -rb))


def test_narrow_launches_stay_zero_on_cpu(rng):
    """The plain executor runs on CPU tensors at any ``strip``: no launch,
    narrow or not, with runs (the chain of this plan) or not, and the
    same bits."""
    A, F = _solver("laplace1d", rng)
    N = F._numeric
    S, rs = N.sched, N.rs
    assert S.runs
    b = torch.as_tensor(rng.random((A.shape[0], 8)), dtype=F.dtype)
    before = (FL.fused_ldiv.NARROW_LAUNCHES,
              FL.fused_ldiv_bf16.NARROW_LAUNCHES, FL.fused_ldiv.LAUNCHES,
              FL.fused_ldiv.RUN_LAUNCHES, FL.fused_ldiv_bf16.RUN_LAUNCHES)
    L, U = N.ldata.tiles_t, N.udata.tiles_t
    want = FL.fused_ldiv_plain(b, S, L, U, rs)
    for strip in (None, *FL.TASK_US):
        assert torch.equal(FL.fused_ldiv(b, S, L, U, rs, strip=strip),
                           want)
        FL.fused_ldiv_bf16(b.float(), S, L.bfloat16(), U.bfloat16(),
                           rs.float(), strip=strip)
    assert F.ldiv(b).shape == b.shape
    assert (FL.fused_ldiv.NARROW_LAUNCHES,
            FL.fused_ldiv_bf16.NARROW_LAUNCHES,
            FL.fused_ldiv.LAUNCHES, FL.fused_ldiv.RUN_LAUNCHES,
            FL.fused_ldiv_bf16.RUN_LAUNCHES) == before


# the run cases: the cases above, the benchmark's deep plan, the card
# test's Poisson plan and a small block-banded plan
RUN_CASES = dict(CASES, **{
    "banded_120x30": (lambda rng: block_banded(np.random.default_rng(0), 120,
                                                30),
                      dict(chunk_size=128, ordering="colamd")),
    "poisson_40": (lambda rng: poisson_2d(40, 40),
                   dict(chunk_size=32, ordering="nd")),
    "banded_small": (lambda rng: block_banded(rng, 12, 10),
                     dict(chunk_size=16, ordering="colamd")),
})


def _run_solver(case, rng, **extra):
    make, cfg = RUN_CASES[case]
    A = make(rng)
    return A, tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg, **extra),
                                   device="cpu")


def _one_tile(S, t):
    f, _, e0, e1 = S.task[t].tolist()
    return (f & FL.KIND_MASK) == FL.WAVE and e1 - e0 == 1


def _joins(S, t0, t):
    """Whether task ``t`` may follow ``t - 1`` in a run that starts at
    ``t0``: both one-tile wave tasks, ``t`` reading the block ``t - 1``
    wrote, accumulating (if at all) into another, and depending on ``t -
    1`` and on nothing else at or after ``t0``."""
    if not (_one_tile(S, t - 1) and _one_tile(S, t)):
        return False
    f, d, e0, _ = S.task[t].tolist()
    prev = int(S.task[t - 1, 1])
    deps = _deps(S, t)
    return (int(S.ent_src[e0]) == prev
            and not (f & FL.ACCUMULATE and d == prev)
            and t - 1 in deps and all(x < t0 or x == t - 1 for x in deps))


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_runs_are_maximal_chains(rng, case):
    """Every run is at least two one-tile wave tasks, each after the first
    depending on the one before it and otherwise only on tasks before the
    run; no run can take the task after it, nor a task outside any run
    before it; the units partition the tasks, and each task's unit polls
    its dependencies less the task before it in its run."""
    _, F = _run_solver(case, rng)
    S = F._numeric.sched
    in_run = np.zeros(S.n_tasks, dtype=bool)
    for t0, t1 in S.runs:
        assert t1 > t0
        assert all(_joins(S, t0, t) for t in range(t0 + 1, t1 + 1))
        assert t1 + 1 == S.n_tasks or not _joins(S, t0, t1 + 1)
        if t0 > 0 and not in_run[t0 - 1]:
            assert not _joins(S, t0 - 1, t0)
        in_run[t0:t1 + 1] = True
    assert S.run_tasks == int(in_run.sum())
    starts = [t0 for t0, _ in S.runs]
    units = [(int(a), int(b)) for a, b in zip(S.unit_ptr[:-1],
                                              S.unit_ptr[1:])]
    assert S.n_units == len(units) == S.n_tasks - S.run_tasks + len(S.runs)
    assert [a for a, b in units if b - a > 1] == starts
    assert units[0][0] == 0 and units[-1][1] == S.n_tasks
    for t in range(S.n_tasks):
        want = _deps(S, t)
        if t > 0 and in_run[t] and t not in starts:
            want.remove(t - 1)
        assert S.wait[S.wait_ptr[t]:S.wait_ptr[t + 1]].tolist() == want
        f, d, e0, e1 = S.task[t].tolist()
        one = (f & FL.KIND_MASK) == FL.WAVE and e1 - e0 == 1
        assert S.meta[t].tolist() == [f, d] + (
            [int(S.ent_tile[e0]), int(S.ent_src[e0])] if one else [-1, -1])
    if not S.runs:  # no run: the tickets are the tasks, as before runs
        assert S.unit_ptr.tolist() == list(range(S.n_tasks + 1))


def _random_unit_order(S, rng):
    """A seeded random topological order of the units (a run's tasks
    together and in order), as the task ids to run."""
    units = list(zip(S.unit_ptr[:-1].tolist(), S.unit_ptr[1:].tolist()))
    of = np.repeat(np.arange(len(units)), np.diff(S.unit_ptr))
    children = [set() for _ in units]
    indeg = np.zeros(len(units), dtype=int)
    for u, (a, b) in enumerate(units):
        for d in set(of[S.wait[S.wait_ptr[a]:S.wait_ptr[b]]].tolist()):
            assert d < u
            children[d].add(u)
            indeg[u] += 1
    ready = [u for u in range(len(units)) if indeg[u] == 0]
    order = []
    while ready:
        i = int(rng.integers(len(ready)))
        ready[i], ready[-1] = ready[-1], ready[i]
        u = ready.pop()
        order.extend(range(*units[u]))
        for c in children[u]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    assert sorted(order) == list(range(S.n_tasks))
    return order


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_order_gives_the_same_bits(rng, case):
    """The plain executor over the units in random orders that keep each
    run's tasks together (what the kernel's tickets allow, their polls the
    only order between units) equals ticket order bit for bit, in float32
    and with bfloat16 tiles."""
    A, F = _run_solver(case, rng, dtype="float32")
    N = F._numeric
    S, rs = N.sched, N.rs
    b = torch.as_tensor(rng.standard_normal((A.shape[0], 3)),
                        dtype=torch.float32)
    for L, U in ((N.ldata.tiles_t, N.udata.tiles_t),
                 (N.ldata.tiles_t.bfloat16(), N.udata.tiles_t.bfloat16())):
        want = FL.fused_ldiv_plain(b, S, L, U, rs)
        for seed in range(2):
            order = _random_unit_order(S, np.random.default_rng(seed))
            assert torch.equal(
                FL.fused_ldiv_plain(b, S, L, U, rs, order=order), want)


@pytest.mark.parametrize("name, make, cfg, want, runs", [
    ("banded_120x30", lambda: block_banded(np.random.default_rng(0), 120, 30),
     dict(chunk_size=128, ordering="colamd"), 114, [58, 56]),
    ("poisson2d_100", lambda: poisson_2d(100, 100),
     dict(chunk_size=128, ordering="nd", nd_cutoff=512), 2, [3]),
])
def test_run_path_of_the_deployments(name, make, cfg, want, runs):
    """The deep plan's path lies in two runs (the L levels and the last
    U diagonal wave, then the other U levels) but for its perm-in and
    perm-out; the Poisson plan has one short run. The strip rule with run
    times keeps 1 column on the deep plan and 4 on the Poisson plan."""
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype="float32", **cfg), device="cpu")
    S = F._numeric.sched
    assert S.run_path == want
    assert [t1 - t0 + 1 for t0, t1 in S.runs] == runs
    assert S.run_tasks == sum(runs)
    tile = S.ent_tile.size * 128 * 128 * 4
    for R in (8, 16):
        rb = FL.strip_width(R, S.critical_path, S.n_tasks, tile,
                            lambda rb: 132, S.run_path, S.run_tasks)
        assert rb == (1 if name.startswith("banded") else 4), (R, rb)


@pytest.mark.parametrize("chunk", [128, 45])
def test_float64_launches_cost_no_run(rng, monkeypatch, chunk):
    """The kernels whose ring holds two tiles take runs (float32 and
    bfloat16 tiles, as the kernel says on the card), and the rule costs
    their run tasks at ``RUN_TASK_US``; a float64 launch takes none, nor
    does any launch at a tile the ring's bulk copy cannot take (chunk 45:
    not whole 16-byte pieces), and those are costed as before runs."""
    monkeypatch.setattr(FL, "_TAKES_RUNS", {
        "ldiv_fused_f32": True, "ldiv_fused_bf16": True,
        "ldiv_fused_f64": False})
    F = tlu.ParallelSparseLU(
        block_banded(np.random.default_rng(0), 40, 9),
        config=tlu.SolverConfig(dtype="float32", chunk_size=chunk,
                                ordering="colamd"), device="cpu")
    S = F._numeric.sched
    assert S.runs and S.cs == chunk
    tile = S.ent_tile.size * S.cs ** 2
    for name, size in FL._TILE_SIZE.items():
        runs = FL._takes_runs(name, S)
        assert runs == (size <= 4 and chunk == 128)
        for R in (8, 16):
            want = FL.strip_width(R, S.critical_path, S.n_tasks, tile * size,
                                  lambda rb: 132, S.run_path * runs,
                                  S.run_tasks * runs)
            assert FL.launch_strip(name, S, R, "cpu", grid=132) == want


@pytest.mark.parametrize("pad", [0, 3])
def test_deep_runs_span_batches(pad):
    """The card tests' deep plan: two runs of ~300 tasks, each flag batch
    after the first waiting on flags outside its run (more than warp 0
    reads ahead once padded with redundant dependencies); the padding keeps
    the runs, units and path, and the plain executor's bits, in float32
    and with bfloat16 tiles."""
    make, cfg = DEEP
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype="float32", **cfg), device="cpu")
    N = F._numeric
    S0 = N.sched
    S = padded_waits(S0, pad)
    assert S.runs == S0.runs and len(S.runs) == 2
    assert S.unit_ptr.tolist() == S0.unit_ptr.tolist()
    assert S.critical_path == S0.critical_path
    assert all(t1 - t0 + 1 > 2 * RUN_BATCH for t0, t1 in S.runs)
    waits = batch_waits(S)
    assert all(w > 0 for run in waits for w in run)
    assert (max(max(run) for run in waits) > READ_AHEAD) == (pad > 0)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((F.n, 3)),
                        dtype=torch.float32)
    for L, U in ((N.ldata.tiles_t, N.udata.tiles_t),
                 (N.ldata.tiles_t.bfloat16(), N.udata.tiles_t.bfloat16())):
        assert torch.equal(FL.fused_ldiv_plain(b, S, L, U, N.rs),
                           FL.fused_ldiv_plain(b, S0, L, U, N.rs))


def _run_path_brute(n, deps, in_run):
    """Of the longest paths, the fewest run tasks: every path enumerated
    from each task back."""
    memo = {}

    def paths(t):  # (length, -run tasks) of each path ending at t
        if t not in memo:
            here = (1, -int(in_run[t]))
            memo[t] = {here} | {(a + 1, r + here[1]) for d in deps[t]
                                for a, r in paths(d)}
        return memo[t]

    best = max((p for t in range(n) for p in paths(t)), default=(0, 0))
    return -best[1]


@pytest.mark.parametrize("seed", range(6))
def test_run_path_is_the_dearest_longest_path(seed):
    """On random task graphs with random tasks marked as run tasks, the
    one pass equals a brute force over every path."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    deps = [sorted(np.flatnonzero(rng.random(t) < 0.1).tolist())
            for t in range(n)]
    dep_ptr = np.concatenate([[0], np.cumsum([len(d) for d in deps])])
    dep = np.asarray([x for d in deps for x in d], dtype=np.int64)
    in_run = rng.random(n) < 0.5
    assert FL.run_path(dep_ptr, dep, in_run) == _run_path_brute(n, deps,
                                                                in_run)


def test_strip_rule_costs_run_steps():
    """With every path task inside runs the rule costs the chain at
    RUN_TASK_US; without runs it is the rule of TASK_US alone."""
    tile, G = 128 * 128 * 4, (lambda rb: 132)
    for cp, n_tasks, tiles, R in ((3200, 4799, 3198, 16), (116, 173, 114, 8)):
        no_runs = FL.strip_width(R, cp, n_tasks, tiles * tile, G)
        assert no_runs == FL.strip_width(R, cp, n_tasks, tiles * tile, G,
                                         0, 0) == 1
        assert FL.strip_width(R, cp, n_tasks, tiles * tile, G, cp - 2,
                              tiles) == 1
    # a path all in runs on a card of one block: the fewest tickets win
    assert FL.strip_width(16, 3200, 4799, 3198 * tile, lambda rb: 1, 3198,
                          3198) == max(FL.TASK_US)
    assert set(FL.RUN_TASK_US) == set(FL.TASK_US)
    assert all(FL.RUN_TASK_US[w] < FL.TASK_US[w] for w in FL.TASK_US)
