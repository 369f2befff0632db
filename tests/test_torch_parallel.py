"""The port's mesh engines (``tpu_sparse_lu_torch.parallel``) against the
JAX package's.

The plans are held array by array against JAX's in this process at
D in {1, 2, 3, 4, 8}. The engines run in gloo process groups of 2 and 4
CPU ranks, spawned once for the module (``_torch_parallel_worker.py``,
which imports no JAX); each case is then reported on its own against the
JAX engine on the conftest's 8-device CPU mesh at the same D, the port's
single-device ``F.ldiv`` and scipy's ``spsolve``. Bars: to ``F.ldiv``
1e-13 (psum engine) and 1e-12 (pipeline), as ``tests/test_sharded.py:37``
and ``tests/test_pipeline.py:37``; to ``spsolve`` and to the JAX engine
the reference's 1e-12 at ``"trsm"``/``"inv_refine"`` and the JAX
package's 1e-9 at ``"inv"`` (``tests/test_solve.py:111``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.linalg as spla
from _approx import assert_isapprox

import _torch_parallel_worker as W
import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.parallel.mesh import make_mesh as jax_mesh
from tpu_sparse_lu.parallel.pipeline_solve import (
    autotune_micro_panels as jax_autotune,
)
from tpu_sparse_lu.parallel.pipeline_solve import (
    build_pipeline_plan as jax_pipeline_plan,
)
from tpu_sparse_lu.parallel.pipeline_solve import (
    build_sharded_perm_plan as jax_perm_plan,
)
from tpu_sparse_lu.parallel.pipeline_solve import (
    make_pipeline_ldiv as jax_pipeline,
)
from tpu_sparse_lu.parallel.sharded_solve import (
    build_sharded_tri_plan as jax_tri_plan,
)
from tpu_sparse_lu.parallel.sharded_solve import (
    make_sharded_ldiv as jax_sharded,
)
from tpu_sparse_lu_torch.parallel import pipeline_solve as pp
from tpu_sparse_lu_torch.parallel import sharded_solve as ss

HERE = Path(__file__).resolve().parent
WORLDS = (2, 4)
PLAN_DS = (1, 2, 3, 4, 8)
MODE_TOL = {"inv": 1e-9, "trsm": 1e-12, "inv_refine": 1e-12}
SPAWN_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the plans, in this process
# ---------------------------------------------------------------------------


def _port(family, mode="trsm"):
    A0, A, cfg = W.problem(family)
    F = tlu.ParallelSparseLU(A0, config=tlu.SolverConfig(tri_mode=mode,
                                                         **cfg),
                             device="cpu")
    if A is not A0:
        F.refactor(A)
    return A, F


def _jax(family, mode="trsm"):
    A0, A, cfg = W.problem(family)
    jf = jlu.ParallelSparseLU(A0, config=jlu.SolverConfig(tri_mode=mode,
                                                          **cfg))
    if A is not A0:
        jf.refactor(A)
    return jf


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


@pytest.mark.parametrize("D", PLAN_DS)
@pytest.mark.parametrize("family", ["poisson", "poisson_nd", "banded"])
def test_sharded_tri_plan_equals_jax(family, D):
    _, F = _port(family)
    for tp in (F.plan.lplan, F.plan.uplan):
        got, want = ss.build_sharded_tri_plan(tp, D), jax_tri_plan(tp, D)
        assert got.MW == want.MW and len(got.segments) == len(want.segments)
        for f in ("level_chunks", "level_tiles", "tile_src_slot",
                  "level_touched", "chunk_cslot", "tile_cslot"):
            _same(getattr(got, f), getattr(want, f), f)
        for gs, ws in zip(got.segments, want.segments):
            assert gs.MW == ws.MW
            for f in ("level_chunks", "level_tiles", "tile_src_slot",
                      "chunk_cslot", "tile_cslot", "level_touched"):
                _same(getattr(gs, f), getattr(ws, f), f"segment {f}")
        for R in (1, 16):
            assert (got.psum_bytes_per_solve(8, R, 8)
                    == want.psum_bytes_per_solve(8, R, 8))
        # every chunk and tile appears exactly once across the ranks
        ch = got.level_chunks[got.level_chunks < tp.K]
        assert sorted(ch.tolist()) == list(range(tp.K))
        ti = got.level_tiles[got.level_tiles < tp.T]
        assert sorted(ti.tolist()) == list(range(tp.T))


@pytest.mark.parametrize("D", PLAN_DS)
@pytest.mark.parametrize("family",
                         ["banded", "chain_refactor", "poisson", "banded_nd"])
def test_pipeline_plan_equals_jax(family, D):
    """Equal arrays, and ``None`` exactly where JAX refuses the pattern."""
    _, F = _port(family)
    for tp in (F.plan.lplan, F.plan.uplan):
        got, want = pp.build_pipeline_plan(tp, D), jax_pipeline_plan(tp, D)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert (got.D, got.Kl, got.H, got.forward, got.MT, got.MB) == (
            want.D, want.Kl, want.H, want.forward, want.MT, want.MB)
        for f in ("steps", "step_tiles", "step_tile_dst", "bnd_tiles",
                  "bnd_tile_dst"):
            _same(getattr(got, f), getattr(want, f), f)


def test_pipeline_plan_refuses_wide_patterns():
    """Poisson under COLAMD scatters dependencies across the partition:
    at 8 ranks a crossing skips a rank, in both packages."""
    _, F = _port("poisson")
    assert (pp.build_pipeline_plan(F.plan.lplan, 8) is None
            or pp.build_pipeline_plan(F.plan.uplan, 8) is None)


@pytest.mark.parametrize("D", PLAN_DS)
@pytest.mark.parametrize("family", ["banded", "chain_refactor", "poisson"])
def test_sharded_perm_plan_equals_jax(family, D):
    """The port's blocks of the perm-out (from its gather index) give
    JAX's sharded un-pivot plan; the rows behind them reproduce the
    permutation."""
    _, F = _port(family)
    jf = _jax(family)
    Kl = -(-F.plan.lplan.K // D)
    qb = pp.build_perm_blocks(F._numeric.qidx.numpy(), F.n, F.plan.cs,
                              n_in=F.plan.n)
    assert (qb.K, qb.S, qb.K_in) == (jf._qperm.K, jf._qperm.S,
                                     jf._qperm.K_in)
    _same(qb.src, jf._qperm.src, "src")
    got, want = pp.build_sharded_perm_plan(qb, Kl, D), jax_perm_plan(
        jf._qperm, Kl, D)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert (got.D, got.Ko_l, got.use_dir) == (want.D, want.Ko_l,
                                              want.use_dir)
    for f in ("tile_idx", "src_slot", "dst_slot"):
        _same(getattr(got, f), getattr(want, f), f)
    # applying row_src rank by rank, boundary moves summed, is Q x
    cs = F.plan.cs
    x = np.random.default_rng(0).random(D * Kl * cs)
    out = np.zeros(D * got.Ko_l * cs)
    for d in range(D):
        loc = x[d * Kl * cs:(d + 1) * Kl * cs]
        for di, shift in ((0, 0), (1, 1), (2, -1)):
            idx = got.row_src[d, di]
            dst = d + shift
            if 0 <= dst < D:
                seg = np.where(idx >= 0, loc[np.maximum(idx, 0)], 0.0)
                out[dst * got.Ko_l * cs:(dst + 1) * got.Ko_l * cs] += seg
    q = F._numeric.qidx.numpy()
    np.testing.assert_array_equal(out[: F.n], x[q])
    assert not out[F.n:].any()


@pytest.mark.parametrize("D", PLAN_DS)
def test_autotune_micro_panels_equals_jax(D):
    for R in (1, 2, 3, 7, 16, 32, 64, 96):
        assert pp.autotune_micro_panels(R, D) == jax_autotune(R, D)
    assert pp.autotune_micro_panels(64, D, cap=5) == jax_autotune(64, D,
                                                                 cap=5)


# ---------------------------------------------------------------------------
# the engines on gloo groups of 2 and 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn every world once (all at the same time), join them under a
    deadline, kill the survivors of a failure; per world the arrays and
    errors of each rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for D in WORLDS:
        out = tmp_path_factory.mktemp(f"world{D}")
        url = "file://" + str(out / "store")
        procs[D] = (out, [subprocess.Popen(
            [sys.executable, str(HERE / "_torch_parallel_worker.py"),
             str(r), str(D), url, str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True) for r in range(D)])
    logs = {}
    try:
        for D, (_, ps) in procs.items():
            logs[D] = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in ps]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    res = {}
    for D, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"world {D} rank {r}:\n" + \
                logs[D][r][-3000:]
        ranks = []
        for r in range(D):
            with np.load(out / f"rank{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            errors = json.loads((out / f"rank{r}.json").read_text())
            ranks.append((arrays, errors))
        res[D] = ranks
    return res


def _case(runs, D, name):
    """Each rank's arrays of ``name`` (``{key: array}``), after checking
    that no rank raised in it."""
    out = []
    for r, (arrays, errors) in enumerate(runs[D]):
        assert name not in errors, f"rank {r}:\n{errors[name]}"
        pre = name + "|"
        out.append({k[len(pre):]: v for k, v in arrays.items()
                    if k.startswith(pre)})
    return out


ENGINE_CASES = [(e, f, m) for e, fams in (("sharded", W.SHARDED),
                                          ("pipeline", W.PIPELINE))
                for f in fams for m in W.MODES]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("engine, family, mode", ENGINE_CASES)
def test_engine_matches_jax_ldiv_and_scipy(runs, D, engine, family, mode):
    got = _case(runs, D, f"{engine}/{family}/{mode}")
    A, F = _port(family, mode)
    jf = _jax(family, mode)
    b = W.rhs(A.shape[0], W.R)
    if engine == "sharded":
        want_jax = np.asarray(jax_sharded(jf, jax_mesh(D))(b))
        single_tol = 1e-13
    else:
        js = jax_pipeline(jf, jax_mesh(D), micro_panels=W.MICRO)
        assert ("none" in got[0]) == (js is None)
        if js is None:  # the crossing skips a rank: the psum engine serves
            return
        want_jax = np.asarray(js(b))
        single_tol = 1e-12
    x = got[0]["x"]
    for r in range(1, D):  # replicated: every rank holds the same bits
        assert np.array_equal(got[r]["x"], x)
    np.testing.assert_allclose(x, F.ldiv(b).numpy(), rtol=single_tol,
                               atol=single_tol)
    tol = MODE_TOL[mode]
    assert_isapprox(x, spla.spsolve(A, b), rtol=tol, atol=tol, msg="spsolve")
    assert_isapprox(x, want_jax, rtol=tol, atol=tol, msg="JAX engine")
    if engine == "sharded":
        # one all_reduce per level of each factor, JAX's psum count
        assert int(got[0]["all_reduce"]) == (F.plan.lplan.num_levels
                                             + F.plan.uplan.num_levels)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_output_partitioned(runs, D):
    got = _case(runs, D, "sharded_output")
    A, F = _port("poisson")
    b = W.rhs(A.shape[0], W.R)
    n, Sh = A.shape[0], -(-A.shape[0] // D)
    full = got[0]["full"]
    assert full.shape == (D * Sh, W.R)
    for r in range(D):
        assert got[r]["sharded"] == 1
        np.testing.assert_array_equal(got[r]["local"],
                                      full[r * Sh:(r + 1) * Sh])
    np.testing.assert_allclose(full[:n], F.ldiv(b).numpy(), rtol=1e-12,
                               atol=1e-12)
    jx = np.asarray(jax_sharded(_jax("poisson"), jax_mesh(D),
                                shard_output=True)(b))
    assert jx.shape == full.shape
    assert_isapprox(full, jx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(full[n:], 0.0)


@pytest.mark.parametrize("D", WORLDS)
def test_pipeline_distributed_output(runs, D):
    """``replicate=False``: rows partitioned, padded with zeros, no
    all_reduce; the JAX engine's distributed output agrees."""
    got = _case(runs, D, "pipeline_distributed")
    A, F = _port("banded")
    b = W.rhs(A.shape[0], W.R)
    n = A.shape[0]
    full = got[0]["full"]
    rows = full.shape[0] // D
    assert full.shape[0] % D == 0 and full.shape[0] >= n
    for r in range(D):
        assert got[r]["sharded"] == 1 and got[r]["all_reduce"] == 0
        np.testing.assert_array_equal(got[r]["local"],
                                      full[r * rows:(r + 1) * rows])
    np.testing.assert_allclose(full[:n], F.ldiv(b).numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(full[n:], 0.0)
    jx = np.asarray(jax_pipeline(_jax("banded"), jax_mesh(D),
                                 micro_panels=W.MICRO, replicate=False)(b))
    assert jx.shape == full.shape
    assert_isapprox(full, jx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_pipeline_single_rhs(runs, D):
    got = _case(runs, D, "pipeline_single_rhs")
    A, _ = _port("chain_refactor")
    b = W.rhs(A.shape[0], 1)[:, 0]
    want = spla.spsolve(A, b)
    assert got[0]["x"].shape == b.shape
    assert_isapprox(got[0]["x"], want, rtol=1e-12, atol=1e-12)
    assert_isapprox(got[0]["xs"][: A.shape[0]], want, rtol=1e-12,
                    atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_pipeline_pair_matches_sequential(runs, D):
    """The overlapped L/U waves equal the two pipelined solves run one
    after the other, and the single-device blocked solves."""
    import torch

    from tpu_sparse_lu_torch.solve import (
        block_rhs,
        blocked_tri_solve,
    )

    got = _case(runs, D, "pipeline_pair")
    A, F = _port("banded")
    np.testing.assert_allclose(got[0]["pair"], got[0]["seq"], rtol=1e-12,
                               atol=1e-12)
    b = torch.as_tensor(W.rhs(A.shape[0], 8))
    xw = block_rhs(b, A.shape[0], F.plan.lplan.K, F.plan.cs)
    blocked_tri_solve(F._numeric.ldata, xw, mode="trsm")
    blocked_tri_solve(F._numeric.udata, xw, mode="trsm")
    K = F.plan.lplan.K
    np.testing.assert_allclose(got[0]["pair"][:K], xw[:K].numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_dp_columns(runs, D):
    """Columns split over the ranks, no collective in the solve; the
    gathered panel equals ``F.ldiv`` and the JAX DP engine."""
    from tpu_sparse_lu.parallel.dp import make_dp_ldiv as jax_dp

    got = _case(runs, D, "dp")
    A, F = _port("poisson")
    B = W.rhs(A.shape[0], 4 * D)
    full = got[0]["full"]
    want = F.ldiv(B).numpy()
    np.testing.assert_allclose(full, want, rtol=1e-13, atol=1e-13)
    for r in range(D):
        assert got[r]["collectives"] == 0
        assert got[r]["refused_indivisible"] == 1
        np.testing.assert_array_equal(got[r]["local"],
                                      full[:, 4 * r:4 * (r + 1)])
    jx = np.asarray(jax_dp(_jax("poisson"), jax_mesh(D))(B))
    assert_isapprox(full, jx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_allocate_shared(runs, D):
    got = _case(runs, D, "allocate_shared")
    for r in range(D):
        assert got[r]["rep_is"] == 1 and got[r]["sh_is"] == 1
        assert got[r]["rep_local"].shape == (64, 8)
        assert got[r]["sh_local"].shape == (64 // D, 8)
        assert not got[r]["rep_local"].any() and not got[r]["sh_local"].any()


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_apply_perm_boundary_exchange(runs, D):
    """The owner-computes un-pivot when the permutation crosses rank
    boundaries: each rank's output rows equal the permuted vector's."""
    got = _case(runs, D, "apply_perm_boundary")
    cs, Kl = 8, 3
    n = D * Kl * cs
    perm = np.minimum(np.arange(n) + cs, n - 1)
    perm[-cs:] = np.arange(n - cs, n)
    want = W.rhs(n, 3, seed=9)[perm]
    assert got[0]["use"][1] or got[0]["use"][2]
    rows = Kl * cs
    for r in range(D):
        np.testing.assert_array_equal(got[r]["out"],
                                      want[r * rows:(r + 1) * rows])
        assert got[r]["send_recv"] == 1


@pytest.mark.parametrize("D", WORLDS)
def test_replicate_to_mesh_broadcasts_rank0(runs, D):
    """Every rank ends with rank 0's tensors; its own are left as they
    were."""
    got = _case(runs, D, "replicate_to_mesh")
    for r in range(D):
        np.testing.assert_array_equal(got[r]["a"], np.zeros((3, 2)))
        np.testing.assert_array_equal(got[r]["b"], np.arange(4))
        np.testing.assert_array_equal(got[r]["kept"], np.full((3, 2), r))


# ---------------------------------------------------------------------------
# process start-up: initialize_multihost over TCP, the dry run
# ---------------------------------------------------------------------------

_TWO_PROCESS = """
import sys
import numpy as np
from tpu_sparse_lu_torch import ParallelSparseLU
from tpu_sparse_lu_torch.models import poisson_2d
from tpu_sparse_lu_torch.parallel.mesh import (initialize_multihost,
                                               make_global_mesh)
from tpu_sparse_lu_torch.parallel.sharded_solve import make_sharded_ldiv
import torch, torch.distributed as dist
pid, port = int(sys.argv[1]), int(sys.argv[2])
dev = initialize_multihost(f"localhost:{port}", 2, pid, device="cpu")
assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
mesh = make_global_mesh()
A = poisson_2d(12, 10)
b = np.random.default_rng(0).random(A.shape[0])
F = ParallelSparseLU(A, chunk_size=8, device="cpu")
x = make_sharded_ldiv(F, mesh)(b).numpy()
r = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
assert r < 1e-10, r
dist.destroy_process_group()
print(f"MULTIHOST_OK proc={pid} resid={r:.1e}", flush=True)
"""


def test_initialize_multihost_two_processes():
    with socket.socket() as s:  # a free port, taken by binding port 0
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(HERE.parent)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESS, str(pid), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIHOST_OK" in out, (
            f"proc {pid}:\n{out[-3000:]}")


def test_dryrun_multichip_four_ranks():
    from tpu_sparse_lu_torch.parallel.dryrun import OK, dryrun_multichip

    out = dryrun_multichip(4)
    assert out.count(OK) == 4


def test_make_mesh_needs_a_process_group():
    from tpu_sparse_lu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh()
