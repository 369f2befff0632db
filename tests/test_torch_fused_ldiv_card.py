"""``ldiv_fused`` on a CUDA card at every strip width the kernel is built
for: the same bits at every width and grid, equal to the parent's width
(16 columns at R > 4) and to the 32-launch route (``perm_gather``, the L
and U waves, ``perm_gather``), and across CUDA-graph replays.

Each strip width only groups columns: every output element gets the same
entry order, the same 8-warp split of k and the same warp-order sum; a
run (a chain of one-tile tasks one block walks, ``LdivSchedule.runs``)
computes each of its tasks as a single ticket would. The benchmark's deep
plan's path lies in runs, the Poisson plan has short ones, and a deeper
plan's runs put out their flags in several batches (tests/_deep_plan.py). This file imports no JAX,
so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_fused_ldiv_card.py -q

(``tests/conftest.py`` loads JAX). Without a card every test skips.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_sparse_lu_torch as tlu
from _deep_plan import DEEP, READ_AHEAD, RUN_BATCH, batch_waits, padded_waits
from tpu_sparse_lu_torch.models import block_banded, poisson_2d
from tpu_sparse_lu_torch.ops import fused_ldiv as FL
from tpu_sparse_lu_torch.solve import blocked_tri_solve

# the benchmark's deep, narrow plan at full size, and a small Poisson plan
# with wide levels
CASES = {
    "banded_120x30": (lambda: block_banded(np.random.default_rng(0), 120, 30),
                      dict(chunk_size=128, ordering="colamd")),
    "poisson_40": (lambda: poisson_2d(40, 40),
                   dict(chunk_size=32, ordering="nd")),
}
TILES = {"float32": ("float32", "float32"), "float64": ("float64", "float32"),
         "bfloat16": ("float32", "bfloat16")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _route32(F, b):
    R, N = b.shape[1], F._numeric
    xw = FL.perm_gather(b, N.pidx, N.rs).view(F.plan.lplan.K + 1,
                                              F.plan.cs, R)
    blocked_tri_solve(N.ldata, xw, stream=True)
    blocked_tri_solve(N.udata, xw, stream=True)
    return FL.perm_gather(xw.view(-1, R), N.qidx)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_strip_gives_the_same_bits(card, case, R, tiles):
    make, cfg = CASES[case]
    dtype, stream = TILES[tiles]
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype=dtype, stream_dtype=stream, **cfg), device="cuda")
    N = F._numeric
    S, L, U = N.sched, N.ldata, N.udata
    b = torch.as_tensor(np.random.default_rng(17).standard_normal((F.n, R)),
                        dtype=F.dtype, device="cuda")
    if tiles == "bfloat16":
        wrapper = FL.fused_ldiv_bf16
        run = lambda **kw: wrapper(b, S, L.tiles_bf16, U.tiles_bf16, N.rs,
                                   **kw)
    else:
        wrapper = FL.fused_ldiv
        run = lambda **kw: wrapper(b, S, L.tiles_t, U.tiles_t, N.rs, **kw)
    want = run(strip=16)
    assert torch.equal(want, _route32(F, b))
    narrow = wrapper.NARROW_LAUNCHES
    assert torch.equal(run(), want)
    assert torch.equal(N.tiles(b), want)
    rb = FL.launch_strip(f"ldiv_fused_{FL._KERNEL_DTYPES[F.dtype]}"
                         if tiles != "bfloat16" else "ldiv_fused_bf16",
                         S, R, b.device)
    assert wrapper.NARROW_LAUNCHES - narrow == 2 * (rb < min(R, 16))
    if case == "banded_120x30":  # a chain: the rule goes narrow
        assert rb < R
    for strip in FL.TASK_US:
        for grid in (None, 1, 2, 7):
            assert torch.equal(run(strip=strip, grid=grid), want), (strip,
                                                                    grid)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tiles", sorted(TILES))
def test_a_tile_the_bulk_copy_cannot_take_runs_as_single_tickets(card,
                                                                 tiles):
    """At chunk_size 45 a tile is not a whole number of 16-byte pieces,
    which a run's bulk copy needs: the plan has runs, but the launch takes
    none and gives the same bits as the 32-launch route at every width and
    grid."""
    dtype, stream = TILES[tiles]
    F = tlu.ParallelSparseLU(
        block_banded(np.random.default_rng(0), 40, 9),
        config=tlu.SolverConfig(dtype=dtype, stream_dtype=stream,
                                chunk_size=45, ordering="colamd"),
        device="cuda")
    N = F._numeric
    S, L, U = N.sched, N.ldata, N.udata
    assert S.run_path == S.critical_path - 2
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((F.n, 8)),
                        dtype=F.dtype, device="cuda")
    want = _route32(F, b)
    wrapper = FL.fused_ldiv_bf16 if tiles == "bfloat16" else FL.fused_ldiv
    runs = wrapper.RUN_LAUNCHES
    for strip in FL.TASK_US:
        for grid in (None, 1, 2):
            if tiles == "bfloat16":
                got = FL.fused_ldiv_bf16(b, S, L.tiles_bf16, U.tiles_bf16,
                                         N.rs, strip=strip, grid=grid)
            else:
                got = FL.fused_ldiv(b, S, L.tiles_t, U.tiles_t, N.rs,
                                    strip=strip, grid=grid)
            assert torch.equal(got, want), (strip, grid)
    assert wrapper.RUN_LAUNCHES == runs
    torch.cuda.synchronize()


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("tiles", ["bfloat16", "float32"])
def test_deep_runs_give_the_same_bits(card, tiles, pad):
    """Runs of ~300 tasks, their flags out in several batches, each batch
    after the first waiting on flags outside its run (padded: more than
    warp 0 reads ahead, tests/_deep_plan.py): the same bits as the
    32-launch route at every width and at grids full, 1 and 2, and across
    two replays of a captured launch."""
    make, cfg = DEEP
    dtype, stream = TILES[tiles]
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype=dtype, stream_dtype=stream, **cfg), device="cuda")
    N = F._numeric
    S = padded_waits(N.sched, pad)
    assert all(t1 - t0 + 1 > 2 * RUN_BATCH for t0, t1 in S.runs)
    assert (max(max(w) for w in batch_waits(S)) > READ_AHEAD) == (pad > 0)
    L, U = ((N.ldata.tiles_bf16, N.udata.tiles_bf16) if tiles == "bfloat16"
            else (N.ldata.tiles_t, N.udata.tiles_t))
    wrapper = FL.fused_ldiv_bf16 if tiles == "bfloat16" else FL.fused_ldiv
    b = torch.as_tensor(np.random.default_rng(9).standard_normal((F.n, 8)),
                        dtype=F.dtype, device="cuda")
    want = _route32(F, b)
    runs = wrapper.RUN_LAUNCHES
    for strip in FL.TASK_US:
        for grid in (None, 1, 2):
            got = wrapper(b, S, L, U, N.rs, strip=strip, grid=grid)
            assert torch.equal(got, want), (strip, grid)
    assert wrapper.RUN_LAUNCHES - runs == 3 * len(FL.TASK_US)
    graph, out = _capture(lambda: wrapper(b, S, L, U, N.rs))
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def _capture(fn):
    """``fn`` captured in a CUDA graph after warm-up on the capture stream
    (the solve's ready flags are made per stream); returns the graph and
    the captured output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_replays_give_the_same_bits(card, case, tiles):
    """Two replays of a captured launch (the kernel resets its own flags
    and counters) equal the eager launch and the 32-launch route."""
    make, cfg = CASES[case]
    dtype, stream = TILES[tiles]
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype=dtype, stream_dtype=stream, **cfg), device="cuda")
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((F.n, 16)),
                        dtype=F.dtype, device="cuda")
    want = F._numeric.tiles(b)
    assert torch.equal(want, _route32(F, b))
    graph, out = _capture(lambda: F._numeric.tiles(b))
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_run_launches_count_plans_with_runs(card):
    """``RUN_LAUNCHES`` counts the deep plan's float32 launches; a float64
    launch of the same plan takes no run, and a diagonal plan (two
    independent chunks a wave, so no task follows the one it depends on)
    has none: both launch their tasks as tickets and count none."""
    make, cfg = CASES["banded_120x30"]
    F, F64 = (tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype=dt, **cfg), device="cuda") for dt in ("float32", "float64"))
    D = tlu.ParallelSparseLU(
        sp.diags(np.arange(1.0, 65.0)).tocsc(),
        config=tlu.SolverConfig(dtype="float32", chunk_size=32),
        device="cuda")
    assert F._numeric.sched.runs and not D._numeric.sched.runs
    assert {name for name in FL._TILE_SIZE
            if FL._takes_runs(name, F._numeric.sched)} == {
                "ldiv_fused_f32", "ldiv_fused_bf16"}
    S = D._numeric.sched
    assert S.unit_ptr.tolist() == list(range(S.n_tasks + 1))
    for G, want in ((F, 2), (F64, 0), (D, 0)):
        b = torch.ones((G.n, 8), dtype=G.dtype, device="cuda")
        before = FL.fused_ldiv.RUN_LAUNCHES, FL.fused_ldiv.LAUNCHES
        x = G._numeric.tiles(b)
        x = G._numeric.tiles(b)
        assert torch.equal(x, _route32(G, b))
        assert (FL.fused_ldiv.RUN_LAUNCHES - before[0],
                FL.fused_ldiv.LAUNCHES - before[1]) == (want, 2)
    torch.cuda.synchronize()
