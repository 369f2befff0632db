"""The chain deployment's files: on the CPU the frozen 1-D Laplacian, a run
of a small copy of ``laplacian1d_20000.solve`` (n = 300, ``chunk_size``
16), the control failing it, the entry refusing a solver off the chain
path, and the two metrics of the chain on synthetic traces; on a card
(``card``) the control failing the cell at its own size and the program
passing it.

The small copy is made here, in a temporary folder searched before the
benchmark's own, with the real cell's traffic and limits of its own
(``TINY_LIMITS``)."""

import copy
import json

import numpy as np
import pytest
import scipy.sparse as sp

from h100_bench import harness, readings, reduce, work
from h100_bench.tests.conftest import ROOT

BENCH = harness.Bench.load(ROOT)
CELL = "laplacian1d_20000.solve"
TINY_CELL = "tiny_chain.solve"
TINY = {"name": "tiny_chain", "family": "laplacian_1d", "matrix": {"n": 300},
        "solver": {"chunk_size": 16, "ordering": "natural",
                   "pivot_threshold": 0.0, "dtype": "float32"},
        "reference": "dense_f64", "control": "tf32_control"}
SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 12345]
# the small copy's limits: on the CPU (the plain scan, not the kernel) it
# reads fwd_err <= 1.01e-6 and bwd_err <= 8.95e-9 from the program over
# eight seeds, and fwd_err >= 1.37e-2, bwd_err >= 1.95e-6 from the control
# over three; each limit lies above the geometric mean of its two readings
# (the cell's own, set at full size on the card, leave the control's
# fwd_err under 2e-2 here)
TINY_LIMITS = {"fwd_err": 2e-4, "bwd_err": 2e-7}


@pytest.fixture
def tiny_chain(tmp_path):
    """The benchmark with ``tiny_chain.solve``: the chain cell on a small
    copy of its deployment, reporting what the cell reports, judged by
    ``TINY_LIMITS``."""
    spec = copy.deepcopy(BENCH.spec)
    for kind in ("configs", "limits"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "tiny_chain.json").write_text(json.dumps(TINY))
    (tmp_path / "limits" / f"{TINY_CELL}.json").write_text(json.dumps(
        TINY_LIMITS))
    spec["workloads"].append(dict(BENCH.cell(CELL), name=TINY_CELL,
                                  config="tiny_chain"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    return harness.Bench(spec, dirs=[tmp_path, harness.HERE])


def test_the_frozen_laplacian_equals_the_programs():
    from tpu_sparse_lu_torch.models import laplacian_1d

    ours = sp.csc_matrix(BENCH.module("families", "laplacian_1d").build(n=37))
    theirs = sp.csc_matrix(laplacian_1d(37))
    for m in (ours, theirs):
        m.sort_indices()
    assert np.array_equal(ours.indptr, theirs.indptr)
    assert np.array_equal(ours.indices, theirs.indices)
    assert np.array_equal(ours.data, theirs.data)


def test_the_cell_is_registered():
    cfg = BENCH.data("configs", "laplacian1d_20000")
    assert cfg["matrix"] == {"n": 20000} and cfg["reduced"] == []
    assert cfg["solver"] == {"chunk_size": 128, "ordering": "natural",
                             "pivot_threshold": 0.0, "dtype": "float32"}
    assert BENCH.data("traffic", BENCH.cell(CELL)["traffic"])["entry"] == \
        "ldiv_chain"
    e2e = {m["name"] for m in BENCH.metrics(CELL, False)}
    assert e2e == {"solve_step_ms", "solve_step_p95_ms", "setup_s"}
    layer = {m["name"] for m in BENCH.metrics(CELL, True)}
    assert {"bidiag_roofline.solve", "chain_launch_host_ms.solve",
            "host_dispatch_ms.solve", "device_idle_share.solve"} <= layer
    # nothing in this cell launches ldiv_fused or opens lu.ldiv.launch
    assert not layer & {"ldiv_fused_roofline.solve",
                        "ldiv_launch_host_ms.solve"}


def test_a_run_of_the_small_copy_on_the_cpu(tiny_chain):
    r = harness.run_cell(tiny_chain, TINY_CELL, 2 ** 31 + 11, 0.3, False,
                         "cpu", harness.time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 tiny_chain.metrics(TINY_CELL, False)}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def _control_fails_and_program_passes(bench, cell, device, seconds):
    got = readings.readings(bench, cell, SEEDS, len(SEEDS), seconds, device)
    limits = bench.data("limits", cell)

    def fails(r):
        return any(not r[k] <= lim for k, lim in limits.items())

    assert not any(fails(r) for r in got["program"]), got["program"]
    assert all(fails(r) for r in got["control"]), got["control"]


def test_the_control_fails_the_small_copy(tiny_chain):
    _control_fails_and_program_passes(tiny_chain, TINY_CELL, "cpu", 0.2)


@pytest.mark.card
def test_the_control_fails_the_cell_on_the_card(card):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    _control_fails_and_program_passes(BENCH, CELL, "cuda", 1.0)


def test_the_entry_refuses_a_solver_off_the_chain():
    import tpu_sparse_lu_torch as tlu

    entry = BENCH.module("entries", "ldiv_chain")
    fam = BENCH.module("families", "poisson_2d")
    F = tlu.ParallelSparseLU(fam.build(nx=8, ny=8), config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", nd_cutoff=32, dtype="float32"),
        device="cpu")
    assert F.solve_path == "tiles"
    with pytest.raises(RuntimeError, match="chain solve"):
        entry.make(F)

    class Older:  # a program that cannot say which path it takes
        pass

    with pytest.raises(RuntimeError, match="None"):
        entry.make(Older())


def _run(trace=None):
    # the cell's own work: nnz(L+U) = 59,998 at n = 20,000, R = 1
    w = work.Work(dtype="float32", n=20000, rhs=1, nnz_a=59998,
                  nnz_lu=59998, elim_flop=0)
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=2,
                       window_s=1.0, latency_s=np.array([0.1, 0.1]),
                       dispatch_s=np.array([0.01, 0.01]), work=w,
                       trace=trace)


def test_the_chain_metrics_read_a_synthetic_trace():
    roof = BENCH.module("metrics", "bidiag_roofline.solve").read
    host = BENCH.module("metrics", "chain_launch_host_ms.solve").read
    ops = [("bidiag_kernel<float>", 0.10, 0.10 + 24e-6),
           ("bidiag_kernel<float>", 0.30, 0.30 + 26e-6),
           ("ldiv_fused_kernel<float, float, 1>", 0.5, 0.6)]
    sp_ = [("api.ldiv", 0.05, 0.2), ("lu.ldiv.rhs", 0.05, 0.06),
           ("lu.ldiv.chain", 0.06, 0.09),
           ("api.ldiv", 0.25, 0.4), ("lu.ldiv.rhs", 0.25, 0.26),
           ("lu.ldiv.chain", 0.26, 0.31)]
    run = _run(reduce.Trace(window_s=1.0, steps=2, ops=ops, spans=sp_))
    assert run.work.ldiv_bytes == 639984
    # the least time over the mean launch (25 µs), the other kernel left out
    assert roof(run) == pytest.approx(100 * run.work.ldiv_s / 25e-6)
    assert roof(run) == pytest.approx(0.7642, rel=1e-3)
    # the median of 30 and 50 ms
    assert host(run) == pytest.approx(40.0)


def test_the_chain_metrics_read_none_without_the_chain():
    roof = BENCH.module("metrics", "bidiag_roofline.solve").read
    host = BENCH.module("metrics", "chain_launch_host_ms.solve").read
    assert roof(_run()) is None and host(_run()) is None  # untraced
    # a tile solve's window: no chain kernel and no lu.ldiv.chain span
    tiles = reduce.Trace(window_s=1.0, steps=1,
                         ops=[("ldiv_fused_kernel<float, float, 1>", 0.1,
                               0.2)],
                         spans=[("api.ldiv", 0.05, 0.2),
                                ("lu.ldiv.launch", 0.06, 0.09)])
    assert roof(_run(tiles)) is None and host(_run(tiles)) is None
