"""The float64 substitution deployment's files: on the CPU the cell's
registration, a run of a small copy of ``poisson2d_100_trsm_f64.solve``
(``poisson_2d(20, 20)``, ``chunk_size`` 16), the float32 control and two
faults broken into ``ldiv`` failing it, the entry refusing a solver off
its path, the solve's work at float64 against a hand count, and the five
metrics of the level-step solve on synthetic traces; on a card (``card``)
the control failing the cell at its own size and the program passing it.

The small copy is made here, in a temporary folder searched before the
benchmark's own, with the real cell's traffic and limits."""

import copy
import json

import numpy as np
import pytest
import scipy.sparse as sp

from h100_bench import harness, readings, reduce, work
from h100_bench.tests.conftest import ROOT

BENCH = harness.Bench.load(ROOT)
CELL = "poisson2d_100_trsm_f64.solve"
TINY_CELL = "tiny_poisson_trsm_f64.solve"
SOLVER = {"chunk_size": 16, "ordering": "nd", "nd_cutoff": 64,
          "dtype": "float64", "tri_mode": "trsm"}
TINY = {"name": "tiny_poisson_trsm_f64", "family": "poisson_2d",
        "matrix": {"nx": 20, "ny": 20}, "solver": SOLVER,
        "reference": "dense_f64", "control": "f32_control"}
SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 12345]
METRICS = ("levels_roofline.trsm", "diag_step_ms.trsm", "diag_host_ms.trsm",
           "ldiv_launch_host_ms.trsm", "device_ops.trsm")


@pytest.fixture
def tiny_trsm(tmp_path):
    """The benchmark with ``tiny_poisson_trsm_f64.solve``: the cell on a
    small copy of its deployment, reporting what the cell reports, judged
    by the cell's own limits."""
    spec = copy.deepcopy(BENCH.spec)
    for kind in ("configs", "limits"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "tiny_poisson_trsm_f64.json").write_text(
        json.dumps(TINY))
    (tmp_path / "limits" / f"{TINY_CELL}.json").write_text(json.dumps(
        BENCH.data("limits", CELL)))
    spec["workloads"].append(dict(BENCH.cell(CELL), name=TINY_CELL,
                                  config="tiny_poisson_trsm_f64"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    return harness.Bench(spec, dirs=[tmp_path, harness.HERE])


def test_the_cell_is_registered():
    cfg = BENCH.data("configs", "poisson2d_100_trsm_f64")
    assert cfg["matrix"] == {"nx": 100, "ny": 100} and cfg["reduced"] == []
    assert cfg["family"] == "poisson_2d"
    # poisson2d_100's solver in float64, solving by substitution
    base = BENCH.data("configs", "poisson2d_100")
    assert cfg["solver"] == dict(base["solver"], dtype="float64",
                                 tri_mode="trsm")
    assert (cfg["reference"], cfg["control"]) == ("dense_f64", "f32_control")
    c = BENCH.cell(CELL)
    assert c["config"] == "poisson2d_100_trsm_f64" and c["chips"] == 1
    traffic = BENCH.data("traffic", c["traffic"])
    assert traffic["entry"] == "ldiv_trsm" and traffic["rhs"] == 16
    assert traffic["rhs_ring"] == 64 and traffic["value_ring"] == 0
    assert BENCH.module("entries", "ldiv_trsm").SPAN == "api.ldiv"
    assert BENCH.data("limits", CELL)["fwd_err"] == 1e-12
    e2e = {m["name"] for m in BENCH.metrics(CELL, False)}
    assert e2e == {"solve_step_ms", "solve_step_p95_ms", "setup_s"}
    layer = {m["name"] for m in BENCH.metrics(CELL, True)}
    assert layer == set(METRICS) | {
        "host_dispatch_ms.solve", "device_idle_share.solve",
        "program_idle_share.solve", "factorize_s", "kernel_load_s",
        "construct_s"}
    for name in METRICS:
        m = next(m for m in BENCH.spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["layer"] == "level-step solve"
        assert m["moves"] == "solve_step_ms"
        assert BENCH.module("metrics", name).read  # a reader is found
    # no other cell reports them
    for w in BENCH.spec["workloads"]:
        if w["name"] != CELL:
            assert not {m["name"] for m in BENCH.metrics(w["name"], True)} \
                & set(METRICS)


def test_a_run_of_the_small_copy_on_the_cpu(tiny_trsm):
    r = harness.run_cell(tiny_trsm, TINY_CELL, 2 ** 31 + 11, 0.3, False,
                         "cpu", harness.time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 tiny_trsm.metrics(TINY_CELL, False)}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def _control_fails_and_program_passes(bench, cell, device, seconds):
    got = readings.readings(bench, cell, SEEDS, len(SEEDS), seconds, device)
    limits = bench.data("limits", cell)

    def fails(r):
        return any(not r[k] <= lim for k, lim in limits.items())

    assert not any(fails(r) for r in got["program"]), got["program"]
    assert all(fails(r) for r in got["control"]), got["control"]


def test_the_control_fails_the_small_copy(tiny_trsm):
    _control_fails_and_program_passes(tiny_trsm, TINY_CELL, "cpu", 0.2)


@pytest.mark.card
def test_the_control_fails_the_cell_on_the_card(card):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    _control_fails_and_program_passes(BENCH, CELL, "cuda", 1.0)


def _break(monkeypatch, fault):
    """Break ``ldiv`` underneath the harness."""
    import torch

    from tpu_sparse_lu_torch.api import ParallelSparseLU

    ldiv = ParallelSparseLU.ldiv
    first = []

    def broken(self, b, **kw):
        if fault == "unchanged":
            # one stale answer handed back, that of a step the ring never
            # takes (its first step is also the window's first)
            if not first:
                first.append(ldiv(self, torch.ones_like(b), **kw))
            return first[0]
        x = ldiv(self, b, **kw).clone()
        i = x.abs().argmax()  # the largest entry's sign flipped
        x.view(-1)[i] = -x.view(-1)[i]
        return x

    monkeypatch.setattr(ParallelSparseLU, "ldiv", broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_step_is_not_correct(tiny_trsm, monkeypatch, fault):
    _break(monkeypatch, fault)
    r = harness.run_cell(tiny_trsm, TINY_CELL, 2 ** 31 + 3, 0.3, False,
                         "cpu", harness.time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0


def _solver(**change):
    import tpu_sparse_lu_torch as tlu

    A = BENCH.module("families", "poisson_2d").build(nx=8, ny=8)
    return tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        **dict(SOLVER, nd_cutoff=32, **change)), device="cpu")


@pytest.mark.parametrize("change", [{"tri_mode": "inv"},
                                    {"dtype": "float32"},
                                    {"tri_mode": "inv_refine"}])
def test_the_entry_refuses_a_solver_off_its_path(change):
    entry = BENCH.module("entries", "ldiv_trsm")
    with pytest.raises(RuntimeError, match="tri_mode 'trsm'"):
        entry.make(_solver(**change))


def test_the_entry_takes_the_deployments_solver():
    import torch

    F = _solver()
    step = BENCH.module("entries", "ldiv_trsm").make(F)
    b = torch.ones((F.n, 2), dtype=torch.float64)
    assert torch.equal(step(None, b), F.ldiv(b))

    class Older:  # a program that cannot say which path it takes
        pass

    with pytest.raises(RuntimeError, match="None"):
        BENCH.module("entries", "ldiv_trsm").make(Older())


def test_the_float64_solve_work_matches_a_hand_count():
    # the cell: nnz(L+U) = 3,374,370 at n = 10,000, R = 16, float64
    w = work.Work(dtype="float64", n=10000, rhs=16, nnz_a=49600,
                  nnz_lu=3374370, elim_flop=0)
    # 8 + 4 bytes a factor entry, b read and x written in float64
    assert w.ldiv_bytes == 12 * 3374370 + 2 * 10000 * 16 * 8 == 43052440
    assert w.ldiv_flop == 2 * 16 * 3374370
    # bytes bound it: 43.05 MB at 3.35 TB/s, 12.85 µs; 108 MFLOP 1.6 µs
    assert w.ldiv_s == pytest.approx(43052440 / 3.35e12)
    assert w.ldiv_s == pytest.approx(12.851e-6, rel=1e-4)
    # from patterns: L unit lower (its diagonal not counted), U upper
    L = sp.csc_matrix(np.array([[1.0, 0, 0], [2, 1, 0], [0, 3, 1]]))
    U = sp.csc_matrix(np.array([[4.0, 5, 0], [0, 6, 0], [0, 0, 7]]))
    got = work.count(sp.identity(3, format="csc"), L, U, 2, "float64")
    assert got.nnz_lu == 2 + 4
    assert got.ldiv_bytes == 12 * 6 + 2 * 3 * 2 * 8


def _work():
    return work.Work(dtype="float64", n=10000, rhs=16, nnz_a=49600,
                     nnz_lu=3374370, elim_flop=0)


def _run(trace=None):
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=2,
                       window_s=1.0, latency_s=np.array([0.1, 0.1]),
                       dispatch_s=np.array([0.01, 0.01]), work=_work(),
                       trace=trace)


def _traced():
    """Two steps of a level-step solve, one level a factor: a perm, a
    diagonal step (a gather, a triangular solve, a scatter), an
    off-diagonal wave, a diagonal step, then the same for U, a perm."""
    perm, wave = "perm_gather_kernel<double>", \
        "wave_apply_kernel<double, double, 16>"
    diag = [("index_elementwise_kernel", 0.001), ("trsm_kernel", 0.004),
            ("index_put_kernel", 0.001)]
    ops, sp_ = [], []
    for t, host in ((0.0, 0.002), (0.5, 0.004)):
        clock = t + 0.01
        seq = [(perm, 0.001)] + diag + [(wave, 0.002)] + diag \
            + diag + [(wave, 0.002)] + diag + [(perm, 0.001)]
        for name, d in seq:
            ops.append((name, clock, clock + d))
            clock += d + 0.001
        sp_ += [("api.ldiv", t, t + 0.2), ("lu.ldiv.rhs", t, t + 0.005),
                ("lu.ldiv.launch", t + 0.005, t + 0.01)]
        s = t + 0.01
        for name in ["lu.ldiv.diag", "lu.ldiv.launch", "lu.ldiv.diag",
                     "lu.ldiv.diag", "lu.ldiv.launch", "lu.ldiv.diag"]:
            d = host if name == "lu.ldiv.diag" else 0.003
            sp_.append((name, s, s + d))
            s += d
        sp_.append(("lu.ldiv.launch", s, s + 0.005))
    return reduce.Trace(window_s=1.0, steps=2, ops=ops, spans=sp_)


def test_the_level_metrics_read_a_synthetic_trace():
    read = {name: BENCH.module("metrics", name).read for name in METRICS}
    run = _run(_traced())
    # a step: 2 perms 2 ms, 2 waves 4 ms, 4 diagonal steps of 6 ms
    assert read["diag_step_ms.trsm"](run) == pytest.approx(24.0)
    assert read["levels_roofline.trsm"](run) == pytest.approx(
        100 * _work().ldiv_s / 30e-3)
    # 4 diagonal spans of 2 ms, then of 4 ms: the median of 8 and 16
    assert read["diag_host_ms.trsm"](run) == pytest.approx(12.0)
    # 2 perms of 5 ms, 2 waves of 3 ms: 16 ms a step
    assert read["ldiv_launch_host_ms.trsm"](run) == pytest.approx(16.0)
    assert read["device_ops.trsm"](run) == 16.0


def test_the_level_metrics_read_none_without_their_operations():
    read = {name: BENCH.module("metrics", name).read for name in METRICS}
    for name in METRICS:  # untraced
        assert read[name](_run()) is None
    # a traced window with neither device operations nor program spans
    bare = reduce.Trace(window_s=1.0, steps=2, ops=[],
                        spans=[("api.ldiv", 0.0, 0.1),
                               ("api.ldiv", 0.5, 0.6)])
    for name in METRICS:
        assert read[name](_run(bare)) is None
    # one launch of the tile solve: no level-step kernel, no diagonal span
    fused = reduce.Trace(window_s=1.0, steps=1,
                         ops=[("ldiv_fused_kernel<double, double, 4>", 0.1,
                               0.2)],
                         spans=[("api.ldiv", 0.05, 0.2),
                                ("lu.ldiv.launch", 0.06, 0.09)])
    for name in ("levels_roofline.trsm", "diag_step_ms.trsm",
                 "diag_host_ms.trsm"):
        assert read[name](_run(fused)) is None
    # the parent's level-step solve: its kernels, no lu.ldiv.diag span
    t = _traced()
    older = reduce.Trace(window_s=t.window_s, steps=t.steps, ops=t.ops,
                         spans=[s for s in t.spans
                                if s[0] != "lu.ldiv.diag"])
    assert read["diag_host_ms.trsm"](_run(older)) is None
    assert read["diag_step_ms.trsm"](_run(older)) == pytest.approx(24.0)
