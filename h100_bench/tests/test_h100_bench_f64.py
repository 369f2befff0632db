"""The float64 deployment's files: on the CPU the cell's registration, a
run of a small copy of ``poisson2d_100_f64.solve`` (``poisson_2d(20, 20)``,
``chunk_size`` 16), the float32 control, three faults broken into
``make_f64_ldiv`` and the step without refinement failing it, the
refinement's work against a hand count, and the four metrics of the f64
refinement on synthetic traces; on a card (``card``) the control failing
the cell at its own size and the program passing it.

The small copy is made here, in a temporary folder searched before the
benchmark's own, with the real cell's traffic and limits."""

import copy
import json

import numpy as np
import pytest

from h100_bench import harness, readings, reduce, refine_work, work
from h100_bench.tests.conftest import ROOT

BENCH = harness.Bench.load(ROOT)
CELL = "poisson2d_100_f64.solve"
TINY_CELL = "tiny_poisson_f64.solve"
TINY = {"name": "tiny_poisson_f64", "family": "poisson_2d",
        "matrix": {"nx": 20, "ny": 20},
        "solver": {"chunk_size": 16, "ordering": "nd", "nd_cutoff": 64,
                   "dtype": "float32"},
        "reference": "dense_f64", "control": "f32_control"}
SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 12345]
METRICS = ("refine_ms.f64", "refine_roofline.f64", "residual_host_ms.f64",
           "ldiv_launches.f64")


@pytest.fixture
def tiny_f64(tmp_path):
    """The benchmark with ``tiny_poisson_f64.solve``: the f64 cell on a
    small copy of its deployment, reporting what the cell reports, judged
    by the cell's own limits."""
    spec = copy.deepcopy(BENCH.spec)
    for kind in ("configs", "limits"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "tiny_poisson_f64.json").write_text(
        json.dumps(TINY))
    (tmp_path / "limits" / f"{TINY_CELL}.json").write_text(json.dumps(
        BENCH.data("limits", CELL)))
    spec["workloads"].append(dict(BENCH.cell(CELL), name=TINY_CELL,
                                  config="tiny_poisson_f64"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    return harness.Bench(spec, dirs=[tmp_path, harness.HERE])


def test_the_cell_is_registered():
    cfg = BENCH.data("configs", "poisson2d_100_f64")
    assert cfg["matrix"] == {"nx": 100, "ny": 100} and cfg["reduced"] == []
    # the same solver as poisson2d_100, judged by the same reference
    base = BENCH.data("configs", "poisson2d_100")
    assert cfg["solver"] == base["solver"]
    assert (cfg["reference"], cfg["control"]) == ("dense_f64", "f32_control")
    traffic = BENCH.data("traffic", BENCH.cell(CELL)["traffic"])
    assert traffic["entry"] == "f64_ldiv" and traffic["rhs"] == 16
    assert traffic["value_ring"] == 0
    entry = BENCH.module("entries", "f64_ldiv")
    assert entry.SPAN == "api.f64_ldiv" and entry.REFINE_STEPS == 2
    assert BENCH.data("limits", CELL)["fwd_err"] == 1e-12
    assert BENCH.cell(CELL)["chips"] == 1
    e2e = {m["name"] for m in BENCH.metrics(CELL, False)}
    assert e2e == {"solve_step_ms", "solve_step_p95_ms", "setup_s"}
    layer = {m["name"] for m in BENCH.metrics(CELL, True)}
    assert set(METRICS) | {
        "ldiv_fused_roofline.solve", "ldiv_launch_host_ms.solve",
        "host_dispatch_ms.solve", "device_idle_share.solve",
        "program_idle_share.solve", "factorize_s", "kernel_load_s",
        "construct_s"} <= layer
    assert not layer & {"bidiag_roofline.solve", "chain_launch_host_ms.solve"}
    for name in METRICS:
        m = next(m for m in BENCH.spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["layer"] == "f64 refinement"
        assert m["moves"] == "solve_step_ms"


def test_a_run_of_the_small_copy_on_the_cpu(tiny_f64):
    r = harness.run_cell(tiny_f64, TINY_CELL, 2 ** 31 + 11, 0.3, False,
                         "cpu", harness.time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 tiny_f64.metrics(TINY_CELL, False)}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def _control_fails_and_program_passes(bench, cell, device, seconds):
    got = readings.readings(bench, cell, SEEDS, len(SEEDS), seconds, device)
    limits = bench.data("limits", cell)

    def fails(r):
        return any(not r[k] <= lim for k, lim in limits.items())

    assert not any(fails(r) for r in got["program"]), got["program"]
    assert all(fails(r) for r in got["control"]), got["control"]


def test_the_control_fails_the_small_copy(tiny_f64):
    _control_fails_and_program_passes(tiny_f64, TINY_CELL, "cpu", 0.2)


@pytest.mark.card
def test_the_control_fails_the_cell_on_the_card(card):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    _control_fails_and_program_passes(BENCH, CELL, "cuda", 1.0)


def _break(monkeypatch, fault):
    """Break ``make_f64_ldiv``'s solves underneath the harness."""
    import torch

    from tpu_sparse_lu_torch.api import ParallelSparseLU

    make = ParallelSparseLU.make_f64_ldiv

    def broken_make(self, **kw):
        solve = make(self, **kw)
        first = []

        def broken(b):
            if fault == "unchanged":
                # one stale answer handed back, that of a step the ring
                # never takes (its first step is also the window's first)
                if not first:
                    first.append(solve(torch.ones_like(b)))
                return first[0]
            x = solve(b).clone()
            if fault == "half_batch":  # half the columns, their mean
                h = x.shape[1] // 2
                x[:, h:] = x[:, :h].mean(dim=1, keepdim=True)
            elif fault == "altered":  # the largest entry's sign flipped
                i = x.abs().argmax()
                x.view(-1)[i] = -x.view(-1)[i]
            return x

        return broken

    monkeypatch.setattr(ParallelSparseLU, "make_f64_ldiv", broken_make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_step_is_not_correct(tiny_f64, monkeypatch, fault):
    _break(monkeypatch, fault)
    r = harness.run_cell(tiny_f64, TINY_CELL, 2 ** 31 + 3, 0.3, False, "cpu",
                         harness.time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0


def test_the_step_without_refinement_is_not_correct(tiny_f64, tmp_path):
    # the entry's own file with no sweep, found before the benchmark's
    entry = (harness.HERE / "entries" / "f64_ldiv.py").read_text()
    assert "REFINE_STEPS = 2\n" in entry
    (tmp_path / "entries").mkdir()
    (tmp_path / "entries" / "f64_ldiv.py").write_text(
        entry.replace("REFINE_STEPS = 2\n", "REFINE_STEPS = 0\n"))
    assert tiny_f64.module("entries", "f64_ldiv").REFINE_STEPS == 0
    r = harness.run_cell(tiny_f64, TINY_CELL, 2 ** 31 + 5, 0.3, False, "cpu",
                         harness.time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["fwd_err"]["value"] > 1e-9


def _work(n=10000, rhs=16, nnz_a=49600):
    return work.Work(dtype="float32", n=n, rhs=rhs, nnz_a=nnz_a,
                     nnz_lu=3374370, elim_flop=0)


def test_refine_work_matches_a_hand_count():
    # the cell: n = 10,000, R = 16, nnz(A) = 49,600 (5 a row less the
    # border's 400), two sweeps
    A = BENCH.module("families", "poisson_2d").build(nx=100, ny=100)
    assert A.nnz == 49600
    w = refine_work.count(_work(), 2)
    # a sweep: 8 + 4 bytes an entry of A, 10,001 row pointers, 40 bytes an
    # entry of the panel
    assert w.bytes == 2 * (12 * 49600 + 4 * 10001 + 40 * 10000 * 16)
    assert w.bytes == 14070408
    assert w.flop == 2 * (2 * 49600 * 16 + 3 * 10000 * 16)
    # bytes bound it: 14.07 MB at 3.35 TB/s
    assert w.least_s == pytest.approx(14070408 / 3.35e12)
    assert w.least_s == pytest.approx(4.2001e-6, rel=1e-4)
    assert refine_work.count(_work(n=3, rhs=2, nnz_a=7), 1).bytes == \
        12 * 7 + 4 * 4 + 40 * 3 * 2
    assert refine_work.count(_work(), 0).least_s == 0.0


def _run(trace=None):
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=2,
                       window_s=1.0, latency_s=np.array([0.1, 0.1]),
                       dispatch_s=np.array([0.01, 0.01]), work=_work(),
                       trace=trace)


def _traced():
    solve = "ldiv_fused_kernel<float, float, 4>"
    ops, sp_ = [], []
    for t, w in ((0.0, 0.002), (0.5, 0.004)):  # two steps, 0.5 s apart
        ops += [("elementwise_kernel", t + 0.010, t + 0.011),  # b to f64
                (solve, t + 0.020, t + 0.030),
                ("csrMvN_kernel", t + 0.040, t + 0.045),
                (solve, t + 0.050, t + 0.060),
                ("csrMvN_kernel", t + 0.070, t + 0.075),
                (solve, t + 0.080, t + 0.090)]
        sp_ += [("api.f64_ldiv", t, t + 0.1),
                ("lu.ldiv.rhs", t, t + 0.01),
                ("lu.ldiv.launch", t + 0.015, t + 0.02),
                ("lu.ldiv.residual", t + 0.035, t + 0.04),
                ("lu.ldiv.launch", t + 0.045, t + 0.05),
                ("lu.ldiv.residual", t + 0.06, t + 0.06 + w),
                ("lu.ldiv.residual", t + 0.065, t + 0.07),
                ("lu.ldiv.launch", t + 0.075, t + 0.08),
                ("lu.ldiv.residual", t + 0.09, t + 0.095)]
    return reduce.Trace(window_s=1.0, steps=2, ops=ops, spans=sp_)


def test_the_f64_metrics_read_a_synthetic_trace():
    read = {name: BENCH.module("metrics", name).read for name in METRICS}
    run = _run(_traced())
    # 11 ms a step of operations other than the solve's kernel
    assert read["refine_ms.f64"](run) == pytest.approx(11.0)
    assert read["refine_roofline.f64"](run) == pytest.approx(
        100 * refine_work.count(run.work, 2).least_s / 11e-3)
    # residual spans 5 + 2 + 5 + 5 ms, then 5 + 4 + 5 + 5 ms: median 18
    assert read["residual_host_ms.f64"](run) == pytest.approx(18.0)
    assert read["ldiv_launches.f64"](run) == 3.0


def test_the_f64_metrics_read_none_without_their_operations():
    read = {name: BENCH.module("metrics", name).read for name in METRICS}
    for name in METRICS:  # untraced
        assert read[name](_run()) is None
    # a traced window with neither device operations nor program spans
    bare = reduce.Trace(window_s=1.0, steps=2, ops=[],
                        spans=[("api.f64_ldiv", 0.0, 0.1),
                               ("api.f64_ldiv", 0.5, 0.6)])
    for name in METRICS:
        assert read[name](_run(bare)) is None
    # a chain solve's window: no ldiv_fused launch, no residual span
    chain = reduce.Trace(window_s=1.0, steps=1,
                         ops=[("bidiag_kernel<float>", 0.1, 0.2)],
                         spans=[("api.ldiv", 0.05, 0.2),
                                ("lu.ldiv.chain", 0.06, 0.09)])
    assert read["ldiv_launches.f64"](_run(chain)) is None
    assert read["residual_host_ms.f64"](_run(chain)) is None
