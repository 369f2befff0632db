"""The readers of the program's registry by side (``h100_bench/untraced.py``
and the metrics that use it) on synthetic registries, each against a hand
count: host ms a step, the part of the dispatch no span covers, what the
profiler adds, host µs a launch, launches a step; the set-up spans read
whole; None without a registry, without sides, or without a step."""

import sys

import numpy as np
import pytest

from h100_bench import harness, untraced, work
from h100_bench.tests.conftest import ROOT
from tpu_sparse_lu_torch import trace as program_trace

BENCH = harness.Bench.load(ROOT)
KINDS = ("solve", "refactor")
STEMS = ("untraced_host_ms", "unspanned_host_ms", "tracing_cost_ms",
         "launch_host_us", "launches")
NEW = tuple(f"{s}.{k}" for s in STEMS for k in KINDS) + (
    "order_s", "plan_s", "repack_s")
POISSON = ("poisson2d_100.solve", "poisson2d_100.refactor_solve",
           "poisson2d_100_f64.solve", "poisson2d_100_trsm_f64.solve")

# two sides of a solve cell's registry: 4 unprofiled steps (set-up, warm-up
# and window), 2 profiled ones; a trsm-like step of a perm, a wave, a
# diagonal step and a perm, 4 launches; the kernel load inside a set-up span
PLAIN = {
    "lu.ldiv.rhs": (4, 0.004, 0),
    "lu.ldiv.launch": (12, 0.024, 12),
    "lu.ldiv.diag": (4, 0.012, 4),
    "lu.setup.device": (1, 0.5, 0),
    "lu.setup.kernels": (1, 0.25, 0),
    "lu.unspanned": (0, 0.0, 2),
}
PROFILED = {
    "lu.ldiv.rhs": (2, 0.004, 0),
    "lu.ldiv.launch": (6, 0.030, 6),
    "lu.ldiv.diag": (2, 0.010, 2),
}
# a refactor cell's: 5 steps, each 2 assembly launches, the elimination,
# the extraction and the solve
REFACTOR = {
    "lu.step.inputs": (5, 0.005, 0),
    "lu.refactor.assemble": (5, 0.010, 10),
    "lu.refactor.eliminate": (5, 0.005, 5),
    "lu.refactor.extract": (5, 0.005, 5),
    "lu.refactor.banks": (5, 0.005, 0),
    "lu.ldiv.launch": (5, 0.010, 5),
    "lu.setup.refactor_plan": (1, 0.3, 2),
}


def _read(name):
    return BENCH.module("metrics", name).read


def _run(dispatch_ms=(10.0, 11.0, 12.0)):
    w = work.Work(dtype="float32", n=100, rhs=2, nnz_a=300, nnz_lu=1000,
                  elim_flop=5000)
    d = np.asarray(dispatch_ms) * 1e-3
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=len(d),
                       window_s=0.3, latency_s=d + 1e-3, dispatch_s=d,
                       work=w)


@pytest.fixture
def sides(monkeypatch):
    """Hand the readers the synthetic sides through the program's own
    ``trace.phases``."""
    got = {False: {}, True: {}}
    monkeypatch.setattr(program_trace, "phases",
                        lambda profiled: dict(got[profiled]))
    return got


def test_the_new_metrics_are_found_and_listed():
    names = {m["name"]: m for m in BENCH.spec["per_layer"]}
    cells = {w["name"] for w in BENCH.spec["workloads"]}
    want = {"solve": {c for c in cells if c.endswith(".solve")},
            "refactor": {c for c in cells if c.endswith(".refactor_solve")}}
    for name in NEW:
        assert callable(_read(name))
        m = names[name]
        assert m["workloads"]
        for cell in m["workloads"]:
            assert name in {x["name"] for x in BENCH.metrics(cell, True)}
        kind = name.split(".")[-1]
        if kind in want:
            assert set(m["workloads"]) == want[kind]
            assert m["moves"] == f"{kind}_step_ms"
        else:
            assert m["moves"] == "setup_s"
            assert set(m["workloads"]) == (set(POISSON) if name == "order_s"
                                           else cells)
    assert len(want["solve"]) == 6 and len(want["refactor"]) == 2


def test_host_time_a_step_by_side(sides):
    sides[False].update(PLAIN)
    sides[True].update(PROFILED)
    # (4 + 24 + 12) ms over 4 steps; set-up and unspanned left out
    assert _read("untraced_host_ms.solve")(_run()) == pytest.approx(10.0)
    # the window's mean dispatch, 11 ms, less it
    assert _read("unspanned_host_ms.solve")(_run()) == pytest.approx(1.0)
    # not clamped
    assert _read("unspanned_host_ms.solve")(_run((8.0,))) == \
        pytest.approx(-2.0)
    # (4 + 30 + 10) ms over 2 profiled steps, less 10
    assert _read("tracing_cost_ms.solve")(_run()) == pytest.approx(12.0)
    # (24 + 12) ms over 16 launches
    assert _read("launch_host_us.solve")(_run()) == pytest.approx(2250.0)
    # (12 + 4 + 2 unspanned) over 4 steps
    assert _read("launches.solve")(_run()) == pytest.approx(4.5)
    # a solve cell has no refactor step
    for stem in STEMS:
        assert _read(f"{stem}.refactor")(_run()) is None


def test_the_refactor_step(sides):
    sides[False].update(REFACTOR)
    assert _read("untraced_host_ms.refactor")(_run()) == pytest.approx(8.0)
    assert _read("unspanned_host_ms.refactor")(_run()) == \
        pytest.approx(3.0)
    # (10 + 5 + 5 + 10) ms over 25 launches
    assert _read("launch_host_us.refactor")(_run()) == pytest.approx(1200.0)
    # 25 launches over 5 steps; the refactor plan's are set-up's
    assert _read("launches.refactor")(_run()) == pytest.approx(5.0)
    # no traced window: nothing profiled to compare
    assert _read("tracing_cost_ms.refactor")(_run()) is None
    for stem in STEMS:
        assert _read(f"{stem}.solve")(_run()) is None


def test_steps_without_launches(sides):
    sides[False].update({"lu.ldiv.rhs": (2, 0.002, 0),
                         "lu.ldiv.launch": (2, 0.004, 0)})
    assert _read("launches.solve")(_run()) == 0.0
    assert _read("launch_host_us.solve")(_run()) is None
    assert _read("untraced_host_ms.solve")(_run()) == pytest.approx(3.0)


def test_nothing_to_read_reads_none(sides, monkeypatch):
    for name in NEW[:-3]:
        assert _read(name)(_run()) is None  # empty sides
    sides[False].update(PLAIN)
    sides[True].update(PROFILED)
    sides[False]["lu.ldiv.rhs"] = (0, 0.0, 0)  # a step span never called
    assert _read("untraced_host_ms.solve")(_run()) is None
    assert _read("unspanned_host_ms.solve")(_run(())) is None
    # a program whose registry keeps no sides (the parent's) or no registry
    monkeypatch.delattr(program_trace, "phases")
    assert untraced.phases(False) is None
    for name in NEW[:-3]:
        assert _read(name)(_run()) is None
    monkeypatch.setitem(sys.modules, "tpu_sparse_lu_torch.trace", None)
    for name in NEW:
        assert _read(name)(_run()) is None


def test_the_real_registry_by_side():
    # the program's own registry, not a synthetic one: two unprofiled
    # steps, one of them launching twice, and one launch under no span
    from torch.profiler import ProfilerActivity, profile

    from tpu_sparse_lu_torch.ops._launch import check

    program_trace.reset()
    try:
        for i in range(2):
            with program_trace.span("lu.ldiv.rhs"):
                pass
            with program_trace.span("lu.ldiv.launch"):
                for _ in range(i + 1):
                    check(0, "k")
        check(0, "k")
        with profile(activities=[ProfilerActivity.CPU]):
            with program_trace.span("lu.ldiv.rhs"):
                pass
            with program_trace.span("lu.ldiv.launch"):
                check(0, "k")
        assert _read("launches.solve")(_run()) == pytest.approx(2.0)
        plain = program_trace.phases(False)
        want = (plain["lu.ldiv.rhs"][1] + plain["lu.ldiv.launch"][1]) / 2
        assert _read("untraced_host_ms.solve")(_run()) == \
            pytest.approx(want * 1e3)
        assert _read("launch_host_us.solve")(_run()) == \
            pytest.approx(plain["lu.ldiv.launch"][1] / 3 * 1e6)
        assert _read("tracing_cost_ms.solve")(_run()) is not None
    finally:
        program_trace.reset()


def test_the_set_up_spans_read_whole():
    program_trace.reset()
    try:
        for name in ("order_s", "plan_s", "repack_s"):
            assert _read(name)(_run()) is None  # nothing recorded
        with program_trace.span("lu.setup.order"):
            pass
        for _ in range(2):  # construction and the refactor plan's re-pack
            with program_trace.span("lu.setup.device"):
                pass
        got = program_trace.totals()
        assert _read("order_s")(_run()) == got["lu.setup.order"][1]
        assert _read("repack_s")(_run()) == got["lu.setup.device"][1]
        assert got["lu.setup.device"][0] == 2
        assert _read("plan_s")(_run()) is None
    finally:
        program_trace.reset()
