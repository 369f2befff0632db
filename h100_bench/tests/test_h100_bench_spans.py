"""The readers of the program's spans (``h100_bench/spans.py`` and the
metrics that use it) on synthetic traces and registries: spans grouped by
step, nested spans, several steps, idle intervals across two spans, and
None where the program has no spans."""

import sys

import numpy as np
import pytest

from h100_bench import harness, reduce, spans, work
from h100_bench.tests.conftest import ROOT
from tpu_sparse_lu_torch import trace as program_trace

BENCH = harness.Bench.load(ROOT)
NEW = ("ldiv_launch_host_ms.solve", "ldiv_launch_host_ms.refactor",
       "extraction_host_ms", "program_idle_share.solve",
       "program_idle_share.refactor", "factorize_s", "refactor_plan_s",
       "kernel_load_s")


def _read(name):
    return BENCH.module("metrics", name).read


def _run(trace=None):
    w = work.Work(dtype="float32", n=100, rhs=2, nnz_a=300, nnz_lu=1000,
                  elim_flop=5000)
    return harness.Run(setup_s=2.0, construct_s=1.0, steps=3,
                       window_s=0.3, latency_s=np.array([0.1] * 3),
                       dispatch_s=np.array([0.01] * 3), work=w, trace=trace)


def _trace(ops, spans_, window_s=1.0, steps=3):
    return reduce.Trace(window_s=window_s, steps=steps, ops=ops,
                        spans=spans_)


@pytest.fixture
def registry():
    program_trace.reset()
    yield program_trace
    program_trace.reset()


def test_the_new_metrics_are_found_and_listed():
    names = {m["name"]: m for m in BENCH.spec["per_layer"]}
    for name in NEW:
        assert callable(_read(name))
        assert names[name]["workloads"]
        for cell in names[name]["workloads"]:
            assert name in {m["name"] for m in BENCH.metrics(cell, True)}


def test_launch_time_is_a_median_over_steps():
    # three steps; the second launches twice (a refinement sweep)
    sp = [("sync", 0.0, 0.05),
          ("api.ldiv", 0.1, 0.2), ("lu.ldiv.rhs", 0.1, 0.11),
          ("lu.ldiv.launch", 0.11, 0.13),
          ("api.ldiv", 0.3, 0.5), ("lu.ldiv.rhs", 0.3, 0.31),
          ("lu.ldiv.launch", 0.31, 0.34), ("lu.ldiv.residual", 0.34, 0.35),
          ("lu.ldiv.launch", 0.35, 0.40),
          ("api.ldiv", 0.6, 0.7), ("lu.ldiv.launch", 0.6, 0.64)]
    run = _run(_trace([], sp))
    assert spans.per_step_s(run.trace, "lu.ldiv.launch") == pytest.approx(
        [0.02, 0.08, 0.04])
    for name in ("ldiv_launch_host_ms.solve", "ldiv_launch_host_ms.refactor"):
        assert _read(name)(run) == pytest.approx(40.0)
    assert _read("extraction_host_ms")(run) is None  # no such span


def test_a_step_without_the_span_counts_zero_and_nesting_is_kept_apart():
    sp = [("api.refactor_solve_step", 0.0, 0.4),
          ("lu.refactor.extract", 0.1, 0.2),
          ("api.refactor_solve_step", 0.5, 0.9),
          ("lu.refactor.assemble", 0.5, 0.6),
          ("api.refactor_solve_step", 1.0, 1.4),
          ("lu.refactor.extract", 1.1, 1.4)]
    run = _run(_trace([], sp, window_s=1.5))
    assert spans.per_step_s(run.trace, "lu.refactor.extract") == \
        pytest.approx([0.1, 0.0, 0.3])
    assert _read("extraction_host_ms")(run) == pytest.approx(100.0)
    # a span outside every step is no step's
    sp.append(("lu.refactor.extract", 0.42, 0.48))
    assert spans.per_step_s(_trace([], sp, 1.5), "lu.refactor.extract") == \
        pytest.approx([0.1, 0.0, 0.3])


def test_idle_time_overlapping_two_spans_and_nested_spans():
    ops = [("k", 0.0, 0.2), ("k", 0.5, 0.6), ("k", 0.55, 0.7)]
    # idle: 0.2-0.5 and 0.7-1.0
    sp = [("api.ldiv", 0.25, 0.65),
          ("lu.ldiv.rhs", 0.25, 0.3), ("lu.ldiv.launch", 0.3, 0.6),
          ("lu.setup.device", 0.8, 0.9), ("lu.setup.kernels", 0.82, 0.85)]
    run = _run(_trace(ops, sp))
    t = run.trace
    assert spans.idle_intervals(t) == pytest.approx([(0.2, 0.5),
                                                     (0.7, 1.0)])
    # 0.25-0.5 across rhs and launch, 0.8-0.9 once though nested
    assert spans.program_idle_s(t) == pytest.approx(0.35)
    for name in ("program_idle_share.solve", "program_idle_share.refactor"):
        assert _read(name)(run) == pytest.approx(35.0)
    # the device's idle share counts all of it, the program's only its own
    assert _read("device_idle_share.solve")(run) == pytest.approx(60.0)


def test_interval_helpers():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (2, 2)]) == [(0, 2),
                                                               (3, 4)]
    assert spans.overlap_s([(0, 1), (2, 3)], [(0.5, 2.5)]) == \
        pytest.approx(1.0)
    assert spans.overlap_s([], [(0, 1)]) == 0.0
    busy = _trace([("k", 0.0, 1.0)], [])
    assert spans.idle_intervals(busy) == []


def test_no_spans_read_none():
    run = _run(_trace([("k", 0.0, 0.5)], [("api.ldiv", 0.0, 0.4),
                                           ("sync", 0.4, 0.5)]))
    for name in ("ldiv_launch_host_ms.solve", "extraction_host_ms",
                 "program_idle_share.solve"):
        assert _read(name)(run) is None
        assert _read(name)(_run()) is None  # an untraced run


def test_the_registry_readers(registry):
    for name in ("factorize_s", "refactor_plan_s", "kernel_load_s"):
        assert _read(name)(_run()) is None  # nothing recorded
    with registry.span("lu.setup.kernels"):
        with registry.span("lu.setup.kernel_build"):
            pass
    with registry.span("lu.setup.factorize"):
        pass
    got = registry.totals()
    assert _read("kernel_load_s")(_run()) == got["lu.setup.kernels"][1]
    assert _read("factorize_s")(_run()) == got["lu.setup.factorize"][1]
    assert _read("refactor_plan_s")(_run()) is None


def test_a_program_without_spans_reads_none(monkeypatch, registry):
    with registry.span("lu.setup.factorize"):
        pass
    monkeypatch.setitem(sys.modules, "tpu_sparse_lu_torch.trace", None)
    assert spans.registry() is None
    for name in ("factorize_s", "refactor_plan_s", "kernel_load_s"):
        assert _read(name)(_run()) is None
