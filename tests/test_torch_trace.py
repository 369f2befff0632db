"""The port's host spans (``tpu_sparse_lu_torch/trace.py``) on the CPU.

* Without a profiler a span opens no profiler range and counts
  its calls and host seconds; ``reset`` empties the registry.
* Under ``torch.profiler``, ``ldiv`` and the refactor-solve step emit their
  spans as ``user_annotation`` events, one after another, none inside
  another, on a small Poisson (nd) and a small block-banded deployment.
* Construction fills the set-up spans; the first load of the kernel
  library fills ``lu.setup.kernels``, and ``lu.setup.kernel_build`` only
  when it compiles.
* The answers are bitwise the same with and without a profiler.
* The registry keeps the calls made under a profiler apart from the others
  (``phases``); ``totals`` sums both, with the value it always had. A
  launch (``ops/_launch.check``) counts in the open spans of its thread,
  the innermost and every one around it, or under ``lu.unspanned``; a
  failed one raises and counts nothing. ``ldiv``, a ``make_f64_ldiv``
  solve and the refactor-solve step open their step span once a call.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch import trace
from tpu_sparse_lu_torch.models import block_banded, poisson_2d
from tpu_sparse_lu_torch.ops import _build

CASES = {
    "poisson_nd": (lambda: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd", nd_cutoff=32,
                        dtype="float32")),
    "banded": (lambda: block_banded(np.random.default_rng(0), 12, 6),
               dict(chunk_size=16, ordering="colamd", dtype="float32")),
}
SOLVE = ["lu.ldiv.rhs", "lu.ldiv.launch"]
STEP = ["lu.step.inputs", "lu.refactor.assemble", "lu.refactor.eliminate",
        "lu.refactor.extract", "lu.refactor.banks", "lu.ldiv.launch"]
RESIDUAL = "lu.ldiv.residual"


@pytest.fixture(autouse=True)
def _empty_registry():
    trace.reset()
    yield
    trace.reset()


def _solver(case, refactor=True):
    make, cfg = CASES[case]
    A = make().tocsc()
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg), device="cpu")
    if refactor:
        F.enable_device_refactor()
    return A, F


def _inputs(A, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = torch.randn((A.shape[0], 3), generator=g)
    a = torch.as_tensor(A.data, dtype=torch.float32) * (
        1.0 + 0.05 * torch.randn(A.data.shape[0], generator=g))
    return a, b


def _profiled(tmp_path, fn):
    """``fn()`` under the profiler: (its result, the ``lu.`` spans as
    (name, start, end) in µs, in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("lu.")]
    return out, sorted(spans, key=lambda s: s[1])


def _flat(spans):
    """No span starts before the one before it has ended."""
    return all(s1 >= e0 for (_, _, e0), (_, s1, _) in zip(spans, spans[1:]))


def test_span_counts_without_a_profiler(monkeypatch):
    def refuse(*args):
        raise AssertionError(f"a range {args!r} opened without a profiler")

    monkeypatch.setattr(trace, "_range_enter", refuse)
    monkeypatch.setattr(trace, "_range_exit", refuse)
    for _ in range(3):
        with trace.span("lu.test.a"):
            time.sleep(0.002)
    with trace.span("lu.test.b"):
        pass
    got = trace.totals()
    assert set(got) == {"lu.test.a", "lu.test.b"}
    calls, seconds = got["lu.test.a"]
    assert calls == 3 and 0.006 <= seconds < 1.0
    assert got["lu.test.b"][0] == 1 and got["lu.test.b"][1] >= 0.0


def test_a_span_that_raises_is_counted_and_the_error_passes():
    with pytest.raises(ValueError, match="inside"):
        with trace.span("lu.test.raises"):
            raise ValueError("inside")
    assert trace.totals()["lu.test.raises"][0] == 1


def test_reset_empties_the_registry_and_totals_is_a_copy():
    with trace.span("lu.test.a"):
        pass
    got = trace.totals()
    got["lu.test.a"] = (99, 99.0)
    assert trace.totals()["lu.test.a"][0] == 1
    trace.reset()
    assert trace.totals() == {}


def test_a_range_is_opened_only_while_a_profiler_records(tmp_path):
    def spans():
        with trace.span("lu.test.outer"):
            with trace.span("lu.test.inner"):
                pass
        return None

    spans()  # not recorded: no profiler
    _, seen = _profiled(tmp_path, spans)
    assert [n for n, _, _ in seen] == ["lu.test.outer", "lu.test.inner"]
    assert trace.totals()["lu.test.inner"][0] == 2


@pytest.mark.parametrize("refine_steps", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ldiv_emits_flat_spans_under_the_profiler(tmp_path, case,
                                                  refine_steps):
    A, F = _solver(case, refactor=False)
    _, b = _inputs(A)
    trace.reset()
    _, spans = _profiled(tmp_path,
                         lambda: F.ldiv(b, refine_steps=refine_steps))
    names = [n for n, _, _ in spans]
    want = SOLVE + [RESIDUAL, "lu.ldiv.launch", RESIDUAL] * refine_steps
    assert names == want
    assert _flat(spans)
    got = trace.totals()
    assert got["lu.ldiv.launch"][0] == 1 + refine_steps
    assert got["lu.ldiv.rhs"][0] == 1


@pytest.mark.parametrize("refine_steps", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_refactor_step_emits_flat_spans_under_the_profiler(
        tmp_path, case, refine_steps):
    A, F = _solver(case)
    step = F.make_refactor_solve_step(refine_steps=refine_steps)
    a, b = _inputs(A)
    trace.reset()
    _, spans = _profiled(tmp_path, lambda: step(a, b))
    names = [n for n, _, _ in spans]
    want = STEP + [RESIDUAL, "lu.ldiv.launch", RESIDUAL] * refine_steps
    assert names == want
    assert _flat(spans)
    assert set(trace.totals()) == set(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_construction_fills_the_set_up_spans(case):
    _, F = _solver(case, refactor=False)
    got = trace.totals()
    want = {"lu.setup.factorize", "lu.setup.plan", "lu.setup.device"}
    if case == "poisson_nd":
        want.add("lu.setup.order")
    assert set(got) == want
    assert all(calls == 1 and seconds > 0.0
               for calls, seconds in got.values())
    F.enable_device_refactor()
    got = trace.totals()
    assert got["lu.setup.refactor_plan"][0] == 1
    # the refactor plan re-packs the factors onto the closure's tiles
    assert got["lu.setup.device"][0] == 2
    F.enable_device_refactor()  # built once: no second span
    assert trace.totals()["lu.setup.refactor_plan"][0] == 1


def test_the_first_kernel_load_is_a_span_and_a_build_only_when_it_compiles(
        monkeypatch, tmp_path):
    built = []

    def compile_(srcs, so):
        built.append(so)
        so.parent.mkdir(parents=True, exist_ok=True)
        so.write_bytes(b"")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_bind", lambda lib: lib)
    _build.load()
    _build.load()  # loaded: no span
    got = trace.totals()
    assert len(built) == 1
    assert got["lu.setup.kernels"][0] == 1
    assert got["lu.setup.kernel_build"][0] == 1
    assert got["lu.setup.kernels"][1] >= got["lu.setup.kernel_build"][1]
    trace.reset()
    monkeypatch.setattr(_build, "_lib", None)  # a new process, built
    _build.load()
    assert set(trace.totals()) == {"lu.setup.kernels"}
    assert len(built) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_are_bitwise_the_same_under_the_profiler(tmp_path, case):
    A, F = _solver(case)
    step = F.make_refactor_solve_step(refine_steps=1)
    a, b = _inputs(A, seed=1)
    x0, y0 = F.ldiv(b, refine_steps=1), step(a, b)
    (x1, y1), _ = _profiled(tmp_path,
                            lambda: (F.ldiv(b, refine_steps=1), step(a, b)))
    assert torch.equal(x0, x1) and torch.equal(y0, y1)
    assert torch.isfinite(x0).all() and torch.isfinite(y0).all()


def test_spans_in_many_threads_lose_no_call():
    import sys
    import threading

    n_threads, n = 16, 2000
    done = []

    def work():
        for _ in range(n):
            with trace.span("lu.test.threads"):
                pass
        done.append(True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(done) == n_threads
    assert trace.totals()["lu.test.threads"][0] == n_threads * n


# --- the two sides of the registry, and the launches of each span ---------


class _Clock:
    """A stand-in for ``perf_counter_ns``: each read 1,000 ns after the
    one before."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1000
        return self.t


def _sequence():
    """A fixed sequence of spans: nested, repeated and one that raises."""
    for _ in range(3):
        with trace.span("lu.test.a"):
            pass
    with trace.span("lu.test.outer"):
        with trace.span("lu.test.inner"):
            pass
    with pytest.raises(KeyError):
        with trace.span("lu.test.b"):
            raise KeyError("b")


def test_spans_under_the_profiler_land_on_the_profiled_side_only():
    with trace.span("lu.test.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("lu.test.a"):
                pass
        with trace.span("lu.test.b"):
            pass
    with trace.span("lu.test.c"):
        pass
    plain, profiled = trace.phases(False), trace.phases(True)
    assert {k: v[0] for k, v in plain.items()} == {"lu.test.a": 1,
                                                   "lu.test.c": 1}
    assert {k: v[0] for k, v in profiled.items()} == {"lu.test.a": 2,
                                                      "lu.test.b": 1}
    got = trace.totals()
    assert got["lu.test.a"][0] == 3
    assert got["lu.test.a"][1] == pytest.approx(
        plain["lu.test.a"][1] + profiled["lu.test.a"][1])
    trace.reset()
    assert trace.phases(False) == trace.phases(True) == trace.totals() == {}


@pytest.mark.parametrize("profiled", [False, True])
def test_totals_keeps_its_value_for_a_fixed_sequence(monkeypatch, profiled):
    # calls and seconds of every span over both sides, as before the split:
    # each span reads the clock twice, 1 µs apart, nested ones included
    monkeypatch.setattr(trace, "perf_counter_ns", _Clock())
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            _sequence()
    else:
        _sequence()
    want = {"lu.test.a": (3, 3e-6), "lu.test.outer": (1, 3e-6),
            "lu.test.inner": (1, 1e-6), "lu.test.b": (1, 1e-6)}
    got = trace.totals()
    assert set(got) == set(want)
    for name, (calls, seconds) in want.items():
        assert type(got[name]) is tuple and len(got[name]) == 2
        assert got[name][0] == calls
        assert got[name][1] == pytest.approx(seconds, rel=1e-12)
    assert set(trace.phases(profiled)) == set(want)
    assert trace.phases(not profiled) == {}


def test_a_launch_counts_in_the_open_spans_and_else_as_unspanned():
    from tpu_sparse_lu_torch.ops._launch import check

    with trace.span("lu.setup.outer"):
        check(0, "k")
        with trace.span("lu.setup.inner"):
            check(0, "k")
            check(0, "k")
        with trace.span("lu.test.none"):
            pass
    with trace.span("lu.ldiv.launch"):
        check(0, "k")
    check(0, "k")
    check(0, "k")
    got = trace.phases(False)
    launches = {k: v[2] for k, v in got.items()}
    # the innermost span counts its own; a set-up span counts its whole
    assert launches == {"lu.setup.outer": 3, "lu.setup.inner": 2,
                        "lu.test.none": 0, "lu.ldiv.launch": 1,
                        trace.UNSPANNED: 2}
    assert got[trace.UNSPANNED][:2] == (0, 0.0)
    # not a span: totals leaves it out
    assert trace.UNSPANNED not in trace.totals()
    with profile(activities=[ProfilerActivity.CPU]):
        check(0, "k")
        with trace.span("lu.ldiv.launch"):
            check(0, "k")
    profiled = trace.phases(True)
    assert profiled[trace.UNSPANNED][2] == 1
    assert profiled["lu.ldiv.launch"][2] == 1
    assert trace.phases(False)["lu.ldiv.launch"][2] == 1


def test_a_failed_launch_raises_and_counts_nothing(monkeypatch):
    from tpu_sparse_lu_torch.ops import _launch

    class _Lib:
        @staticmethod
        def ldiv_error_string(rc):
            return b"an error"

    monkeypatch.setattr(_launch, "lib", lambda: _Lib)
    with trace.span("lu.ldiv.launch"):
        with pytest.raises(RuntimeError, match=r"k launch failed: an error "
                                               r"\(cudaError 2\)"):
            _launch.check(2, "k")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _launch.check(700, "k")
    got = trace.phases(False)
    assert got == {"lu.ldiv.launch": (1, got["lu.ldiv.launch"][1], 0)}


def test_launches_in_many_threads_stay_in_their_threads_spans():
    import sys
    import threading

    from tpu_sparse_lu_torch.ops._launch import check

    n_threads, n = 16, 500
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=60)
        for _ in range(n):
            with trace.span(f"lu.test.t{i % 2}"):
                for _ in range(i % 2 + 1):
                    check(0, "k")
            if i == 0:
                check(0, "k")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = trace.phases(False)
    half = n_threads // 2
    # a thread's launches land in its own spans, whatever ran between
    assert got["lu.test.t0"][0] == got["lu.test.t1"][0] == half * n
    assert got["lu.test.t0"][2] == half * n
    assert got["lu.test.t1"][2] == 2 * half * n
    assert got[trace.UNSPANNED][2] == n


def _f64_solver():
    A = poisson_2d(12, 12).tocsc()
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", nd_cutoff=32, dtype="float32"),
        device="cpu")
    return A, F


@pytest.mark.parametrize("refine_steps", [0, 2])
@pytest.mark.parametrize("entry", ["ldiv", "refactor_step", "f64_ldiv"])
def test_each_entry_opens_its_step_span_once_a_call(entry, refine_steps):
    # the span a reader of the registry counts steps by: ``lu.ldiv.rhs``
    # for ldiv and a make_f64_ldiv solve, ``lu.step.inputs`` for the step
    if entry == "refactor_step":
        A, F = _solver("banded")
        call = F.make_refactor_solve_step(refine_steps=refine_steps)
        name = "lu.step.inputs"
    else:
        A, F = _f64_solver()
        call = (F.make_f64_ldiv(refine_steps=refine_steps)
                if entry == "f64_ldiv" else
                (lambda a, b: F.ldiv(b, refine_steps=refine_steps)))
        if entry == "f64_ldiv":
            call = (lambda solve: lambda a, b: solve(b))(call)
        name = "lu.ldiv.rhs"
    a, b = _inputs(A)
    trace.reset()
    for i in range(3):
        call(a, b)
        got = trace.phases(False)
        assert got[name][0] == i + 1
        other = {"lu.ldiv.rhs", "lu.step.inputs"} - {name}
        assert not other & set(got)
    # no kernel launches on the CPU: every count is 0, none unspanned
    assert all(n == 0 for _, _, n in got.values())
    assert trace.UNSPANNED not in got
