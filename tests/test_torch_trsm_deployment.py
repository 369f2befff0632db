"""The float64 substitution deployment (BASELINE config 4's settings,
``dtype="float64"``, ``tri_mode="trsm"``) through ``ParallelSparseLU.ldiv``
on the CPU, at a small copy: ``poisson_2d(20, 20)``, nested dissection,
``chunk_size=16``, ``nd_cutoff=64``, R = 1 and 16.

* ``F.ldiv`` reaches SharedMemSparseLU.jl's float64 bar, ``tol = 1e-12``
  relative (``test/runtests.jl:25``), against the benchmark's float64
  reference (``h100_bench/reference/dense_f64.py``); the float32 control
  (``h100_bench/reference/f32_control.py``) misses it.
* Under ``torch.profiler`` a call emits ``lu.ldiv.rhs``, then the
  level-step solve: ``lu.ldiv.launch`` for each perm and each off-diagonal
  wave, ``lu.ldiv.diag`` for each diagonal step, in the order of the two
  factors' waves, flat.
* The registry's unprofiled calls of ``lu.ldiv.diag`` (``trace.phases``)
  grow by the diagonal waves of both factors a solve, and count no launch
  on the CPU.
* An ``"inv"`` solver on the same matrix emits the spans it always did:
  ``lu.ldiv.rhs`` and one ``lu.ldiv.launch``, no ``lu.ldiv.diag``.
* On the CPU each diagonal step (``diag_trsm``) takes its plain route: the
  bits of ``torch.linalg.solve_triangular(data.diag[ids], xw[ids],
  upper=not lower)`` scattered back, level by level and over a whole
  solve, with no launch counted; ``plain=True`` gives the same bits.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch import trace
from tpu_sparse_lu_torch.models import poisson_2d
from tpu_sparse_lu_torch.ops.fused_ldiv import (
    diag_trsm, diag_trsm_plain, wave_apply_plain,
)
from tpu_sparse_lu_torch.solve import blocked_tri_solve, block_rhs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.reference import dense_f64, f32_control  # noqa: E402

# the users' bar: SharedMemSparseLU.jl holds its sparse solves to a relative
# error of 1e-12 (test/runtests.jl:25); float64 substitution reads ~1e-15
# here, a float32 solve ~1e-7 to 1e-6
TOL = 1e-12
CONFIG = dict(chunk_size=16, ordering="nd", nd_cutoff=64, dtype="float64",
              tri_mode="trsm")
RHS = [1, 16]
LAUNCH, DIAG = "lu.ldiv.launch", "lu.ldiv.diag"


@pytest.fixture(scope="module")
def deployment():
    A = poisson_2d(20, 20).tocsc()
    A.sort_indices()
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**CONFIG),
                             device="cpu")
    return A, F


@pytest.fixture(autouse=True)
def _empty_registry():
    trace.reset()
    yield
    trace.reset()


def _rhs(n, R):
    # drawn in float64, the solver's dtype, as the benchmark's ring is
    g = torch.Generator().manual_seed(2 ** 31 + 977 * R)
    return torch.randn((n, R), generator=g, dtype=torch.float64)


def _fwd(A, X, B):
    return dense_f64.forward_errors(np.asarray(X, dtype=np.float64),
                                    dense_f64.solve(A, B, "cpu"))


def _waves(F):
    """The names of a solve's spans after ``lu.ldiv.rhs``, from the two
    factors' wave lists: a perm, each wave, a perm."""
    N = F._numeric
    waves = N.ldata.waves + N.udata.waves
    return [LAUNCH] + [LAUNCH if w.accumulate else DIAG
                       for w in waves] + [LAUNCH]


def _spans(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("lu.")),
                  key=lambda s: s[1])


def test_the_deployment_runs_the_level_step_solve(deployment):
    _, F = deployment
    assert F.config.tri_mode == "trsm" and F.dtype == torch.float64
    assert F.solve_path == "tiles" and F._numeric.sched is None
    N = F._numeric
    for data in (N.ldata, N.udata):
        kinds = [w.accumulate for w in data.waves]
        # each level a diagonal step, all but the last an off-diagonal wave
        assert kinds.count(False) >= 2 and kinds[0] is False
        assert kinds.count(True) == kinds.count(False) - 1


@pytest.mark.parametrize("R", RHS)
def test_ldiv_meets_the_users_bar(deployment, R):
    A, F = deployment
    b = _rhs(F.n, R)
    x = F.ldiv(b)
    assert x.dtype == torch.float64 and x.shape == (F.n, R)
    fwd = _fwd(A, x.numpy(), b.numpy())
    assert np.all(fwd <= TOL), fwd


@pytest.mark.parametrize("R", RHS)
def test_the_float32_control_misses_the_users_bar(deployment, R):
    A, F = deployment
    b = _rhs(F.n, R).numpy()
    control = _fwd(A, f32_control.solve(A, b, "cpu"), b)
    assert np.all(control > 100 * TOL), control


@pytest.mark.parametrize("R", RHS)
def test_a_call_emits_launch_and_diag_spans_flat(deployment, tmp_path, R):
    _, F = deployment
    b = _rhs(F.n, R)
    F.ldiv(b)  # warm
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        F.ldiv(b)
    spans = _spans(prof, tmp_path)
    names = [n for n, _, _ in spans]
    want = ["lu.ldiv.rhs"] + _waves(F)
    assert names == want
    # the two kinds alternate but where one factor's last diagonal step
    # meets the other's first
    assert all(a != b or a == DIAG for a, b in zip(names[1:], names[2:]))
    # flat: no span starts before the one before it has ended
    assert all(s1 >= e0 for (_, _, e0), (_, s1, _) in zip(spans, spans[1:]))
    got = {k: c for k, (c, _) in trace.totals().items()}
    assert got == {"lu.ldiv.rhs": 1, LAUNCH: want.count(LAUNCH),
                   DIAG: want.count(DIAG)}


@pytest.mark.parametrize("R", RHS)
def test_diag_steps_count_the_diagonal_waves(deployment, R):
    _, F = deployment
    N = F._numeric
    diag = sum(1 for w in N.ldata.waves + N.udata.waves if not w.accumulate)
    b = _rhs(F.n, R)
    F.ldiv(b)
    assert trace.phases(False)[DIAG][0] == diag
    F.ldiv(b)
    assert trace.phases(False)[DIAG] == (2 * diag, pytest.approx(
        trace.totals()[DIAG][1]), 0)
    assert trace.totals()[DIAG][0] == 2 * diag
    assert DIAG not in trace.phases(True)


def test_the_spans_leave_the_answer_alone(deployment):
    # the same bits with and without a profiler
    _, F = deployment
    b = _rhs(F.n, 16)
    x = F.ldiv(b)
    with profile(activities=[ProfilerActivity.CPU]):
        y = F.ldiv(b)
    assert torch.equal(x, y)


def test_an_inv_solver_keeps_its_spans(deployment, tmp_path):
    A, _ = deployment
    G = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        **dict(CONFIG, tri_mode="inv")), device="cpu")
    b = _rhs(G.n, 16)
    G.ldiv(b)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.ldiv(b)
        G._numeric.tiles(b, plain=True)
    assert [n for n, _, _ in _spans(prof, tmp_path)] == [
        "lu.ldiv.rhs", LAUNCH, LAUNCH]
    assert DIAG not in trace.phases(True)
    assert DIAG not in trace.phases(False)
    assert DIAG not in trace.totals()


def _bits(t):
    return t.view(torch.int64)


def _diag_steps(F):
    N = F._numeric
    return [(data, w) for data in (N.ldata, N.udata) for w in data.waves
            if not w.accumulate]


def _blocked(F, R):
    b = _rhs(F.n_factor, R)
    return block_rhs(b, F.n_factor, F.plan.lplan.K, F.plan.cs)


@pytest.mark.parametrize("R", RHS)
def test_each_diagonal_step_gives_the_solve_triangular_bits(deployment, R):
    _, F = deployment
    xw = _blocked(F, R)
    before = diag_trsm.LAUNCHES
    for data, w in _diag_steps(F):
        ids = w.dst_long
        want = xw.clone()
        want[ids] = torch.linalg.solve_triangular(
            data.diag[ids], want[ids], upper=not data.lower)
        got = diag_trsm(xw.clone(), data.diag, w, data.lower)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(diag_trsm_plain(xw.clone(), data.diag, w,
                                                 data.lower)), _bits(want))
    assert diag_trsm.LAUNCHES == before


@pytest.mark.parametrize("R", RHS)
def test_the_level_solve_is_the_solve_triangular_route(deployment, R):
    """``blocked_tri_solve`` at ``"trsm"`` equals the route it always ran,
    written out: the waves, and per level the gather, ``solve_triangular``
    and the scatter; ``plain=True`` gives the same bits."""
    _, F = deployment
    N = F._numeric
    x0 = _blocked(F, R)
    want = x0.clone()
    for data in (N.ldata, N.udata):
        for w in data.waves:
            if w.accumulate:
                wave_apply_plain(want, data.tiles_t, w)
            else:
                ids = w.dst_long
                want[ids] = torch.linalg.solve_triangular(
                    data.diag[ids], want[ids], upper=not data.lower)
    before = diag_trsm.LAUNCHES
    for plain in (False, True):
        got = x0.clone()
        for data in (N.ldata, N.udata):
            blocked_tri_solve(data, got, mode="trsm", plain=plain)
        assert torch.equal(_bits(got), _bits(want)), plain
    assert diag_trsm.LAUNCHES == before


def test_diag_trsm_refuses_what_it_cannot_take(deployment):
    _, F = deployment
    N = F._numeric
    data = N.ldata
    diag_w = next(w for w in data.waves if not w.accumulate)
    off_w = next(w for w in data.waves if w.accumulate)
    xw = _blocked(F, 4)
    with pytest.raises(ValueError):
        diag_trsm(xw, data.diag, off_w, data.lower)  # not a diagonal wave
    with pytest.raises(ValueError):
        diag_trsm(xw.float(), data.diag, diag_w, data.lower)  # dtypes
    with pytest.raises(ValueError):
        diag_trsm(xw[:1], data.diag, diag_w, data.lower)  # past the carrier
