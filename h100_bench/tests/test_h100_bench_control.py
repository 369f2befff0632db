"""The output check fails what it must: the control (the reference in
the program's place, computed in TF32) and runs with the timed path
broken underneath. On the CPU at a small copy of each deployment, and on
a card at the cells' own sizes (``card``)."""

import pytest
import torch

from h100_bench import harness, readings
from h100_bench.tests.conftest import ROOT

SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 12345]


def _limits(bench, cell):
    return bench.data("limits", cell)


def _fails(reading, limits):
    return any(not reading[k] <= lim for k, lim in limits.items())


def _check_readings(bench, cell, device, seconds):
    got = readings.readings(bench, cell, SEEDS, len(SEEDS), seconds, device)
    limits = _limits(bench, cell)
    for r in got["program"]:
        assert not _fails(r, limits), (cell, r, limits)
    for r in got["control"]:
        assert _fails(r, limits), (cell, r, limits)


@pytest.mark.parametrize("cell", ["tiny_poisson.solve", "tiny_banded.solve",
                                  "tiny_band.solve",
                                  "tiny_poisson.refactor_solve",
                                  "tiny_banded.refactor_solve"])
def test_control_fails_and_program_passes_on_the_cpu(tiny_bench, cell):
    bench, _ = tiny_bench
    _check_readings(bench, cell, "cpu", 0.2)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["poisson2d_100.solve",
                                  "banded_120x30.refactor_solve",
                                  "poisson2d_100.refactor_solve",
                                  "banded_120x30.solve",
                                  "banded_1600x64.solve"])
def test_control_fails_and_program_passes_on_the_card(card, cell):
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_readings(harness.Bench.load(ROOT), cell, "cuda", 1.0)


def _break(monkeypatch, fault):
    """Break the program's entries underneath the harness."""
    from tpu_sparse_lu_torch.api import ParallelSparseLU

    ldiv = ParallelSparseLU.ldiv
    make = ParallelSparseLU.make_refactor_solve_step

    def spoil(x):
        x = x.clone()
        if fault == "half_batch":  # half the columns left out, their mean
            h = x.shape[1] // 2
            x[:, h:] = x[:, :h].mean(dim=1, keepdim=True)
        elif fault == "altered":  # the largest entry's sign flipped
            i = x.abs().argmax()
            x.view(-1)[i] = -x.view(-1)[i]
        return x

    if fault == "unchanged":
        # the solve hands back its first answer; the refactor-solve step
        # keeps its first factorization
        first = {}

        def stale_ldiv(self, b, **kw):
            if id(self) not in first:
                first[id(self)] = ldiv(self, b, **kw)
            return first[id(self)]

        monkeypatch.setattr(ParallelSparseLU, "ldiv", stale_ldiv)
        monkeypatch.setattr(
            ParallelSparseLU, "make_refactor_solve_step",
            lambda self, **kw: (lambda a, b: ldiv(self, b)))
    else:
        monkeypatch.setattr(ParallelSparseLU, "ldiv",
                            lambda self, b, **kw: spoil(ldiv(self, b, **kw)))

        def spoiled_make(self, **kw):
            step = make(self, **kw)
            return lambda a, b: spoil(step(a, b))

        monkeypatch.setattr(ParallelSparseLU, "make_refactor_solve_step",
                            spoiled_make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["tiny_poisson.solve", "tiny_banded.solve",
                                  "tiny_band.solve",
                                  "tiny_poisson.refactor_solve",
                                  "tiny_banded.refactor_solve"])
def test_a_broken_step_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    bench, _ = tiny_bench
    _break(monkeypatch, fault)
    r = harness.run_cell(bench, cell, 2 ** 31 + 3, 0.3, False, "cpu",
                         harness.time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0
