"""The launch counts of the port's spans on a CUDA card
(``tpu_sparse_lu_torch/trace.py``, ``ops/_launch.check``), on small
deployments of every entry the benchmark runs.

* ``ldiv`` on the tile solve counts its one ``fused_ldiv`` launch in
  ``lu.ldiv.launch`` (one more a refinement sweep); on the chain solve the
  one ``bidiag_ldiv`` launch in ``lu.ldiv.chain``.
* At ``tri_mode="trsm"`` the perms and off-diagonal waves count in
  ``lu.ldiv.launch`` and each diagonal step's ``diag_trsm`` launch in
  ``lu.ldiv.diag``, one a call.
* The refactor-solve step counts two assembly launches in
  ``lu.refactor.assemble``, one in ``lu.refactor.eliminate``, one in
  ``lu.refactor.extract`` and the solve's one in ``lu.ldiv.launch``.
* A ``make_f64_ldiv`` solve counts a launch a direct solve and none in its
  casts and residuals (PyTorch and cuSPARSE).
* Every count equals the growth of the wrappers' own ``LAUNCHES``, none is
  made under no span, and under ``torch.profiler`` they land on the
  profiled side.

This file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_trace_card.py -q

(``tests/conftest.py`` loads JAX). Without a card every test skips.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch import trace
from tpu_sparse_lu_torch.models import block_banded, laplacian_1d, poisson_2d
from tpu_sparse_lu_torch.ops import (
    assembly, bidiag_ldiv, elim_fused, extract, fused_ldiv,
)

POISSON = dict(chunk_size=16, ordering="nd", nd_cutoff=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trace.reset()
    yield
    trace.reset()


def _launches():
    """Every wrapper's own count of its launches."""
    return (fused_ldiv.fused_ldiv.LAUNCHES + fused_ldiv.perm_gather.LAUNCHES
            + fused_ldiv.wave_apply.LAUNCHES + fused_ldiv.diag_trsm.LAUNCHES
            + bidiag_ldiv.bidiag_ldiv.LAUNCHES
            + assembly.assemble_tiles.LAUNCHES
            + assembly.assemble_closure.LAUNCHES
            + elim_fused.elim_fused.LAUNCHES + extract.extract_banks.LAUNCHES)


def _counted(profiled=False):
    """{name: launches} of the spans that launched, on one side."""
    return {k: n for k, (_, _, n) in trace.phases(profiled).items() if n}


def _rhs(n, R, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cuda").manual_seed(2 ** 31 + seed)
    return torch.randn((n, R), generator=g, device="cuda", dtype=dtype)


def _calls(fn, times=3):
    """Run ``fn`` ``times`` times after a warm call; the registry's
    launches and the wrappers' over those calls."""
    fn()
    torch.cuda.synchronize()
    trace.reset()
    before = _launches()
    for _ in range(times):
        fn()
    torch.cuda.synchronize()
    return _counted(), _launches() - before


@pytest.mark.parametrize("refine_steps", [0, 1])
def test_ldiv_counts_its_launch_in_its_span(card, refine_steps):
    F = tlu.ParallelSparseLU(poisson_2d(20, 20), config=tlu.SolverConfig(
        **POISSON, dtype="float32"), device="cuda")
    b = _rhs(F.n, 16)
    got, grew = _calls(lambda: F.ldiv(b, refine_steps=refine_steps))
    assert got == {"lu.ldiv.launch": 3 * (1 + refine_steps)}
    assert grew == 3 * (1 + refine_steps)


def test_the_chain_counts_its_launch_in_its_span(card):
    F = tlu.ParallelSparseLU(laplacian_1d(2000), config=tlu.SolverConfig(
        chunk_size=128, ordering="natural", pivot_threshold=0.0,
        dtype="float32"), device="cuda")
    assert F.solve_path == "chain"
    b = _rhs(F.n, 1)
    got, grew = _calls(lambda: F.ldiv(b))
    assert got == {"lu.ldiv.chain": 3} and grew == 3


def test_the_level_step_solve_counts_each_launch_in_its_step(card):
    F = tlu.ParallelSparseLU(poisson_2d(20, 20), config=tlu.SolverConfig(
        **POISSON, dtype="float64", tri_mode="trsm"), device="cuda")
    N = F._numeric
    waves = N.ldata.waves + N.udata.waves
    diag = sum(1 for w in waves if not w.accumulate)
    b = _rhs(F.n, 16, torch.float64)
    got, grew = _calls(lambda: F.ldiv(b), times=2)
    assert got == {"lu.ldiv.launch": 2 * (2 + len(waves) - diag),
                   "lu.ldiv.diag": 2 * diag}
    assert trace.phases(False)["lu.ldiv.diag"][0] == 2 * diag
    assert grew == 2 * (2 + len(waves))


def test_the_refactor_step_counts_each_kernel_in_its_phase(card):
    A = block_banded(np.random.default_rng(0), 12, 6).tocsc()
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="colamd", dtype="float32"), device="cuda")
    step = F.make_refactor_solve_step()
    a = torch.as_tensor(A.data, dtype=torch.float32, device="cuda") * 1.01
    b = _rhs(F.n, 8)
    got, grew = _calls(lambda: step(a, b))
    assert got == {"lu.refactor.assemble": 6, "lu.refactor.eliminate": 3,
                   "lu.refactor.extract": 3, "lu.ldiv.launch": 3}
    assert grew == 15


def test_the_f64_tier_counts_its_direct_solves_alone(card):
    F = tlu.ParallelSparseLU(poisson_2d(20, 20), config=tlu.SolverConfig(
        **POISSON, dtype="float32"), device="cuda")
    solve = F.make_f64_ldiv(refine_steps=2)
    b = _rhs(F.n, 16, torch.float64)
    got, grew = _calls(lambda: solve(b))
    assert got == {"lu.ldiv.launch": 9} and grew == 9
    plain = trace.phases(False)
    assert plain["lu.ldiv.rhs"][0] == 3
    assert plain["lu.ldiv.cast"][2] == plain["lu.ldiv.residual"][2] == 0


def test_launches_under_the_profiler_land_on_its_side(card):
    F = tlu.ParallelSparseLU(poisson_2d(20, 20), config=tlu.SolverConfig(
        **POISSON, dtype="float32"), device="cuda")
    b = _rhs(F.n, 16)
    F.ldiv(b)
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        F.ldiv(b)
        F.ldiv(b)
        torch.cuda.synchronize()
    F.ldiv(b)
    torch.cuda.synchronize()
    assert _counted(True) == {"lu.ldiv.launch": 2}
    assert _counted(False) == {"lu.ldiv.launch": 1}
