"""The chain deployment (BASELINE config 1's settings: a 1-D Laplacian,
natural order, no pivoting) through ``ParallelSparseLU.ldiv`` on the CPU.

* ``solve_path`` says which direct solve ``ldiv`` runs: ``"chain"`` for
  bidiagonal factors under identity permutations, ``"tiles"`` for the
  Poisson (nd) and block-banded cases of ``tests/test_torch_trace.py``, and
  again ``"tiles"`` once a device refactorization has made the chain's
  bands stale.
* ``ldiv`` on the chain matches the benchmark's plain float64 reference
  (``h100_bench/reference/dense_f64.py``, a dense LU in torch).
* Under ``torch.profiler`` a chain ``ldiv`` emits ``lu.ldiv.rhs`` then
  ``lu.ldiv.chain``, flat, and never the tile solve's ``lu.ldiv.launch``.
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
from tpu_sparse_lu_torch.models import block_banded, laplacian_1d, poisson_2d

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.reference import dense_f64  # noqa: E402

# BASELINE config 1's solver settings but the chunk size, set per test
CHAIN = dict(ordering="natural", pivot_threshold=0.0, dtype="float32")
# the tile-solve deployments of tests/test_torch_trace.py
TILES = {
    "poisson_nd": (lambda: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd", nd_cutoff=32,
                        dtype="float32")),
    "banded": (lambda: block_banded(np.random.default_rng(0), 12, 6),
               dict(chunk_size=16, ordering="colamd", dtype="float32")),
}
# Normwise backward error ||b - A x|| / (||A||_F ||x|| + ||b||): a
# backward-stable float32 solve reads float32's unit roundoff (6e-8) times
# a small growth, about 1e-9 to 1e-8 here.
BWD_LIMIT = 1e-6
# Forward error ||x - x_ref||_inf / ||x_ref||_inf: bounded by kappa(A) times
# the backward error, kappa ~ 4 n^2 / pi^2 (3.6e4 at n = 300, 1.6e6 at
# n = 2000); a float32 chain solve reads about 1e-6 at these sizes, while
# the same solve with its products' operands in TF32 (10 mantissa bits,
# unit roundoff 5e-4) reads 8e-3 and more.
FWD_LIMIT = 1e-4


@pytest.fixture(autouse=True)
def _empty_registry():
    trace.reset()
    yield
    trace.reset()


def _chain(n, chunk_size=128, **kw):
    A = laplacian_1d(n)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=chunk_size, **CHAIN, **kw), device="cpu")
    return A, F


def _rhs(n, R, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, R), generator=g)


@pytest.mark.parametrize("n", [300, 2000])
def test_solve_path_is_chain_on_a_1d_laplacian(n):
    _, F = _chain(n, chunk_size=16)
    assert F.solve_path == "chain"


@pytest.mark.parametrize("case", sorted(TILES))
def test_solve_path_is_tiles_off_the_chain(case):
    make, cfg = TILES[case]
    F = tlu.ParallelSparseLU(make().tocsc(), config=tlu.SolverConfig(**cfg),
                             device="cpu")
    assert F.solve_path == "tiles"


def test_solve_path_follows_a_device_refactorization():
    # the device refactorization leaves the chain's bands stale: ldiv falls
    # back to the tile solve until the next re-pack, and solve_path says so
    A, F = _chain(300, chunk_size=16)
    A2 = A.copy()
    A2.data = A2.data * 1.5
    F.refactor_numeric(A2)
    assert F.solve_path == "tiles"
    F.refactor(None)  # a re-pack detects the chain again
    assert F.solve_path == "chain"


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("n", [300, 2000])
def test_chain_ldiv_matches_the_float64_reference(n, R):
    A, F = _chain(n)
    assert F.solve_path == "chain"
    b = _rhs(n, R, seed=2 ** 31 + 17 * n + R)
    x = F.ldiv(b)
    assert x.shape == (n, R) and x.dtype == torch.float32
    B = b.double().numpy()
    X = x.double().numpy()
    fwd = dense_f64.forward_errors(X, dense_f64.solve(A, B, "cpu"))
    bwd = dense_f64.backward_errors(A, X, B, "cpu")
    assert np.all(bwd < BWD_LIMIT), bwd
    assert np.all(fwd < FWD_LIMIT), fwd


@pytest.mark.parametrize("refine_steps", [0, 1])
def test_chain_ldiv_emits_its_own_flat_span(tmp_path, refine_steps):
    _, F = _chain(300, chunk_size=16)
    b = _rhs(300, 2, seed=5)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        F.ldiv(b, refine_steps=refine_steps)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("lu.")),
                   key=lambda s: s[1])
    names = [n for n, _, _ in spans]
    residual = "lu.ldiv.residual"
    assert names == (["lu.ldiv.rhs", "lu.ldiv.chain"]
                     + [residual, "lu.ldiv.chain", residual] * refine_steps)
    # flat: no span starts before the one before it has ended
    assert all(s1 >= e0 for (_, _, e0), (_, s1, _) in zip(spans, spans[1:]))
    got = trace.totals()
    assert "lu.ldiv.launch" not in got
    assert got["lu.ldiv.rhs"][0] == 1
    assert got["lu.ldiv.chain"][0] == 1 + refine_steps
