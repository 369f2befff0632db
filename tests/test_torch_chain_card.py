"""The chain deployment at full size on a CUDA card: BASELINE config 1
(``laplacian_1d(20000)``, natural order, no pivoting, float32), the
benchmark's ``laplacian1d_20000`` configuration.

* ``F.ldiv`` runs the chain solve, one launch of the chain kernel and no
  tile solve, and its answers at R = 1 and R = 16 lie within the limits of
  the benchmark cell ``laplacian1d_20000.solve``
  (``h100_bench/limits/laplacian1d_20000.solve.json``) of the plain float64
  reference (``h100_bench/reference/dense_f64.py``).
* Its bits equal the chain kernel's on one block (``grid=1``), which takes
  every tile in ticket order.

This file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_chain_card.py -q

(``tests/conftest.py`` loads JAX). Without a card every test skips.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch.models import laplacian_1d
from tpu_sparse_lu_torch.ops import bidiag_ldiv as BL
from tpu_sparse_lu_torch.ops import fused_ldiv as FL

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.reference import dense_f64  # noqa: E402

N = 20000
LIMITS = json.loads((ROOT / "h100_bench" / "limits" /
                     "laplacian1d_20000.solve.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def chain():
    """(A, F) of the deployment on the card, built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = laplacian_1d(N)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=128, ordering="natural", pivot_threshold=0.0,
        dtype="float32"), device="cuda")
    return A, F


@pytest.mark.parametrize("R", [1, 16])
def test_chain_ldiv_within_the_cells_limits(card, chain, R):
    A, F = chain
    assert F.solve_path == "chain"
    g = torch.Generator(device="cuda").manual_seed(2 ** 31 + 29 + R)
    b = torch.randn((N, R), generator=g, device="cuda")
    chains, tiles = BL.bidiag_ldiv.LAUNCHES, FL.fused_ldiv.LAUNCHES
    x = F.ldiv(b)
    torch.cuda.synchronize()
    assert BL.bidiag_ldiv.LAUNCHES == chains + 1
    assert FL.fused_ldiv.LAUNCHES == tiles
    B = b.double().cpu().numpy()
    X = x.double().cpu().numpy()
    fwd = dense_f64.forward_errors(X, dense_f64.solve(A, B, "cuda"))
    bwd = dense_f64.backward_errors(A, X, B, "cuda")
    assert fwd.max() <= LIMITS["fwd_err"], fwd
    assert bwd.max() <= LIMITS["bwd_err"], bwd


@pytest.mark.parametrize("R", [1, 16])
def test_chain_ldiv_bits_equal_one_block(card, chain, R):
    _, F = chain
    b = torch.as_tensor(np.random.default_rng(R).standard_normal((N, R)),
                        dtype=torch.float32, device="cuda")
    p = F._numeric.planes
    one = BL.bidiag_ldiv(b, lower=(p["aL"], p["sL"]),
                         upper=(p["aU"], p["sU"]), grid=1)
    assert torch.equal(F.ldiv(b), one)
    torch.cuda.synchronize()
