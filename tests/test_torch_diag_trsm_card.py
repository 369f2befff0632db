"""The diagonal step of the level-step solve at ``tri_mode="trsm"``
(``diag_trsm``, ``csrc/ldiv.cu`` with ``csrc/diag_trsm.cuh``) on a CUDA
card.

* On the real float64 and float32 factors of the benchmark's
  ``poisson2d_100`` deployment (BASELINE config 4, ``chunk_size=128``)
  every level of L and of U matches ``torch.linalg.solve_triangular`` on
  the same tiles (the plain twin ``diag_trsm_plain``) to a relative 1e-13
  a column in float64 and 1e-5 in float32, at R = 1, 7 and 16; the chunks
  outside the level, the dummy block ``K`` and the rows whose tile row is
  the identity's (the padding rows among them) keep their bits.
* Random triangular tiles at chunk sizes whose rows are and are not whole
  16-byte pieces (the kernel's two staging paths) match the float64
  substitution of the same tiles, both triangles, both dtypes.
* The kernel's divisions are true divisions: on diagonal tiles, whose
  solve is the division alone, it gives the bits of ``x / d`` at
  diagonals from 2^-300 to 2^300 (2^-40 to 2^40 in float32), and zero
  numerators of either sign solve to zero; tiles and numerators scaled
  far from one still match the float64 substitution.
* A NaN in one tile stays in its own chunk.
* ``diag_trsm.LAUNCHES`` grows exactly as the registry's calls of
  ``lu.ldiv.diag`` and the launches counted in them (``trace.phases``)
  over an ``F.ldiv``, which meets ``fwd_err <= 1e-12`` against the
  benchmark's float64 reference (``h100_bench/reference/dense_f64.py``).
* The wrapper raises on a CUDA operand it cannot take.

This file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_diag_trsm_card.py -q

(``tests/conftest.py`` loads JAX). Without a card every test skips.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from h100_bench.reference import dense_f64  # noqa: E402
from tpu_sparse_lu_torch.ops.fused_ldiv import (  # noqa: E402
    diag_trsm, diag_trsm_plain, make_wave,
)
from tpu_sparse_lu_torch import trace  # noqa: E402

DTYPES = ("float32", "float64")
# relative difference a column from solve_triangular on the same tiles
TOL = {"float32": 1e-5, "float64": 1e-13}
RHS = (1, 7, 16)
# chunk sizes of the random tiles: rows of whole 16-byte pieces in both
# dtypes (16, 100, 128), in float64 only (30), in neither (45, 127)
SIZES = (16, 30, 45, 100, 127, 128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


_CACHE = {}


def _solver(dt):
    """(A, F): the poisson2d_100 deployment at ``tri_mode="trsm"``."""
    if dt not in _CACHE:
        A, F, _ = chip_smoke._mode_solver(dt, "trsm")
        _CACHE[dt] = (A, F)
    return _CACHE[dt]


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def _carrier(blocks, cs, R, dt, seed):
    """A (blocks, cs, R) carrier of nonzero values, padding rows and the
    dummy block included: a row the step leaves alone keeps its bits."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((blocks, cs, R), generator=g, dtype=torch.float64) + 0.5
    sign = torch.randint(0, 2, x.shape, generator=g) * 2 - 1
    return (x * sign).to(getattr(torch, dt)).cuda()


def _col_rel(got, want):
    """Per chunk and column, max |got - want| / max |want| (float64)."""
    got, want = got.double(), want.double()
    den = want.abs().amax(dim=1).clamp_min(1e-300)
    return ((got - want).abs().amax(dim=1) / den).max().item()


def _diag_waves(F):
    for data in chip_smoke._banks(F):
        for w in data.waves:
            if not w.accumulate:
                yield data, w


@pytest.mark.parametrize("R", RHS)
@pytest.mark.parametrize("dt", DTYPES)
def test_every_level_matches_solve_triangular(card, dt, R):
    A, F = _solver(dt)
    K, cs = F.plan.lplan.K, F.plan.cs
    x0 = _carrier(K + 1, cs, R, dt, seed=R)
    eye = torch.eye(cs, dtype=x0.dtype, device="cuda")
    levels = pads = 0
    for data, w in _diag_waves(F):
        ids = w.dst_long
        assert int(ids.max()) < K  # the dummy block is in no level
        got = diag_trsm(x0.clone(), data.diag, w, data.lower)
        want = diag_trsm_plain(x0.clone(), data.diag, w, data.lower)
        torch.cuda.synchronize()
        rel = _col_rel(got[ids], want[ids])
        assert rel <= TOL[dt], (data.lower, levels, rel)
        outside = torch.ones(K + 1, dtype=torch.bool, device="cuda")
        outside[ids] = False
        assert torch.equal(_bits(got[outside]), _bits(x0[outside]))
        # padding rows, and every other row whose tile row is the
        # identity's, solve to themselves
        pad = (data.diag[ids] == eye).all(dim=2)
        assert torch.equal(_bits(got[ids][pad]), _bits(x0[ids][pad]))
        levels += 1
        pads += int(pad.sum())
    assert levels >= 16 and pads > 0


def _random_tiles(n, cs, lower, unit, dt, seed):
    """``n`` well-conditioned triangular (cs, cs) tiles: off-diagonal
    entries of size ~1/cs, a diagonal of 1 (``unit``) or of 1 to 2 in
    either sign."""
    g = torch.Generator().manual_seed(seed)
    d = (torch.rand((n, cs, cs), generator=g, dtype=torch.float64) - 0.5)
    d = (torch.tril(d, -1) if lower else torch.triu(d, 1)) * (4.0 / cs)
    if unit:
        dg = torch.ones((n, cs), dtype=torch.float64)
    else:
        dg = torch.rand((n, cs), generator=g, dtype=torch.float64) + 1.0
        dg = dg * (torch.randint(0, 2, (n, cs), generator=g) * 2 - 1)
    d = d + torch.diag_embed(dg)
    return d.to(getattr(torch, dt)).contiguous().cuda()


@pytest.mark.parametrize("lower,unit", [(True, True), (True, False),
                                        (False, False)])
@pytest.mark.parametrize("cs", SIZES)
@pytest.mark.parametrize("dt", DTYPES)
def test_random_tiles_at_every_chunk_size(card, dt, cs, lower, unit):
    nblk = 6
    diag = _random_tiles(nblk, cs, lower, unit, dt, seed=cs)
    ids = [0, 2, 3, 5]
    w = make_wave(ids, [[(k, k)] for k in ids], False, "cuda")
    for R in (1, 5, 16):
        x0 = _carrier(nblk, cs, R, dt, seed=cs + R)
        got = diag_trsm(x0.clone(), diag, w, lower)
        torch.cuda.synchronize()
        want = torch.linalg.solve_triangular(diag[w.dst_long].double(),
                                             x0[w.dst_long].double(),
                                             upper=not lower)
        # float32 substitution against float64: a few ulps times cs
        tol = TOL[dt] if dt == "float64" else 1e-5
        assert _col_rel(got[w.dst_long], want) <= tol, (cs, lower, R)
        for k in (1, 4):
            assert torch.equal(_bits(got[k]), _bits(x0[k]))


@pytest.mark.parametrize("lower", (True, False))
@pytest.mark.parametrize("dt", DTYPES)
def test_diagonal_tiles_give_the_true_divisions_bits(card, dt, lower):
    """A tile with nothing off its diagonal: each element is one division,
    so the kernel gives ``x / d``'s bits at diagonals spread over most of
    the exponent range (equal values: the substitution's ``x - 0·y`` may
    turn a numerator's -0 into +0, as the library's does)."""
    cs, nblk, R = 128, 3, 16
    g = torch.Generator().manual_seed(31)
    span = 300 if dt == "float64" else 40
    e = torch.randint(-span, span + 1, (nblk, cs), generator=g)
    dg = (torch.rand((nblk, cs), generator=g, dtype=torch.float64) + 1.0)
    dg = dg * torch.pow(2.0, e.double())
    dg = dg * (torch.randint(0, 2, (nblk, cs), generator=g) * 2 - 1)
    diag = torch.diag_embed(dg).to(getattr(torch, dt)).cuda()
    x0 = _carrier(nblk, cs, R, dt, seed=32)
    x0[1, ::3] = 0.0
    x0[1, 1::3] = -0.0
    w = make_wave([0, 1], [[(0, 0)], [(1, 1)]], False, "cuda")
    got = diag_trsm(x0.clone(), diag, w, lower)
    want = x0[:2] / torch.diagonal(diag[:2], dim1=1, dim2=2)[:, :, None]
    torch.cuda.synchronize()
    # equal values are equal bits but for the zeros' signs
    assert torch.equal(got[:2], want)
    assert torch.equal(_bits(got[2]), _bits(x0[2]))


@pytest.mark.parametrize("lower", (True, False))
@pytest.mark.parametrize("dt", DTYPES)
def test_tiles_and_numerators_far_from_one(card, dt, lower):
    """A tile scaled by 2^300 (2^40 in float32) with its block, and a
    block of zeros of both signs: the scaled chunk matches the float64
    substitution, the zeros solve to zeros, other chunks keep their
    bits."""
    cs, nblk = 128, 4
    diag = _random_tiles(nblk, cs, lower, False, dt, seed=9)
    big = 2.0 ** (300 if dt == "float64" else 40)
    diag[1] *= big
    x0 = _carrier(nblk, cs, 16, dt, seed=10)
    x0[1] *= big
    x0[2] = 0.0  # zero numerators: +0 / b and -0 / b
    x0[2, ::2] = -0.0
    w = make_wave([1, 2], [[(1, 1)], [(2, 2)]], False, "cuda")
    got = diag_trsm(x0.clone(), diag, w, lower)
    torch.cuda.synchronize()
    want = torch.linalg.solve_triangular(diag[1].double(), x0[1].double(),
                                         upper=not lower)
    assert _col_rel(got[1:2], want[None]) <= TOL[dt]
    assert not bool(got[2].any())
    for k in (0, 3):
        assert torch.equal(_bits(got[k]), _bits(x0[k]))


@pytest.mark.parametrize("dt", DTYPES)
def test_a_nan_stays_in_its_chunk(card, dt):
    _, F = _solver(dt)
    K, cs = F.plan.lplan.K, F.plan.cs
    for data, w in _diag_waves(F):
        if w.dst.shape[0] >= 3:
            break
    ids = w.dst_long
    k = int(ids[1])
    bad = data.diag.clone()
    i, j = (5, 3) if data.lower else (3, 5)
    bad[k, i, j] = float("nan")
    x0 = _carrier(K + 1, cs, 16, dt, seed=77)
    clean = diag_trsm(x0.clone(), data.diag, w, data.lower)
    got = diag_trsm(x0.clone(), bad, w, data.lower)
    torch.cuda.synchronize()
    assert bool(got[k].isnan().any())
    others = torch.ones(K + 1, dtype=torch.bool, device="cuda")
    others[k] = False
    assert torch.equal(_bits(got[others]), _bits(clean[others]))


def test_launches_follow_the_diagonal_steps_and_ldiv_meets_the_bar(card):
    A, F = _solver("float64")
    rng = np.random.default_rng(25)
    b = rng.standard_normal((A.shape[0], 16))
    trace.reset()
    launches = diag_trsm.LAUNCHES
    x = F.ldiv(torch.as_tensor(b, device="cuda"))
    torch.cuda.synchronize()
    grew, _, counted = trace.phases(False)["lu.ldiv.diag"]
    assert grew == sum(1 for _ in _diag_waves(F)) >= 16
    assert diag_trsm.LAUNCHES - launches == grew == counted
    fwd = dense_f64.forward_errors(x.cpu().numpy(),
                                   dense_f64.solve(A, b, "cuda"))
    assert np.all(fwd <= 1e-12), fwd
    # the plain route launches nothing of its own
    launches = diag_trsm.LAUNCHES
    F._numeric.tiles(torch.as_tensor(b, device="cuda"), plain=True)
    assert diag_trsm.LAUNCHES == launches


def test_the_wrapper_refuses_what_it_cannot_take(card):
    _, F = _solver("float64")
    data, w = next(_diag_waves(F))
    K, cs = F.plan.lplan.K, F.plan.cs
    x = _carrier(K + 1, cs, 4, "float64", seed=3)
    off = next(v for v in data.waves if v.accumulate)
    with pytest.raises(ValueError):
        diag_trsm(x, data.diag, off, data.lower)  # not a diagonal wave
    with pytest.raises(ValueError):
        diag_trsm(x.float(), data.diag, w, data.lower)  # dtypes differ
    with pytest.raises(ValueError):
        diag_trsm(x.transpose(1, 2), data.diag, w, data.lower)  # shape
    with pytest.raises(ValueError):
        diag_trsm(x[:, :, ::2], data.diag, w, data.lower)  # not contiguous
    with pytest.raises(ValueError):
        diag_trsm(x.cpu(), data.diag, w, data.lower)  # two devices
