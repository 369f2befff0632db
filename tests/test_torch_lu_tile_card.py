"""The tile LU (``lu_tile``, ``csrc/lu_tile.cu``) and the one-launch
elimination whose LU task it is (``elim_fused``) on a CUDA card.

* ``lu_tile`` lies within ``chip_smoke.LU_TOL`` of ``lu_tile_plain`` at
  cs 16, 45, 100 and 128 (one partial panel, ragged last panels, whole
  panels), float32 and float64, with both inverses and the LU alone, on
  dominant tiles and on tiles whose columns are mostly zeros, -0.0 among
  them (most multipliers divide a zero).
* On tiles with a zero or a NaN pivot (``chip_smoke._special_tiles``) its
  min |pivot| is the plain twin's, and NaN spreads as in the plain twin:
  a NaN pivot last stays where it is, a zero or NaN pivot in the middle
  reaches every row below it. (The plain twin also spreads NaN into rows
  above, through its products by zero multipliers; the kernel leaves
  those rows as they were.)
* ``elim_fused`` on BASELINE config 2's store equals the per-level route
  (``lu_tile`` + 3 ``tile_mm`` a level) bit for bit, at one block and at
  the default grid.

This file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_lu_tile_card.py -q

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
from tpu_sparse_lu_torch.ops.elimination import eliminate  # noqa: E402
from tpu_sparse_lu_torch.ops.lu_tile import lu_tile, lu_tile_plain  # noqa: E402

DTYPES = ("float32", "float64")
SIZES = chip_smoke.LU_SIZES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _both(tiles, inverses):
    """(kernel, plain) outputs of every tile of ``tiles``: the factor, the
    min |pivot| and, with ``inverses``, L^-1 and U^-1."""
    nb, cs = tiles.shape[0], tiles.shape[1]
    outs = []
    for fn in (lu_tile, lu_tile_plain):
        t = tiles.clone()
        inv = ({k: torch.zeros((nb, cs, cs), dtype=t.dtype, device="cuda")
                for k in ("linv", "uinv")} if inverses else {})
        p = fn(t, **inv)
        outs.append((t, p, *inv.values()))
    torch.cuda.synchronize()
    return outs


def _within(got, ref, dt):
    r = chip_smoke._rel(got, ref)
    assert r <= chip_smoke.LU_TOL[dt], (r, chip_smoke.LU_TOL[dt])


@pytest.mark.parametrize("cs", SIZES)
@pytest.mark.parametrize("dt", DTYPES)
def test_lu_tile_is_within_tolerance_of_plain(card, dt, cs):
    tdt = getattr(torch, dt)
    rng = np.random.default_rng(21 + cs)
    for got, ref in chip_smoke._lu_tile_pairs(rng, tdt, cs):
        _within(got, ref, dt)
    sparse = chip_smoke._special_tiles(rng, tdt, cs)["sparse"]
    assert bool(torch.signbit(sparse[sparse == 0]).any())
    for inverses in (True, False):
        for got, ref in zip(*_both(sparse, inverses)):
            assert bool(got.isfinite().all())
            _within(got, ref, dt)


@pytest.mark.parametrize("kind", ["zero_last", "nan_last", "zero_mid",
                                  "nan_mid"])
@pytest.mark.parametrize("cs", SIZES)
@pytest.mark.parametrize("dt", DTYPES)
def test_zero_and_nan_pivots_as_the_plain_twin(card, dt, cs, kind):
    tdt = getattr(torch, dt)
    tiles = chip_smoke._special_tiles(np.random.default_rng(7 + cs), tdt,
                                      cs)[kind]
    (t, p), (tp, pp) = _both(tiles, inverses=False)
    assert torch.equal(p.isnan(), pp.isnan())
    assert torch.equal(p.nan_to_num(), pp.nan_to_num())
    if kind == "zero_last":
        assert bool((p == 0).all())
        assert bool(t.isfinite().all()) and bool(tp.isfinite().all())
        _within(t, tp, dt)
    elif kind == "nan_last":
        assert bool(p.isnan().all())
        want = torch.zeros_like(t, dtype=torch.bool)
        want[:, cs - 1, cs - 1] = True
        assert torch.equal(t.isnan(), want)
        assert torch.equal(tp.isnan(), want)
        _within(t.nan_to_num(), tp.nan_to_num(), dt)
    else:
        m = cs // 2
        assert bool(p.isnan().all())
        for x in (t, tp):
            assert bool(x[:, m + 1:].isnan().any(dim=-1).all())


@pytest.fixture(scope="module", params=DTYPES)
def config2(request):
    """BASELINE config 2's assembled store and elimination schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, F = chip_smoke._config2_solver(request.param)
    F.enable_device_refactor()
    store, _ = chip_smoke._real_store(F, A)
    return store, F._refactor_dev.elim


@pytest.mark.parametrize("grid", [1, None])
def test_elim_fused_equals_the_per_level_route(card, config2, grid):
    store, sched = config2
    want = eliminate(store.clone(), sched, route="levels")
    got = eliminate(store.clone(), sched, grid=grid)
    torch.cuda.synchronize()
    assert sched.NL == 29
    for what, g, w in zip(("store", "min_piv", "linv", "uinv"), got, want):
        assert torch.equal(g, w), what
