"""The solve banks' extraction (``extract_banks``, ``csrc/extract.cu``) on
a CUDA card.

* The one launch equals its plain twin ``extract_banks_plain`` bit for
  bit on the real ``elim_fused`` output of the benchmark's
  ``poisson2d_100`` (BASELINE config 4) and ``banded_120x30`` (config 2)
  deployments, float32 and float64.
* On that store with NaN, ±inf and -0.0 written into a diagonal tile
  (below and above its diagonal), an L and a U off-diagonal tile and an
  inverse tile, it gives the plain twin's bits, and a NaN or inf growth
  where ``amax`` gives one.
* ``extract_banks.LAUNCHES`` rises by exactly 1 per ``refactor_pipeline``
  call, and a ``make_refactor_solve_step`` call (no refinement) returns
  the bits of the same step with the plain extraction.
* With one refinement sweep, the step run twice with each extraction
  repeats its banks and its direct solve bit for bit; its refined answers
  differ only where the residual product ``b - A x`` does, and one
  recorded residual corrected with each run's banks gives one answer.

This file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_extract_card.py -q

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
import tpu_sparse_lu_torch.refactor as refactor  # noqa: E402
from tpu_sparse_lu_torch.ops.elimination import eliminate  # noqa: E402
from tpu_sparse_lu_torch.ops.extract import (  # noqa: E402
    extract_banks, extract_banks_plain,
)

DTYPES = ("float32", "float64")
DEPLOYMENTS = {"poisson2d_100": chip_smoke._headline_solver,
               "banded_120x30": chip_smoke._config2_solver}
OUTPUTS = ("lbank", "ubank", "ldiag", "udiag", "growth")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


_CACHE = {}


def _deployment(name, dt):
    """(A, F, dev, store, linv, uinv): ``elim_fused``'s output on the
    kernels' assembly of a seeded same-pattern change of the deployment's
    matrix."""
    key = (name, dt)
    if key not in _CACHE:
        A, F = DEPLOYMENTS[name](dt)
        F.enable_device_refactor()
        A2 = chip_smoke._same_pattern(np.random.default_rng(23), A)
        store, _ = chip_smoke._real_store(F, A2)
        store, _, linv, uinv = eliminate(store, F._refactor_dev.elim)
        _CACHE[key] = (A, F, F._refactor_dev, store, linv, uinv)
    return _CACHE[key]


def _maps(dev):
    return (dev.diag_src, dev.l_off_src, dev.u_off_src, dev.diag_lvlslot)


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def _both(store, linv, uinv, dev):
    got = extract_banks(store, linv, uinv, *_maps(dev))
    want = extract_banks_plain(store, linv, uinv, *_maps(dev))
    torch.cuda.synchronize()
    return got, want


def _assert_same(got, want, tag):
    for name, g, w in zip(OUTPUTS[:4], got, want):
        assert g.shape == w.shape and g.is_contiguous(), (tag, name)
        if not torch.equal(_bits(g), _bits(w)):
            bad = (_bits(g) != _bits(w)).nonzero()[:4].tolist()
            raise AssertionError(f"{tag}: {name} differs from the plain twin "
                                 f"at {bad}")
    g, w = got[4], want[4]
    assert g.shape == () and g.dtype == w.dtype
    if bool(w.isnan()):
        assert bool(g.isnan()), (tag, float(g))
    else:
        assert torch.equal(_bits(g), _bits(w)), (tag, float(g), float(w))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_kernel_is_the_plain_twin_on_real_stores(card, name, dt):
    _, _, dev, store, linv, uinv = _deployment(name, dt)
    got, want = _both(store, linv, uinv, dev)
    _assert_same(got, want, f"{name} {dt}")
    assert bool(want[4].isfinite()) and float(want[4]) >= 1.0


def _special(store, linv, dev, kind):
    """Copies of ``store`` and ``linv`` with ``kind`` values written in:
    ``-0.0`` over every zero; ``nan_lower`` into the strict lower part of
    a diagonal tile and into an inverse tile (outside the growth);
    ``nan_off`` / ``inf_off`` / ``ninf_off`` into one L and one U
    off-diagonal tile, and the upper part of a diagonal tile."""
    s, li = store.clone(), linv.clone()
    d = int(dev.diag_src[len(dev.diag_src) // 2])
    lo, uo = int(dev.l_off_src[0]), int(dev.u_off_src[-1])
    inv = li.view(-1, *li.shape[-2:])[int(dev.diag_lvlslot[0])]
    if kind == "neg_zero":
        s[s == 0] = -0.0
        li[li == 0] = -0.0
        s[d, 3, 1] = -0.0
        s[lo, 0, 0] = -0.0
        return s, li
    v = {"nan_lower": float("nan"), "nan_off": float("nan"),
         "inf_off": float("inf"), "ninf_off": -float("inf")}[kind]
    if kind == "nan_lower":
        s[d, 5, 2] = v
        s[d, 7, 0] = -0.0
        inv[1, 4] = v
    else:
        s[lo, 1, 2] = v
        s[uo, 4, 3] = -v
        s[d, 2, 6] = v
    return s, li


@pytest.mark.parametrize("kind", ["neg_zero", "nan_lower", "nan_off",
                                  "inf_off", "ninf_off"])
@pytest.mark.parametrize("dt", DTYPES)
def test_special_values_give_the_plain_bits(card, dt, kind):
    _, _, dev, store, linv, uinv = _deployment("banded_120x30", dt)
    s, li = _special(store, linv, dev, kind)
    got, want = _both(s, li, uinv, dev)
    _assert_same(got, want, f"{kind} {dt}")
    growth = float(want[4])
    if kind == "nan_off":
        assert np.isnan(growth) and np.isnan(float(got[4]))
    elif kind in ("inf_off", "ninf_off"):
        assert growth == float(got[4]) == float("inf")
    else:
        assert np.isfinite(growth)
    if kind == "nan_lower":
        assert bool(got[2].isnan().any()) and bool(got[0].isnan().any())
        assert not bool(got[3].isnan().any())


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_one_launch_per_refactorization(card, name):
    A, F, dev, *_ = _deployment(name, "float32")
    a = torch.as_tensor(A.tocsc().data, dtype=F.dtype, device="cuda")
    before = extract_banks.LAUNCHES
    for k in range(3):
        refactor.refactor_pipeline(a, dev)
        assert extract_banks.LAUNCHES == before + k + 1
    refactor.refactor_pipeline(a, dev, plain=True)
    assert extract_banks.LAUNCHES == before + 3


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_step_equals_the_step_with_the_plain_extraction(card, name,
                                                        monkeypatch):
    """The benchmark's step, with no refinement (the refined step is
    held to the plain extraction in the next test)."""
    A, F, *_ = _deployment(name, "float32")
    rng = np.random.default_rng(31)
    A2 = chip_smoke._same_pattern(rng, A)
    b = torch.as_tensor(rng.random((A.shape[0], 8)), dtype=F.dtype,
                        device="cuda")
    step = F.make_refactor_solve_step()
    before = extract_banks.LAUNCHES
    x = step(A2.data, b)
    assert extract_banks.LAUNCHES == before + 1
    monkeypatch.setattr(refactor, "extract_banks", extract_banks_plain)
    x_plain = step(A2.data, b)
    torch.cuda.synchronize()
    assert extract_banks.LAUNCHES == before + 1
    assert torch.equal(_bits(x), _bits(x_plain))


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_refined_step_differs_only_where_its_residual_does(card, name,
                                                           monkeypatch):
    """The step with one refinement sweep, twice with the kernel's
    extraction and twice with the plain one, each run's banks, direct
    solve, residual and answer recorded. The banks and the direct solve
    are the same bits in all four runs. Two runs with the same residual
    bits give the same answer bits, and the residual of the first run
    corrected with each run's banks gives one answer: whatever differs
    between refined answers, between repeats as between extractions,
    comes from the residual product ``b - A x`` (a sparse CSR product,
    repeated here on one ``x`` to show whether it repeats)."""
    import tpu_sparse_lu_torch.api as api

    A, F, *_ = _deployment(name, "float32")
    rng = np.random.default_rng(37)
    A2 = chip_smoke._same_pattern(rng, A)
    b = torch.as_tensor(rng.random((A.shape[0], 8)), dtype=F.dtype,
                        device="cuda")
    step = F.make_refactor_solve_step(refine_steps=1)
    runs, refine = [], api.refine

    def recorded(fn):
        def extract(*args):
            out = fn(*args)
            runs.append({"banks": [t.clone() for t in out]})
            return out
        return extract

    def recorded_refine(solve, residual, b, x, steps):
        run = runs[-1]
        run.update(x0=x.clone(), solve=solve, r=[])

        def res(b, x):
            r = residual(b, x)
            run["r"].append(r.clone())
            return r

        run["x"] = refine(solve, res, b, x, steps)
        return run["x"]

    monkeypatch.setattr(api, "refine", recorded_refine)
    for fn in (extract_banks, extract_banks_plain):
        monkeypatch.setattr(refactor, "extract_banks", recorded(fn))
        for _ in range(2):
            step(A2.data, b)
    torch.cuda.synchronize()
    assert len(runs) == 4 and all(len(r["r"]) == 1 for r in runs)
    first = runs[0]
    for k, run in enumerate(runs[1:], 1):
        _assert_same(run["banks"], first["banks"], f"{name} run {k} banks")
        assert torch.equal(_bits(run["x0"]), _bits(first["x0"])), k
    r0 = first["r"][0]
    d0 = _bits(first["solve"](r0))
    for k, run in enumerate(runs[1:], 1):
        assert torch.equal(_bits(run["solve"](r0)), d0), k
    diff = {}
    for i in range(4):
        for j in range(i + 1, 4):
            ri, rj = (_bits(runs[k]["r"][0]) for k in (i, j))
            same_r = torch.equal(ri, rj)
            dx = float((runs[i]["x"] - runs[j]["x"]).abs().max())
            if same_r:
                assert dx == 0.0, (i, j, dx)
            diff[(i, j)] = (same_r, dx)
    a = torch.as_tensor(A2.data, dtype=F.dtype, device="cuda")
    A_csr = F._csr_matrix(a)
    prods = [A_csr @ first["x0"] for _ in range(8)]
    torch.cuda.synchronize()
    spread = max(float((p - prods[0]).abs().max()) for p in prods)
    print(f"\n{name}: banks and direct solve equal in all 4 runs; "
          f"(run i, run j): (same residual bits, max |x_i - x_j|) with runs "
          f"0-1 kernel, 2-3 plain: {diff}; A @ x0 eight times: max abs "
          f"spread {spread:.3e}")
