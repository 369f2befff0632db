"""The port's persistence (``save``, ``save_symbolic``, ``from_saved``)
against the JAX package's (tests/test_round5.py:191-315), on the CPU.

A reload skips SuperLU and the planner: a full save (version 2) reloads
to the very bits the saved solver solves with; a light save (version 3,
no factor values) runs the device refactorization on ``A``'s values and
reloads to the bits of ``refactor_numeric(A)`` on the saved solver. The
JAX package's version-1 files, full and light, load too. Each of the
reference caveats of ROADMAP queue C has a test here that the JAX
package's behaviour would fail.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch
from _approx import assert_isapprox

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
import tpu_sparse_lu_torch.api as tapi
from tpu_sparse_lu.models import fe_block_matrix, poisson_2d

INV_TOL = 1e-9
TOL = 1e-12  # the reference's sparse bar (test/runtests.jl:25)


def _perturb(rng, A, scale):
    A2 = A.copy()
    A2.data = A2.data * (1.0 + scale * rng.standard_normal(A2.data.shape))
    return A2


def _solver(A, **cfg):
    return tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                                device="cpu")


def _load(A, path, **kw):
    return tlu.ParallelSparseLU.from_saved(A, path, device="cpu", **kw)


@pytest.fixture
def host_calls(monkeypatch):
    """Records every call of the port's ``api.factorize_host``, the name
    the solver calls (unlike tests/test_round5.py:233-241, whose patch of
    ``symbolic.factorize_host`` cannot see it)."""
    calls = []
    orig = tapi.factorize_host
    monkeypatch.setattr(tapi, "factorize_host",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(chunk_size=16, dtype="float32"),
    dict(chunk_size=16),
    dict(chunk_size=16, ordering="nd", tri_mode="trsm"),
    dict(chunk_size=16, ordering="nd", tri_mode="inv_refine",
         dtype="float32"),
], ids=["f32", "f64", "nd_trsm", "nd_inv_refine_f32"])
def test_full_save_reloads_bit_for_bit(rng, tmp_path, host_calls, cfg):
    A = poisson_2d(12, 12)
    F = _solver(A, **cfg)
    path = tmp_path / "full.npz"
    F.save(path)  # no device refactor schedule: "auto" is a full save
    n_calls = len(host_calls)
    G = _load(A, path)
    assert len(host_calls) == n_calls, "the reload ran SuperLU"
    assert G.config == F.config and G.n_factor == F.n_factor
    b = rng.random((A.shape[0], 3))
    assert torch.equal(G.ldiv(b), F.ldiv(b))
    assert torch.equal(G.lsolve(b[:1].repeat(G.n_factor, 0)),
                       F.lsolve(b[:1].repeat(F.n_factor, 0)))
    for name in ("p", "q", "Rs"):
        assert np.array_equal(getattr(G, name), getattr(F, name))
    # the factors as saved: their values at the working precision
    vdt = np.float32 if cfg.get("dtype") == "float32" else np.float64
    for name in ("L", "U"):
        g, f = getattr(G, name), getattr(F, name)
        assert np.array_equal(g.indptr, f.indptr)
        assert np.array_equal(g.indices, f.indices)
        assert np.array_equal(g.data, f.data.astype(vdt))


@pytest.mark.parametrize("mode", ["inv", "trsm", "inv_refine"])
def test_light_reload_equals_refactor_numeric(rng, tmp_path, host_calls,
                                              mode):
    A = poisson_2d(14, 11)
    F = _solver(A, chunk_size=16, ordering="nd", factorize="device",
                tri_mode=mode)
    path = tmp_path / "light.npz"
    F.save(path)  # "auto": the solver has a schedule, so a light save
    with np.load(path) as z:
        assert int(z["version"]) == 3 and "L_data" not in z
    G = _load(A, path)
    assert host_calls == [] and G.has_device_refactor
    F.refactor_numeric(A)
    b = rng.random((A.shape[0], 2))
    assert torch.equal(G.ldiv(b), F.ldiv(b))
    assert_isapprox(G.ldiv(b).numpy(), spla.spsolve(A.tocsc(), b),
                    rtol=INV_TOL if mode == "inv" else TOL,
                    atol=INV_TOL if mode == "inv" else TOL)
    # the saved refactor plan came back whole
    want, got = F._refactor_plan, G._refactor_plan
    for fld in dataclasses.fields(want):
        a, w = getattr(got, fld.name), getattr(want, fld.name)
        if fld.name == "asm":
            for f2 in dataclasses.fields(w):
                assert np.array_equal(getattr(a, f2.name),
                                      getattr(w, f2.name)), f2.name
        elif fld.name == "schur_groups":
            assert len(a) == len(w)
            for ga, gw in zip(a, w):
                for x, y in zip(ga, gw):
                    assert np.array_equal(x, y) and x.dtype == y.dtype
        else:
            assert np.array_equal(a, w), fld.name
            assert type(a) is type(w), fld.name


def test_factorize_device_save_roundtrip(rng, tmp_path):
    """tests/test_round5.py:191-218: a device factorization saves light by
    default and reloads at the same accuracy; ``values=True`` writes the
    factor values (read back from the device)."""
    A = poisson_2d(12, 12)
    F = _solver(A, chunk_size=16, ordering="nd", factorize="device")
    b = rng.random(A.shape[0])
    x0 = F.ldiv(b, refine_steps=1).numpy()
    light, full = tmp_path / "state.npz", tmp_path / "full.npz"
    F.save(light)
    F.save(full, values=True)
    with np.load(full) as z:
        assert int(z["version"]) == 2 and "L_data" in z
    xe = spla.spsolve(A.tocsc(), b)
    for path in (light, full):
        x = _load(A, path).ldiv(b, refine_steps=1).numpy()
        assert_isapprox(x, x0, rtol=INV_TOL, atol=INV_TOL)
        assert_isapprox(x, xe, rtol=INV_TOL, atol=INV_TOL)


def test_save_light_from_host_solver(rng, tmp_path, host_calls):
    """tests/test_round5.py:221-263: ``values=False`` on a host-factorized
    solver; the reload never calls SuperLU, the lifecycle goes on, and a
    value change at load is refactored (or refused)."""
    A = poisson_2d(14, 14)
    F = _solver(A, chunk_size=16, ordering="nd", dtype="float32")
    assert len(host_calls) == 1  # the construction's factorization
    light = tmp_path / "light.npz"
    F.save(light, values=False)
    G = _load(A, light)
    assert len(host_calls) == 1, "the light reload ran SuperLU"
    b = rng.random(A.shape[0])
    assert_isapprox(G.ldiv(b, refine_steps=1).numpy().astype(np.float64),
                    spla.spsolve(A.tocsc(), b), rtol=1e-4, atol=1e-5)
    A2 = _perturb(rng, A, 0.02)
    G.refactor_numeric(A2)
    assert_isapprox(G.ldiv(b, refine_steps=1).numpy().astype(np.float64),
                    spla.spsolve(A2.tocsc(), b), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="values differ"):
        _load(A2, light, on_value_change="error")
    H = _load(A2, light)
    assert torch.equal(H.ldiv(b), G.ldiv(b))
    assert len(host_calls) == 1


def test_full_save_value_change_refactors(rng, tmp_path):
    A = fe_block_matrix(rng, 10, 5)
    F = _solver(A, chunk_size=8, tri_mode="trsm")
    path = tmp_path / "full.npz"
    F.save(path)
    A2 = _perturb(rng, A, 0.05)
    with pytest.raises(ValueError, match="values differ"):
        _load(A2, path, on_value_change="error")
    G = _load(A2, path)
    assert G.has_device_refactor
    b = rng.random(A.shape[0])
    assert_isapprox(G.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                    rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="pattern differs"):
        _load(poisson_2d(10, 5), path)
    with pytest.raises(ValueError, match="on_value_change"):
        _load(A, path, on_value_change="ignore")


def test_light_save_preserves_config(tmp_path):
    """tests/test_round5.py:283-301, and the mode."""
    A = poisson_2d(12, 12)
    F = _solver(A, chunk_size=16, ordering="nd", factorize="device",
                stream_dtype="bfloat16", nd_cutoff=32, dtype="float32")
    path = tmp_path / "cfg.npz"
    F.save(path)
    G = _load(A, path)
    assert G.config == F.config
    assert G.config.stream_dtype == "bfloat16"
    assert G._numeric.ldata.tiles_bf16 is not None
    assert G.config.factorize == "device" and G._nd_cutoff == 32
    assert G.chunk_size == F.chunk_size
    T = _solver(A, chunk_size=16, tri_mode="inv_refine")
    T.save(path, values=False)
    assert _load(A, path).config.tri_mode == "inv_refine"


def test_save_values_at_working_precision(rng, tmp_path):
    """tests/test_round5.py:304-326: factor values at the solver's dtype,
    the f32 reload at the f32 accuracy tier; ``compress=True`` writes a
    smaller file that loads the same."""
    A = fe_block_matrix(rng, 20, 5)
    F = _solver(A, chunk_size=16, dtype="float32")
    path, packed = tmp_path / "f32.npz", tmp_path / "f32z.npz"
    F.save(path)
    F.save(packed, compress=True)
    with np.load(path) as z:
        assert z["L_data"].dtype == np.float32
        assert z["U_data"].dtype == np.float32
    assert packed.stat().st_size < path.stat().st_size
    b = rng.random(A.shape[0])
    x = _load(A, path).ldiv(b, refine_steps=1).numpy().astype(np.float64)
    xe = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - xe) / np.linalg.norm(xe) < 1e-5
    assert torch.equal(_load(A, packed).ldiv(b), _load(A, path).ldiv(b))
    p64 = tmp_path / "f64.npz"
    _solver(A, chunk_size=16).save(p64)
    with np.load(p64) as z:
        assert z["L_data"].dtype == np.float64


# ---------------------------------------------------------------------------
# the JAX package's files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", [True, False], ids=["full", "light"])
@pytest.mark.parametrize("cfg", [
    dict(chunk_size=16, tri_mode="inv", dtype="float32"),
    dict(chunk_size=16, ordering="nd", tri_mode="trsm"),
], ids=["colamd_inv_f32", "nd_trsm"])
def test_jax_files_load(rng, tmp_path, cfg, values):
    """A JAX version-1 save, full or light: the port takes the saved mode
    and solves as the JAX solver does. A JAX light file's refactor plan
    describes the JAX windowed assembly, so the port rebuilds its own on
    the saved closure plans: equal to the one it plans itself."""
    A = poisson_2d(12, 12)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(**cfg))
    path = tmp_path / "jax.npz"
    jf.save(str(path), values=values)
    G = _load(A, path)
    assert G.config.tri_mode == cfg["tri_mode"]
    f64 = cfg.get("dtype") != "float32"
    tol = TOL if f64 else 1e-5
    b = rng.random(A.shape[0])
    if f64:
        assert_isapprox(G.ldiv(b).numpy(), np.asarray(jf.ldiv(b)), rtol=tol,
                        atol=tol)
    else:
        np.testing.assert_allclose(G.ldiv(b).numpy(), np.asarray(jf.ldiv(b)),
                                   rtol=1e-5, atol=1e-6)
    if not values:
        F = _solver(A, **cfg)
        F.enable_device_refactor()
        for fld in ("diag_ids", "schur", "l_off_src", "u_off_src",
                    "diag_lvlslot"):
            assert np.array_equal(getattr(G._refactor_plan, fld),
                                  getattr(F._refactor_plan, fld)), fld


# ---------------------------------------------------------------------------
# the reference caveats of ROADMAP queue C, built in
# ---------------------------------------------------------------------------


def test_light_files_have_their_own_version(tmp_path):
    """A light file is not version 1 with a ``light`` entry (the JAX
    format): full and light saves carry versions 2 and 3, and a reader
    refuses any other."""
    A = poisson_2d(8, 8)
    F = _solver(A, chunk_size=8)
    full, light = tmp_path / "full.npz", tmp_path / "light.npz"
    F.save(full)
    F.save(light, values=False)
    with np.load(full) as zf, np.load(light) as zl:
        assert (int(zf["version"]), int(zl["version"])) == (2, 3)
        assert "light" not in zf and "light" not in zl
        arrays = {**dict(zl), "version": np.int64(4)}
    with pytest.raises(ValueError, match="unknown save version 4"):
        tlu.ParallelSparseLU.from_jax_arrays(A, arrays, device="cpu")


def test_light_save_leaves_the_solver_alone(rng, tmp_path):
    """``save(values=False)`` on a solver without a device refactor
    schedule plans one for the file only: the solver keeps its plans and
    solves the same bits (the JAX package rebuilds the solver's solve
    plans, tpu_sparse_lu/api.py:1270-1271)."""
    A = poisson_2d(12, 12)
    F = _solver(A, chunk_size=16)
    plan = {k: np.copy(v) for k, v in F.plan.arrays().items()}
    b = rng.random((A.shape[0], 2))
    x = F.ldiv(b)
    F.save(tmp_path / "light.npz", values=False)
    assert not F.has_device_refactor
    after = F.plan.arrays()
    assert all(np.array_equal(after[k], v) for k, v in plan.items())
    assert torch.equal(F.ldiv(b), x)


@pytest.mark.parametrize("values", [True, False], ids=["full", "light"])
def test_save_after_refactor_numeric_holds_current_values(rng, tmp_path,
                                                          values):
    """``a_data`` is the matrix the factors belong to: a save made after
    ``refactor_numeric(A2)`` reloads with ``A2`` and no value-change
    refactorization (the JAX package writes the construction's values,
    tpu_sparse_lu/api.py:1293, and would call ``A2`` a value change)."""
    A = poisson_2d(12, 12)
    F = _solver(A, chunk_size=16, ordering="nd")
    A2 = _perturb(rng, A, 0.05)
    F.refactor_numeric(A2)
    path = tmp_path / "state.npz"
    F.save(path, values=values)
    with np.load(path) as z:
        assert np.array_equal(z["a_data"], A2.data)
    G = _load(A2, path, on_value_change="error")
    b = rng.random(A.shape[0])
    assert_isapprox(G.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                    rtol=INV_TOL, atol=INV_TOL)
    with pytest.raises(ValueError, match="values differ"):
        _load(A, path, on_value_change="error")


def test_reload_guard_sees_the_solver_call(host_calls):
    """The factorize guard above patches the name the solver calls: a
    construction with the host backend is recorded, so a reload's empty
    record means something."""
    _solver(poisson_2d(6, 6), chunk_size=8)
    assert host_calls == [1]
