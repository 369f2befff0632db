"""The port's host layer against the JAX package: configuration, the plan
arrays and the ldiv permutation vectors.

Both packages get the same matrix; the port's plan must equal the JAX
package's exactly (the planner is a copy, so any difference is a bug).
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.models import fe_block_matrix, poisson_2d, random_sparse
from tpu_sparse_lu_torch.utils.config import (
    SolverConfig,
    default_chunk_size,
    resolve_tri_mode,
)

MATRICES = {
    "poisson": lambda rng: poisson_2d(12, 12),
    "fe": lambda rng: fe_block_matrix(rng, 10, 5),
    "random": lambda rng: random_sparse(rng, 60, density=0.05),
}


def _plan_arrays(plan):
    out = {"n": plan.n, "cs": plan.cs, "p": plan.p, "q": plan.q,
           "Rs": plan.Rs, "qinv": plan.qinv}
    for name, tp in (("l", plan.lplan), ("u", plan.uplan)):
        for f in dataclasses.fields(tp):
            out[f"{name}_{f.name}"] = getattr(tp, f.name)
    return out


@pytest.mark.parametrize("ordering", ["colamd", "natural", "nd"])
@pytest.mark.parametrize("family", sorted(MATRICES))
def test_plan_arrays_equal_jax(rng, family, ordering):
    A = MATRICES[family](rng)
    cs = 16 if ordering == "nd" else 8
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
        chunk_size=cs, tri_mode="inv", ordering=ordering))
    tf = tlu.ParallelSparseLU(A, config=SolverConfig(
        chunk_size=cs, ordering=ordering), device="cpu")
    want, got = _plan_arrays(jf.plan), _plan_arrays(tf.plan)
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert tf.n_factor == jf.n_factor
    # the composite ldiv permutations (nd embedding included)
    K, c = tf.plan.lplan.K, tf.plan.cs
    pidx = np.full((K + 1) * c, -1)
    pidx[: tf.plan.n] = jf._pvec
    assert np.array_equal(tf._numeric.pidx.numpy(), pidx)
    assert np.array_equal(tf._numeric.qidx.numpy(), jf._qvec)
    if ordering == "nd":
        for k in ("src", "pos", "data_src"):
            assert np.array_equal(tf._ext[k], jf._ext[k]), k


def test_nd_cutoff_auto_picks_like_jax():
    A = poisson_2d(12, 12)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
        chunk_size=16, tri_mode="inv", ordering="nd", nd_cutoff="auto"))
    tf = tlu.ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", nd_cutoff="auto"), device="cpu")
    assert tf._nd_cutoff == jf._nd_cutoff
    assert tf.n_factor == jf.n_factor


def test_resolve_tri_mode_is_inv_everywhere():
    assert resolve_tri_mode("auto") == "inv"
    assert resolve_tri_mode("inv") == "inv"


@pytest.mark.parametrize("n, device_type, cs", [
    (10_000, "cuda", 128), (50, "cuda", 50), (100, "cpu", 8),
    (1000, "cpu", 32), (10_000, "cpu", 64), (3, "cpu", 3),
])
def test_default_chunk_size(n, device_type, cs):
    assert default_chunk_size(n, device_type) == cs


@pytest.mark.parametrize("mode", ["trsm", "inv_refine"])
def test_config_modes_construct(rng, mode):
    """Both modes construct, and a solver keeps the mode (``"auto"`` alone
    resolves)."""
    assert SolverConfig(tri_mode=mode).tri_mode == mode
    F = tlu.ParallelSparseLU(poisson_2d(6, 6), config=SolverConfig(
        chunk_size=8, tri_mode=mode), device="cpu")
    assert F.config.tri_mode == mode
    assert tlu.ParallelSparseLU(poisson_2d(6, 6), chunk_size=8,
                                device="cpu").config.tri_mode == "inv"


@pytest.mark.parametrize("family", sorted(MATRICES))
def test_symbolic_plan_save_load_roundtrip(rng, tmp_path, family):
    """``SymbolicPlan.save``/``load`` keep every array and its dtype, and
    the file is the JAX package's: each package reads the other's."""
    from tpu_sparse_lu.symbolic import SymbolicPlan as JaxPlan
    from tpu_sparse_lu_torch.symbolic import SymbolicPlan

    A = MATRICES[family](rng)
    tf = tlu.ParallelSparseLU(A, config=SolverConfig(chunk_size=8),
                              device="cpu")
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(chunk_size=8,
                                                         tri_mode="inv"))
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    tf.save_symbolic(mine)
    jf.save_symbolic(str(theirs))
    want = _plan_arrays(tf.plan)
    for got in (SymbolicPlan.load(mine), SymbolicPlan.load(theirs),
                JaxPlan.load(str(mine))):
        got = _plan_arrays(got)
        assert got.keys() == want.keys()
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert np.array_equal(a, b) and a.dtype == b.dtype, k


def test_saved_integers_load_by_value(tmp_path):
    """A 0-d entry loads as the Python scalar of its value, whatever the
    field's annotation; the JAX package's ``load_dc`` converts only fields
    annotated ``int`` (tpu_sparse_lu/api.py:1462-1468), so it would leave
    ``count`` and ``flag`` here 0-d arrays."""
    from typing import Optional

    from tpu_sparse_lu_torch.symbolic import (
        dataclass_arrays,
        dataclass_from_arrays,
    )

    @dataclasses.dataclass
    class Rec:
        count: Optional[int]
        flag: "np.bool_"
        scale: float
        rows: np.ndarray

    rec = Rec(count=7, flag=True, scale=0.5,
              rows=np.arange(4, dtype=np.int32))
    path = tmp_path / "rec.npz"
    np.savez(path, **dataclass_arrays(rec, "r_"))
    with np.load(path) as z:
        got = dataclass_from_arrays(Rec, z, "r_")
    assert type(got.count) is int and got.count == 7
    assert type(got.flag) is bool and got.flag
    assert type(got.scale) is float and got.scale == 0.5
    assert got.rows.dtype == np.int32 and np.array_equal(got.rows, rec.rows)


def test_config_accepts_bf16_stream():
    cfg = SolverConfig(stream_dtype="bfloat16", dtype="float32")
    assert cfg.stream_dtype == "bfloat16"
    assert SolverConfig().stream_dtype == "float32"


@pytest.mark.parametrize("kw", [
    {"tri_mode": "bogus"}, {"ordering": "metis"}, {"nd_cutoff": 1.5},
    {"stream_dtype": "float16"}, {"factorize": "gpu"}, {"dtype": "int32"},
])
def test_config_rejects_unknown_values(kw):
    with pytest.raises(ValueError):
        SolverConfig(**kw)


def test_config_has_no_tpu_knobs():
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    assert not names & {"use_pallas", "schedule", "matmul_precision"}


def test_import_leaves_jax_out():
    code = ("import sys, tpu_sparse_lu_torch; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# the native planner core (utils/_symcore.cpp) against the NumPy planner
# and against the JAX package's plans
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("tile_brow", "tile_bcol", "diag_dest", "offdiag_dest",
               "level_chunks", "level_tiles", "pad_idx",
               "level_chunk_counts", "level_tile_counts")
FACTOR_CASES = [(m, lower, extra) for m in ("poisson", "fe")
                for lower in (True, False) for extra in (False, True)]


@pytest.fixture
def core():
    from tpu_sparse_lu_torch.utils import _symcore_build

    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler to build the native core")
    c = _symcore_build.native()
    assert c is not None, "the native planner core did not build"
    return c


@pytest.fixture
def numpy_planner(monkeypatch):
    """Force the NumPy planner, as a failed build would."""
    from tpu_sparse_lu_torch.utils import _symcore_build

    def forced():
        monkeypatch.setattr(_symcore_build, "native", lambda: None)

    return forced


def _factor(rng, name, lower):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = poisson_2d(30, 30) if name == "poisson" else fe_block_matrix(
        rng, 40, 5)
    lu = spla.splu(sp.csc_matrix(A).astype(float), permc_spec="COLAMD")
    M = (lu.L if lower else lu.U).tocsc()
    M.sort_indices()
    return M


def _extra(lower, use):
    if not use:
        return None
    return [(5, 2), (7, 1)] if lower else [(2, 5), (1, 7)]


@pytest.mark.parametrize("name, lower, extra", FACTOR_CASES)
def test_plan_maps_native_matches_numpy(rng, core, numpy_planner, name,
                                        lower, extra):
    """plan_triangular through the native core (plan_maps and the level
    recurrence) against the forced NumPy planner, both factors, with and
    without extra closure tiles: the same arrays and dtypes."""
    from tpu_sparse_lu_torch import symbolic

    M = _factor(rng, name, lower)
    p_nat = symbolic.plan_triangular(M, 8, lower=lower,
                                     extra_tiles=_extra(lower, extra))
    numpy_planner()
    p_np = symbolic.plan_triangular(M, 8, lower=lower,
                                    extra_tiles=_extra(lower, extra))
    assert (p_nat.K, p_nat.T) == (p_np.K, p_np.T)
    for f in PLAN_FIELDS:
        a, b = getattr(p_nat, f), getattr(p_np, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_native_plan_maps_index_dtypes(rng, core, lower, index_dtype):
    """int32 and int64 CSC index arrays give the same maps, and a factor
    with entries on the wrong side raises as the NumPy planner does."""
    import scipy.sparse as sp

    M = _factor(rng, "fe", lower)
    K = -(-M.shape[0] // 8)
    want = core.plan_maps(M.indptr.astype(np.int64),
                          M.indices.astype(np.int64), 8, K, lower,
                          np.zeros(0, np.int64))
    got = core.plan_maps(M.indptr.astype(index_dtype),
                         M.indices.astype(index_dtype), 8, K, lower,
                         np.zeros(0, np.int64))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    wrong = sp.csc_matrix(M.T)
    with pytest.raises(ValueError, match="wrong side"):
        core.plan_maps(wrong.indptr, wrong.indices, 8, K, lower,
                       np.zeros(0, np.int64))


@pytest.mark.parametrize("name, lower", [(m, lo) for m in ("poisson", "fe")
                                         for lo in (True, False)])
def test_level_schedule_native_matches_numpy(rng, core, numpy_planner, name,
                                             lower):
    from tpu_sparse_lu_torch import symbolic

    p = symbolic.plan_triangular(_factor(rng, name, lower), 8, lower=lower)
    ub, uc = p.tile_brow[: p.T].astype(np.int64), p.tile_bcol[: p.T]
    nat = symbolic._level_schedule(ub, uc, p.K, lower)
    numpy_planner()
    ref = symbolic._level_schedule(ub, uc, p.K, lower)
    assert nat.dtype == ref.dtype == np.int64 and np.array_equal(nat, ref)


@pytest.mark.parametrize("family", sorted(MATRICES))
def test_blocked_fill_native_matches_python_and_jax(rng, core, numpy_planner,
                                                    family):
    """The closure from the native core, from the Python loop and from
    the JAX package's ``blocked_fill`` on the same tile set."""
    from tpu_sparse_lu.refactor import blocked_fill as jax_fill
    from tpu_sparse_lu_torch.refactor import blocked_fill

    tf = tlu.ParallelSparseLU(MATRICES[family](rng), config=SolverConfig(
        chunk_size=8), device="cpu")
    tiles = set()
    for tp in (tf.plan.lplan, tf.plan.uplan):
        tiles |= set(zip(tp.tile_brow[: tp.T].tolist(),
                         tp.tile_bcol[: tp.T].tolist()))
    K = tf.plan.lplan.K
    nat = blocked_fill(tiles, K)
    assert nat == jax_fill(tiles, K)
    numpy_planner()
    assert blocked_fill(tiles, K) == nat
    assert blocked_fill(set(), 3) == {(0, 0), (1, 1), (2, 2)}


@pytest.mark.parametrize("name, lower, extra", FACTOR_CASES)
def test_native_plans_equal_jax(rng, core, name, lower, extra):
    """The port's plan_triangular (native core) equals the JAX package's
    array by array on the same factor."""
    from tpu_sparse_lu import symbolic as jsym
    from tpu_sparse_lu_torch import symbolic

    M = _factor(rng, name, lower)
    got = symbolic.plan_triangular(M, 8, lower=lower,
                                   extra_tiles=_extra(lower, extra))
    want = jsym.plan_triangular(M, 8, lower=lower,
                                extra_tiles=_extra(lower, extra))
    for f in PLAN_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_native_build_failure_warns_and_serves(tmp_path, rng):
    """A compiler that does not exist: the build warns once with the
    cause and returns None, raising nothing; the NumPy planner serves."""
    from tpu_sparse_lu_torch.utils import _symcore_build

    src = tmp_path / "_symcore.cpp"
    src.write_bytes(_symcore_build._SRC.read_bytes())
    with pytest.warns(RuntimeWarning, match="did not build.*NumPy"):
        got = _symcore_build.load(src, tmp_path / "build",
                                  cxx=str(tmp_path / "no-such-g++"))
    assert got is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_build_is_keyed_by_source(tmp_path, core):
    """An edited source builds a new library; the same source loads the
    one it built."""
    from tpu_sparse_lu_torch.utils import _symcore_build

    src = tmp_path / "_symcore.cpp"
    src.write_bytes(_symcore_build._SRC.read_bytes())
    out = tmp_path / "build"
    assert _symcore_build.load(src, out) is not None
    first = sorted(out.glob("*.so"))
    assert _symcore_build.load(src, out) is not None
    assert sorted(out.glob("*.so")) == first and len(first) == 1
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _symcore_build.load(src, out) is not None
    assert len(list(out.glob("*.so"))) == 2


def test_root_exports_match_jax():
    """The port's package root exports the JAX package's public names
    (and its own ``models``)."""
    assert set(tlu.__all__) - {"models"} == set(jlu.__all__)
    for name in tlu.__all__:
        assert getattr(tlu, name) is not None
    x = tlu.allocate_shared((4, 3), device="cpu")
    assert x.shape == (4, 3) and x.dtype == torch.float32
    assert float(x.abs().sum()) == 0.0
