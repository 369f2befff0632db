"""The port's host layer against the JAX package: configuration, the plan
arrays and the ldiv permutation vectors.

Both packages get the same matrix; the port's plan must equal the JAX
package's exactly (the planner is a copy, so any difference is a bug).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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
    assert np.array_equal(tf._pidx.numpy(), pidx)
    assert np.array_equal(tf._qidx.numpy(), jf._qvec)
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
