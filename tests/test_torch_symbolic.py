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


@pytest.mark.parametrize("field, value, item", [
    ("tri_mode", "trsm", "item 8"),
    ("tri_mode", "inv_refine", "item 8"),
])
def test_config_modes_not_ported_name_roadmap_item(field, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A {item}"):
        SolverConfig(**{field: value})


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
