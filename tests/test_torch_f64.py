"""The port's f64 mixed-precision tier and bfloat16 tile stream against the
JAX package.

``make_f64_ldiv`` is held to the reference's 1e-12 bar against ``spsolve``
on the families of ``tests/test_solve.py:336-365``, to the JAX tier within
1e-12 on the very same factorization (``from_jax_arrays``), and to the
generation guard of ``tests/test_round5.py:61-96``. Unlike the JAX tier it
refines against the current matrix after ``refactor_numeric`` (the JAX
package keeps the values of the last host factorization there). The
bfloat16 stream (``SolverConfig.stream_dtype``) is held to
``tests/test_pallas.py:317-356``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch
from _approx import assert_isapprox

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch import trace
from tpu_sparse_lu.models import (
    block_banded,
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
    random_sparse,
)
from tpu_sparse_lu.ops.pallas_ldiv import (
    SRC_LDINV,
    SRC_LOFF,
    SRC_PERMP,
    SRC_PERMQ,
    SRC_UDINV,
    SRC_UOFF,
    build_ldiv_ops,
    build_lu_stream,
    build_perm_stream,
    pallas_fused_ldiv,
    stream_gather_spec,
)
from tpu_sparse_lu.solve import block_rhs as jax_block_rhs
from tpu_sparse_lu.solve import unblock_rhs as jax_unblock_rhs
from tpu_sparse_lu_torch.ops.fused_ldiv import (
    make_wave,
    perm_gather_plain,
    wave_apply,
    wave_apply_bf16,
    wave_apply_plain,
)

TOL = 1e-12  # reference sparse bar, runtests.jl:25

FAMILIES = {
    "fe": lambda rng: fe_block_matrix(rng, 40, 5),
    "poisson": lambda rng: poisson_2d(14, 14),
    "banded": lambda rng: block_banded(rng, 16, 8),
    "spsm": lambda rng: random_sparse(rng, 256, density=0.02),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _rel(x, ref) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _f32(A, **cfg):
    cfg = {"chunk_size": 16, "dtype": "float32", **cfg}
    return tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                                device="cpu")


def _carried(A, tmp_path, **cfg):
    """A JAX solver and the port solver built from its saved state."""
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **cfg))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        tf = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    return jf, tf


# ---------------------------------------------------------------------------
# make_f64_ldiv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f64_tier_meets_1e12_bar(rng, family):
    A = FAMILIES[family](rng)
    n = A.shape[0]
    F = _f32(A)
    solve = F.make_f64_ldiv(refine_steps=2)
    B = rng.random((n, 3))
    X = solve(B)
    assert X.dtype == torch.float64 and X.shape == (n, 3)
    rel = _rel(X, spla.spsolve(A.tocsc(), B))
    assert rel < TOL, f"{family}: rel err {rel} misses the 1e-12 bar"
    # a single vector squeezes like ldiv
    b = rng.random(n)
    x = solve(b)
    assert x.shape == (n,)
    assert_isapprox(x.numpy(), spla.spsolve(A.tocsc(), b), rtol=TOL,
                    atol=TOL)


@pytest.mark.parametrize("case", ["fe", "poisson_nd", "chain"])
def test_f64_tier_matches_jax(rng, tmp_path, case):
    """The same factorization through both tiers (the JAX one with its
    DIA/tile f64 residual, the port's with a sparse CSR one)."""
    A, cfg = {
        "fe": (fe_block_matrix(rng, 20, 5), dict(chunk_size=16)),
        "poisson_nd": (poisson_2d(12, 12), dict(chunk_size=16,
                                                ordering="nd")),
        "chain": (laplacian_1d(500), dict(chunk_size=128,
                                          ordering="natural",
                                          pivot_threshold=0.0)),
    }[case]
    jf, tf = _carried(A, tmp_path, dtype="float32", **cfg)
    assert tf._numeric.chain == (case == "chain")
    B = rng.random((A.shape[0], 2))
    want = np.asarray(jf.make_f64_ldiv(refine_steps=2)(jnp.asarray(B)))
    got = tf.make_f64_ldiv(refine_steps=2)(B).numpy()
    assert _rel(got, want) < TOL
    assert _rel(got, spla.spsolve(A.tocsc(), B)) < TOL


def test_f64_tier_guards(rng):
    """make_f64_ldiv refuses a non-f32 factorization and a wrong-size b."""
    A = fe_block_matrix(rng, 5, 5)
    F64 = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=8, dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="f32 factorization"):
        F64.make_f64_ldiv()
    F = _f32(A, chunk_size=8)
    solve = F.make_f64_ldiv(refine_steps=1)
    with pytest.raises(ValueError, match="same size"):
        solve(np.ones(A.shape[0] + 1))
    with pytest.raises(ValueError, match="same size"):
        solve(np.ones((A.shape[0], 2, 2)))


@pytest.mark.parametrize("how", ["refactor", "refactor_none",
                                 "refactor_numeric"])
def test_f64_tier_stale_after_refactorization(rng, how):
    """make_f64_ldiv -> a refactorization -> call raises; a fresh callable
    serves the new values (tests/test_round5.py:65-96, plus the device
    refactorization)."""
    A = poisson_2d(12, 12)
    F = _f32(A, ordering="nd")
    solve = F.make_f64_ldiv(refine_steps=1)
    b = rng.random(A.shape[0])
    assert_isapprox(solve(b).numpy(), spla.spsolve(A.tocsc(), b),
                    rtol=1e-10, atol=1e-10)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * rng.random(A2.nnz))
    if how == "refactor":
        F.refactor(A2)
    elif how == "refactor_none":
        A2 = A
        F.refactor(None)
    else:
        F.refactor_numeric(A2)
    with pytest.raises(RuntimeError, match="stale make_f64_ldiv"):
        solve(b)
    solve2 = F.make_f64_ldiv(refine_steps=2)
    assert_isapprox(solve2(b).numpy(), spla.spsolve(A2.tocsc(), b),
                    rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["poisson_nd", "chain"])
def test_f64_tier_after_refactor_numeric_uses_new_values(rng, case):
    """A fresh make_f64_ldiv after refactor_numeric refines against the
    NEW matrix. The JAX tier builds its residual from the values of the
    last host factorization here (tpu_sparse_lu/api.py:840-845, :282):
    0.18 relative error against the new matrix on this poisson case."""
    if case == "chain":
        A = laplacian_1d(400)
        cfg = dict(chunk_size=128, ordering="natural", pivot_threshold=0.0)
    else:
        A = poisson_2d(12, 12)
        cfg = dict(ordering="nd")
    F = _f32(A, **cfg)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.2 * rng.random(A2.nnz))
    F.refactor_numeric(A2)
    assert F._a64.dtype == torch.float64
    np.testing.assert_array_equal(F._a64.numpy(), A2.data)
    b = rng.random((A.shape[0], 2))
    x = F.make_f64_ldiv(refine_steps=3)(b)
    assert _rel(x, spla.spsolve(A2.tocsc(), b)) < TOL
    assert _rel(x, spla.spsolve(A.tocsc(), b)) > 1e-3  # not the old matrix


@pytest.mark.parametrize("case", ["poisson_nd", "chain"])
def test_f64_tier_sweeps_are_residual_spans(rng, case):
    """Each sweep of the f64 tier is a residual span, a direct solve and
    an update span, as ``ldiv``'s refinement; the result is the bits of
    the sweeps written out."""
    if case == "chain":
        F = _f32(laplacian_1d(400), chunk_size=128, ordering="natural",
                 pivot_threshold=0.0)
    else:
        F = _f32(poisson_2d(12, 12), ordering="nd")
    direct = "lu.ldiv.chain" if case == "chain" else "lu.ldiv.launch"
    solve = F.make_f64_ldiv(refine_steps=3)
    b = torch.as_tensor(rng.random((F.n, 2)))
    trace.reset()
    x = solve(b)
    got = trace.totals()
    assert got["lu.ldiv.residual"][0] == 6 and got[direct][0] == 4
    N, A64 = F._numeric, F._csr_matrix(F._a64)
    want = N.solve(b.float()).double()
    for _ in range(3):
        want = want + N.solve((b - A64 @ want).float()).double()
    assert torch.equal(x, want)


def test_f64_tier_keeps_float64_values(rng):
    """The residual uses A's float64 values, not the float32 copy."""
    A = poisson_2d(8, 8)
    A.data = A.data * (1.0 + 1e-9 * rng.random(A.nnz))  # below float32
    F = _f32(A)
    np.testing.assert_array_equal(F._a64.numpy(), A.data)
    assert F._A_dev.dtype == torch.float32
    b = rng.random(A.shape[0])
    x = F.make_f64_ldiv(refine_steps=2)(b)
    assert _rel(x, spla.spsolve(A.tocsc(), b)) < TOL


# ---------------------------------------------------------------------------
# stream_dtype="bfloat16"
# ---------------------------------------------------------------------------


def _jax_bf16_ldiv(F, b):
    """JAX fused Pallas ldiv with the bf16 stream, in interpret mode."""
    ops = build_ldiv_ops(F._pvec, F.plan.lplan, F.plan.uplan, F._qvec,
                         KA=F._K_in)
    sizes = {
        SRC_PERMP: ops.res_p.shape[0],
        SRC_LDINV: F.plan.lplan.K + 1,
        SRC_LOFF: F.plan.lplan.T + 1,
        SRC_UDINV: F.plan.uplan.K + 1,
        SRC_UOFF: F.plan.uplan.T + 1,
        SRC_PERMQ: ops.res_q.shape[0],
    }
    s_perm = build_perm_stream(
        jnp.asarray(stream_gather_spec(ops, sizes, 0)),
        jnp.asarray(ops.res_p), jnp.asarray(ops.res_q))
    s_lu = build_lu_stream(
        jnp.asarray(stream_gather_spec(ops, sizes, 1)),
        F.ldata.diag_inv, F.ldata.offdiag,
        F.udata.diag_inv, F.udata.offdiag, dtype=F._stream_dt)
    assert s_lu.dtype == jnp.bfloat16
    xw = jax_block_rhs(b, F.n, F._K_in, F.plan.cs) * F._rs_blk
    out = pallas_fused_ldiv(ops, s_perm, s_lu, xw, interpret=True)
    return np.asarray(jax_unblock_rhs(out, F.n))


def test_bf16_stream_is_half_width(rng):
    A = poisson_2d(10, 8)
    F = _f32(A, chunk_size=8, stream_dtype="bfloat16")
    F32 = _f32(A, chunk_size=8)
    assert F._stream_dt == torch.bfloat16 and F32._stream_dt == torch.float32
    N, N32 = F._numeric, F32._numeric
    for data, ref in ((N.ldata, N32.ldata), (N.udata, N32.udata)):
        assert data.tiles_bf16.dtype == torch.bfloat16
        assert data.tiles_bf16.element_size() == 2
        assert ref.tiles_bf16 is None
        # the bank itself stays at the solver's dtype
        assert data.tiles_t.dtype == torch.float32
        torch.testing.assert_close(data.tiles_bf16,
                                   data.tiles_t.to(torch.bfloat16),
                                   rtol=0, atol=0)
    # F.L / F.U are not quantized
    np.testing.assert_array_equal(F.L.toarray(), F32.L.toarray())
    np.testing.assert_array_equal(F.U.toarray(), F32.U.toarray())


@pytest.mark.parametrize("R", [1, 4])
def test_bf16_plain_waves_match_jax_fused_ldiv(rng, tmp_path, R):
    """The port's plain bf16 waves on the JAX solver's own bf16 tiles
    against the JAX fused kernel with the bf16 stream: both widen each
    tile exactly to float32, so only the order of the sums differs
    (the bar of tests/test_pallas.py:82)."""
    A = poisson_2d(10, 8)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
        chunk_size=8, tri_mode="inv", dtype="float32",
        stream_dtype="bfloat16"))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        tf = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    b = rng.random((A.shape[0], R)).astype(np.float32)
    want = _jax_bf16_ldiv(jf, jnp.asarray(b))
    N = tf._numeric
    xw = perm_gather_plain(torch.as_tensor(b), N.pidx, N.rs).view(
        tf.plan.lplan.K + 1, tf.plan.cs, R)
    for jdata, data in ((jf.ldata, N.ldata), (jf.udata, N.udata)):
        bank = np.concatenate([np.asarray(jdata.diag_inv),
                               np.asarray(jdata.offdiag)])
        bank = torch.as_tensor(bank.transpose(0, 2, 1).copy()).to(
            torch.bfloat16)
        for w in data.waves:
            wave_apply_bf16(xw, bank, w)
    got = perm_gather_plain(xw.view(-1, R), N.qidx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R", [1, 4])
def test_bf16_direct_and_refined_error(rng, R):
    """tests/test_pallas.py:317-356 through the port's ldiv and
    make_f64_ldiv."""
    A = poisson_2d(10, 8)
    n = A.shape[0]
    F = _f32(A, chunk_size=8, stream_dtype="bfloat16")
    b = rng.random((n, R)).astype(np.float32)
    want = spla.spsolve(A.tocsc(), b.astype(np.float64)).reshape(n, R)
    rel = _rel(F.ldiv(b), want)
    assert rel < 3e-2, f"bf16 direct solve rel err {rel}"  # ~8-bit tiles
    assert rel > 1e-6  # the stream really was quantized
    rel2 = _rel(F.make_f64_ldiv(refine_steps=4)(b.astype(np.float64)), want)
    assert rel2 < 1e-11, f"bf16 + 4 f64 sweeps rel err {rel2}"
    # lsolve/rsolve read the float32 bank, not the stream
    F32 = _f32(A, chunk_size=8)
    y = rng.random(F.n_factor)
    torch.testing.assert_close(F.lsolve(y), F32.lsolve(y), rtol=0, atol=0)
    torch.testing.assert_close(F.rsolve(y), F32.rsolve(y), rtol=0, atol=0)


def test_bf16_device_refactor_refreshes_stream(rng):
    A = poisson_2d(12, 12)
    F = _f32(A, ordering="nd", stream_dtype="bfloat16")
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.1 * rng.random(A2.nnz))
    old = F._numeric.ldata.tiles_bf16
    F.refactor_numeric(A2)
    assert F._numeric.ldata.tiles_bf16 is not old
    for data in (F._numeric.ldata, F._numeric.udata):
        torch.testing.assert_close(data.tiles_bf16,
                                   data.tiles_t.to(torch.bfloat16),
                                   rtol=0, atol=0)
    b = rng.random(A.shape[0])
    want = spla.spsolve(A2.tocsc(), b)
    rel = _rel(F.ldiv(b), want)
    assert 1e-6 < rel < 3e-2
    assert _rel(F.make_f64_ldiv(refine_steps=4)(b), want) < 1e-11
    # the fused step refreshes its own copy from the new bank
    step = F.make_refactor_solve_step(refine_steps=4)
    assert _rel(step(A2.data, b), want) < 1e-6


def test_bf16_stream_needs_float32_solver():
    with pytest.raises(ValueError, match="float32 factorization"):
        tlu.ParallelSparseLU(poisson_2d(6, 6), config=tlu.SolverConfig(
            chunk_size=8, dtype="float64", stream_dtype="bfloat16"),
            device="cpu")


@pytest.mark.parametrize("R", [1, 3])
def test_wave_apply_bf16_plain_semantics(rng, R):
    """x[dst] = acc·x[dst] + Σ tile·x[src] with bf16 tiles widened to
    float32, in place."""
    cs, nb = 4, 6
    x0 = rng.standard_normal((nb, cs, R)).astype(np.float32)
    tiles = torch.as_tensor(rng.standard_normal((5, cs, cs))).to(
        torch.bfloat16)
    tiles_f = tiles.double().numpy().transpose(0, 2, 1)
    dst, groups = [5, 1], [[(0, 0), (2, 2), (4, 4)], [(1, 2)]]
    want = x0.astype(np.float64)
    for d, g in zip(dst, groups):
        want[d] = want[d] + sum(tiles_f[t] @ x0[sb] for t, sb in g)
    x = torch.as_tensor(x0)
    out = wave_apply_bf16(x, tiles, make_wave(dst, groups, True, "cpu"))
    assert out is x and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-5, atol=1e-5)
    x2 = torch.as_tensor(x0)
    wave_apply_plain(x2, tiles, make_wave(dst, groups, True, "cpu"))
    torch.testing.assert_close(x2, x, rtol=0, atol=0)


def test_wave_wrappers_reject_mixed_dtypes():
    w = make_wave([0], [[(0, 0)]], False, "cpu")
    x = torch.zeros((1, 4, 1))
    bf = torch.zeros((1, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wave_apply_bf16"):
        wave_apply(x, bf, w)
    with pytest.raises(ValueError, match="float32 carrier"):
        wave_apply_bf16(x.double(), bf, w)
    with pytest.raises(ValueError, match="bfloat16 tiles"):
        wave_apply_bf16(x, torch.zeros((1, 4, 4)), w)
    with pytest.raises(ValueError, match="several devices"):
        wave_apply_bf16(x.to("meta"), bf.to("meta"), w)
    with pytest.raises(ValueError, match="past the carrier"):
        wave_apply_bf16(torch.zeros((0, 4, 1)), bf, w)
