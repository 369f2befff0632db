"""The port's ``ParallelSparseLU`` lifecycle against the JAX package.

Same matrices and right-hand sides through both packages, on the CPU:
``lsolve``/``rsolve``, ``ldiv`` with and without refinement (nd embedding
included), host ``refactor`` with new values and with a new pattern, the
``L @ U == (Rs·A)[p, q]`` contract and the error paths, in the three
``tri_mode`` values. Float64 results are held to 1e-9 at ``"inv"``, the
JAX package's own bar for it (tests/test_solve.py:111), and to the
reference's 1e-12 at ``"trsm"`` and ``"inv_refine"``
(test/runtests.jl:25); float32 results to the JAX f32 tolerances.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from _approx import assert_isapprox

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.models import (
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
    random_sparse,
)

INV_TOL = 1e-9
TOL = 1e-12  # the reference's sparse bar (test/runtests.jl:25)
MODE_TOL = {"inv": INV_TOL, "trsm": TOL, "inv_refine": TOL}
MODES = sorted(MODE_TOL)

CASES = {
    "fe": (lambda rng: fe_block_matrix(rng, 10, 5), dict(chunk_size=8)),
    "poisson": (lambda rng: poisson_2d(12, 12), dict(chunk_size=16)),
    "poisson_nd": (lambda rng: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd")),
    "laplace_mmd": (lambda rng: laplacian_1d(50),
                    dict(chunk_size=8, ordering="mmd")),
    "random_natural": (lambda rng: random_sparse(rng, 60, density=0.05),
                       dict(chunk_size=8, ordering="natural")),
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


def _pair(A, **cfg):
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **cfg))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                              device="cpu")
    return jf, tf


@pytest.mark.parametrize("case", sorted(CASES))
def test_lsolve_rsolve_match_jax(rng, case):
    make, cfg = CASES[case]
    jf, tf = _pair(make(rng), **cfg)
    b = rng.random(tf.n_factor)
    B = rng.random((tf.n_factor, 3))
    for name in ("lsolve", "rsolve"):
        for rhs in (b, B):
            got = getattr(tf, name)(rhs)
            assert isinstance(got, torch.Tensor) and got.shape == rhs.shape
            assert_isapprox(got.numpy(), np.asarray(getattr(jf, name)(rhs)),
                            rtol=INV_TOL, atol=INV_TOL, msg=name)


@pytest.mark.parametrize("refine_steps", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ldiv_matches_jax(rng, case, refine_steps):
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _pair(A, **cfg)
    if case == "poisson_nd":
        assert tf.n_factor > tf.n
    for rhs in (rng.random(A.shape[0]), rng.random((A.shape[0], 4))):
        got = tf.ldiv(rhs, refine_steps=refine_steps)
        assert got.dtype == torch.float64 and got.shape == rhs.shape
        want = np.asarray(jf.ldiv(rhs, refine_steps=refine_steps))
        assert_isapprox(got.numpy(), want, rtol=INV_TOL, atol=INV_TOL)
        assert_isapprox(got.numpy(), spla.spsolve(A.tocsc(), rhs),
                        rtol=INV_TOL, atol=INV_TOL)
    # solve and __call__ are ldiv; on CPU tensors the kernel path is the
    # plain path
    rhs = rng.random(A.shape[0])
    assert torch.equal(tf.solve(rhs), tf.ldiv(rhs))
    assert torch.equal(tf(rhs), tf.ldiv(rhs))
    B = torch.as_tensor(rng.random((A.shape[0], 2)))
    N = tf._numeric
    assert torch.equal(N.tiles(B, plain=True), N.tiles(B))


@pytest.mark.parametrize("case", ["poisson", "poisson_nd"])
def test_f32_ldiv_matches_jax(rng, case):
    """float32: the same bars as the JAX f32 tests (test_pallas.py:82 for
    the direct solve, test_solve.py:303 for the refined backward error)."""
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _pair(A, dtype="float32", **cfg)
    B = rng.random((A.shape[0], 4)).astype(np.float32)
    got = tf.ldiv(B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.ldiv(B)),
                               rtol=1e-5, atol=1e-6)
    X = tf.ldiv(B, refine_steps=1).numpy().astype(np.float64)
    An = spla.norm(A)
    for j in range(B.shape[1]):
        r = np.linalg.norm(A @ X[:, j] - B[:, j]) / (
            An * np.linalg.norm(X[:, j]) + np.linalg.norm(B[:, j]))
        assert r < 5e-6, f"backward error {r}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_refactor_new_values_matches_jax(rng, case):
    """The reference lifecycle: solve, refactor with new values (same
    pattern), solve again — both packages, same inputs."""
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _pair(A, **cfg)
    b = rng.random(A.shape[0])
    assert_isapprox(tf.ldiv(b).numpy(), np.asarray(jf.ldiv(b)),
                    rtol=INV_TOL, atol=INV_TOL)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + rng.random(A2.data.shape[0]))
    jf.refactor(A2)
    tf.refactor(A2)
    assert np.array_equal(tf.p, jf.p) and np.array_equal(tf.q, jf.q)
    b2 = rng.random(A.shape[0])
    got = tf.ldiv(b2).numpy()
    assert_isapprox(got, np.asarray(jf.ldiv(b2)), rtol=INV_TOL, atol=INV_TOL)
    assert_isapprox(got, spla.spsolve(A2.tocsc(), b2), rtol=INV_TOL,
                    atol=INV_TOL)
    assert_isapprox(tf.matvec(got).numpy(), A2 @ got, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ordering", ["colamd", "nd"])
def test_refactor_new_pattern_replans(rng, ordering):
    A = poisson_2d(12, 12)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering=ordering), device="cpu")
    K0 = tf.plan.lplan.K
    A2 = (A + sp.diags(np.full(A.shape[0] - 12, -0.5), 12)
          + sp.diags(np.full(A.shape[0] - 12, -0.5), -12)).tocsc()
    A2 = (A2 + sp.random(A.shape[0], A.shape[0], density=0.02,
                         random_state=np.random.RandomState(3))).tocsc()
    A2 = A2 + sp.diags(np.full(A.shape[0], 10.0))
    tf.refactor(A2)
    b = rng.random(A.shape[0])
    assert_isapprox(tf.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                    rtol=INV_TOL, atol=INV_TOL)
    assert tf.plan.lplan.K >= K0


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_contract(rng, case):
    """L @ U == (Rs .* A)[p, q] (reference src:292-316), on the matrix the
    factors belong to (the nd extension under ordering="nd")."""
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _pair(A, **cfg)
    Af = A if tf._ext is None else sp.csc_matrix(
        (tf._ext_values(sp.csc_matrix(A)), tf._a_factor_pattern[1],
         tf._a_factor_pattern[0]), shape=(tf.n_factor, tf.n_factor))
    lhs = (tf.L @ tf.U).toarray()
    rhs = (sp.diags(tf.Rs) @ Af).toarray()[tf.p][:, tf.q]
    assert_isapprox(lhs, rhs, rtol=1e-12, atol=1e-12)
    for name in ("L", "U"):
        assert (getattr(tf, name) != getattr(jf, name)).nnz == 0
    for name in ("p", "q", "Rs"):
        assert np.array_equal(getattr(tf, name), getattr(jf, name))
    assert (tf.m, tf.n, tf.n_factor) == (jf.m, jf.n, jf.n_factor)
    assert (tf.chunk_size, tf.total_chunks) == (jf.chunk_size,
                                                jf.total_chunks)


def test_wrong_size_rhs_raises(rng):
    tf = tlu.ParallelSparseLU(poisson_2d(6, 6), chunk_size=8, device="cpu")
    with pytest.raises(ValueError, match="same size"):
        tf.ldiv(rng.random(35))
    with pytest.raises(ValueError, match="same size"):
        tf.lsolve(rng.random((37, 2)))
    with pytest.raises(ValueError, match="same size"):
        tf.ldiv(rng.random((36, 2, 2)))
    with pytest.raises(ValueError):
        tf.refactor(poisson_2d(5, 5))


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available on this machine")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlu.ParallelSparseLU(poisson_2d(6, 6), chunk_size=8, device="cuda")


def test_device_is_required():
    with pytest.raises(TypeError):
        tlu.ParallelSparseLU(poisson_2d(6, 6), chunk_size=8)


@pytest.mark.parametrize("values, version", [(True, 2), (False, 3)])
def test_save_reload_solves_like_the_saved_solver(rng, tmp_path, values,
                                                  version):
    """A full save reloads to the same bits; a light one (no factor
    values) to those of ``refactor_numeric`` on the saved solver."""
    A = poisson_2d(6, 6)
    F = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    path = tmp_path / "state.npz"
    F.save(path, values=values)
    with np.load(path) as z:
        assert int(z["version"]) == version
        assert ("L_data" in z) is values
    G = tlu.ParallelSparseLU.from_saved(A, path, device="cpu")
    if not values:
        F.refactor_numeric(A)
    b = rng.random((A.shape[0], 2))
    assert torch.equal(G.ldiv(b), F.ldiv(b))


def test_make_f64_ldiv_is_ported(rng):
    A = poisson_2d(6, 6)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=8, dtype="float32"), device="cpu")
    b = rng.random(A.shape[0])
    x = F.make_f64_ldiv()(b)
    assert x.dtype == torch.float64 and x.shape == b.shape
    assert_isapprox(x.numpy(), spla.spsolve(A.tocsc(), b), rtol=1e-12,
                    atol=1e-12)


def test_from_jax_arrays_checks_matrix(rng, tmp_path):
    A = poisson_2d(8, 8)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(chunk_size=8,
                                                         tri_mode="inv"))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        arrays = dict(z)
    tf = tlu.ParallelSparseLU.from_jax_arrays(A, arrays, device="cpu")
    b = rng.random(A.shape[0])
    assert_isapprox(tf.ldiv(b).numpy(), np.asarray(jf.ldiv(b)),
                    rtol=INV_TOL, atol=INV_TOL)
    A2 = A.copy()
    A2.data *= 2.0
    with pytest.raises(ValueError, match="values differ"):
        tlu.ParallelSparseLU.from_jax_arrays(A2, arrays, device="cpu")
    with pytest.raises(ValueError, match="pattern differs"):
        tlu.ParallelSparseLU.from_jax_arrays(
            A + sp.diags(np.ones(59), 5), arrays, device="cpu")
    # a JAX light save (no factor values) loads too
    light = tmp_path / "light.npz"
    jf.save(str(light), values=False)
    with np.load(light) as z:
        assert "light" in z and "L_data" not in z
        tl = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    assert tl.has_device_refactor
    assert_isapprox(tl.ldiv(b).numpy(), np.asarray(jf.ldiv(b)),
                    rtol=INV_TOL, atol=INV_TOL)


def test_close_releases_device_state():
    F = tlu.ParallelSparseLU(poisson_2d(6, 6), chunk_size=8, device="cpu")
    tlu.cleanup_ParallelSparseLU(F)
    assert F._numeric is None


# ---------------------------------------------------------------------------
# tri_mode: "trsm" and "inv_refine" beside "inv"
# ---------------------------------------------------------------------------

MODE_CASES = {
    # tests/test_solve.py:102-112
    "fe": (lambda rng: fe_block_matrix(rng, 12, 5), dict(chunk_size=8)),
    "poisson_nd": (lambda rng: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd")),
}


def _mode_pair(A, mode, **cfg):
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode=mode,
                                                         **cfg))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(tri_mode=mode,
                                                         **cfg),
                              device="cpu")
    return jf, tf


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_modes_match_jax_and_spsolve(rng, case, mode):
    """The ``test_modes_and_schedules`` family: each mode against the JAX
    package in the same mode and against ``spsolve``."""
    make, cfg = MODE_CASES[case]
    A = make(rng)
    jf, tf = _mode_pair(A, mode, **cfg)
    assert tf.config.tri_mode == mode
    assert (tf._numeric.sched is None) is (mode != "inv")
    tol = MODE_TOL[mode]
    for rhs in (rng.random(A.shape[0]), rng.random((A.shape[0], 3))):
        got = tf.ldiv(rhs)
        assert got.dtype == torch.float64 and got.shape == rhs.shape
        assert_isapprox(got.numpy(), np.asarray(jf.ldiv(rhs)), rtol=tol,
                        atol=tol)
        assert_isapprox(got.numpy(), spla.spsolve(A.tocsc(), rhs), rtol=tol,
                        atol=tol)
    B = torch.as_tensor(rng.random((A.shape[0], 2)))
    N = tf._numeric
    assert torch.equal(N.tiles(B, plain=True), N.tiles(B))


@pytest.mark.parametrize("mode", ["trsm", "inv_refine"])
@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_lsolve_rsolve_modes(rng, case, mode):
    """``lsolve``/``rsolve`` take the mode's diagonal step: 1e-12 against
    ``spsolve_triangular`` and the JAX package in the same mode."""
    make, cfg = MODE_CASES[case]
    jf, tf = _mode_pair(make(rng), mode, **cfg)
    B = rng.random((tf.n_factor, 3))
    for name, M, lower in (("lsolve", tf.L, True), ("rsolve", tf.U, False)):
        got = getattr(tf, name)(B).numpy()
        assert_isapprox(got, np.asarray(getattr(jf, name)(B)), rtol=TOL,
                        atol=TOL, msg=name)
        assert_isapprox(got, spla.spsolve_triangular(M.tocsr(), B,
                                                     lower=lower),
                        rtol=TOL, atol=TOL, msg=name)


@pytest.mark.parametrize("mode", ["trsm", "inv_refine"])
def test_f32_modes_match_jax(rng, mode):
    """float32 in the new modes: the JAX f32 bars of the ``inv`` test
    above (``test_f32_ldiv_matches_jax``)."""
    make, cfg = MODE_CASES["poisson_nd"]
    A = make(rng)
    jf, tf = _mode_pair(A, mode, dtype="float32", **cfg)
    B = rng.random((A.shape[0], 4)).astype(np.float32)
    got = tf.ldiv(B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.ldiv(B)),
                               rtol=1e-5, atol=1e-6)
    X = tf.ldiv(B, refine_steps=1).numpy().astype(np.float64)
    An = spla.norm(A)
    for j in range(B.shape[1]):
        r = np.linalg.norm(A @ X[:, j] - B[:, j]) / (
            An * np.linalg.norm(X[:, j]) + np.linalg.norm(B[:, j]))
        assert r < 5e-6, f"backward error {r}"


def test_bf16_stream_is_ignored_outside_inv(rng):
    """Only the one-launch ``"inv"`` solve reads a bfloat16 stream; a
    ``"trsm"`` solver with ``stream_dtype="bfloat16"`` solves on its
    float32 bank, as the JAX package does."""
    A = poisson_2d(12, 12)
    cfg = dict(chunk_size=16, ordering="nd", dtype="float32",
               tri_mode="trsm")
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        stream_dtype="bfloat16", **cfg), device="cpu")
    F32 = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                               device="cpu")
    N = F._numeric
    assert N.ldata.tiles_bf16 is None and N.udata.tiles_bf16 is None
    b = rng.random((A.shape[0], 2)).astype(np.float32)
    assert torch.equal(F.ldiv(b), F32.ldiv(b))


def test_modes_keep_the_diagonal_tiles(rng):
    """After a host pack every mode keeps ``D`` beside the inverses, its
    padding rows and dummy slot the identity (``trsm`` divides by
    them)."""
    A = poisson_2d(7, 5)  # n = 35: the last chunk of 8 is padded
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=8, tri_mode="trsm"), device="cpu")
    for data in (F._numeric.ldata, F._numeric.udata):
        D = data.diag
        assert D.shape == (data.K + 1, 8, 8)
        assert torch.equal(D[-1], torch.eye(8, dtype=D.dtype))
        pad = F.n_factor - (data.K - 1) * 8
        assert torch.equal(D[data.K - 1, pad:, pad:],
                           torch.eye(8 - pad, dtype=D.dtype))
        ident = torch.bmm(D, data.diag_inv)
        torch.testing.assert_close(ident, torch.eye(8, dtype=D.dtype)
                                   .expand_as(ident), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The reference's testsets 1-6 on the port's default configuration (no
# config at all: "auto" resolves to "inv", the CPU default chunk size),
# mirroring tests/test_solve.py:53-101 at the reference's bars.
# ---------------------------------------------------------------------------

DENSE_TOL = 1e-10  # the reference's dense bar (test/runtests.jl:26)
DENSE_SIZES = [1, 2, 3, 7, 8, 9, 20, 33, 64, 100, 129]
FE_SIZES = [1, 2, 5, 16, 50, 100, 200]


def _default_lifecycle(rng, make_matrix, tol):
    A = make_matrix()
    n = A.shape[0]
    F = tlu.ParallelSparseLU(A, device="cpu")
    assert F.config.tri_mode == "inv"
    b = rng.random(n)
    # lsolve / rsolve alone (runtests.jl:38-106)
    assert_isapprox(F.lsolve(b).numpy(), spla.spsolve_triangular(
        sp.csr_matrix(F.L), b, lower=True), rtol=tol, atol=tol)
    assert_isapprox(F.rsolve(b).numpy(), spla.spsolve_triangular(
        sp.csr_matrix(F.U), b, lower=False), rtol=tol, atol=tol)
    # full solve, then a new right-hand side (runtests.jl:108-126)
    for _ in range(2):
        b = rng.random(n)
        assert_isapprox(F.ldiv(b).numpy(), spla.spsolve(A, b), rtol=tol,
                        atol=tol)
    # new values, refactor in place, solve twice (runtests.jl:129-144)
    A2 = make_matrix()
    F.refactor(A2)
    for _ in range(2):
        b = rng.random(n)
        assert_isapprox(F.ldiv(b).numpy(), spla.spsolve(A2, b), rtol=tol,
                        atol=tol)


@pytest.mark.parametrize("n", DENSE_SIZES)
def test_reference_dense_default_config(rng, n):
    from tpu_sparse_lu_torch.models import dense_random

    _default_lifecycle(rng, lambda: dense_random(rng, n), DENSE_TOL)


@pytest.mark.parametrize("nel", FE_SIZES)
def test_reference_sparse_default_config(rng, nel):
    from tpu_sparse_lu_torch.models import fe_block_matrix as fe

    _default_lifecycle(rng, lambda: fe(rng, nel, 5), TOL)
