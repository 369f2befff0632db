"""The port's bidiagonal chain path (kernel B5) against the JAX package.

Mirrors ``tests/test_scan_solve.py``: the band detection and the affine
coefficient planes equal the JAX package's bit for bit, the plain version
of the chain kernel (``bidiag_ldiv_plain``, what a CPU tensor runs and what
the CUDA kernel is held against on the card) matches the JAX Pallas kernel
``pallas_bidiag_ldiv`` in interpret mode and ``scan_bidiag_solve``, and the
lifecycle dispatches to it as the JAX package does. Float64 results are
held to the bars of ``tests/test_scan_solve.py`` (rtol 1e-10, atol 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from _approx import assert_isapprox

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
import tpu_sparse_lu_torch.api as tapi
import tpu_sparse_lu_torch.solve as tsolve
from tpu_sparse_lu_torch import trace
from tpu_sparse_lu.models import laplacian_1d, poisson_2d
from tpu_sparse_lu.ops.scan_solve import bidiag_bands as jax_bidiag_bands
from tpu_sparse_lu.ops.scan_solve import (
    pack_bands_2d,
    pallas_bidiag_ldiv,
    scan_bidiag_solve,
)
from tpu_sparse_lu_torch.ops.bidiag_ldiv import (
    bidiag_ldiv,
    bidiag_ldiv_plain,
    bidiag_ldiv_tiled_plain,
    chain_words,
    tile_rows,
)
from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather, wave_apply
from tpu_sparse_lu_torch.ops.scan_solve import bidiag_bands, chain_planes

RTOL, ATOL = 1e-10, 1e-12  # tests/test_scan_solve.py


def _chain_cfg(dtype="float64", **kw):
    return dict(chunk_size=128, ordering="natural", pivot_threshold=0.0,
                dtype=dtype, **kw)


def _chain_pair(n, dtype="float64"):
    A = laplacian_1d(n)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **_chain_cfg(dtype)))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**_chain_cfg(dtype)),
                              device="cpu")
    return A, jf, tf


def _random_planes(rng, n, dtype):
    """A stable chain: |a| <= 0.9, s in [0.5, 1.5]."""
    return [rng.uniform(-0.9, 0.9, n).astype(dtype) if i % 2 == 0
            else rng.uniform(0.5, 1.5, n).astype(dtype) for i in range(4)]


@pytest.fixture
def chain_only(monkeypatch):
    """Counts the chain solves ``ParallelSparseLU`` runs; the tile waves
    must not run at all."""
    calls = []

    def counted(b, **planes):
        calls.append(sorted(planes))
        return bidiag_ldiv(b, **planes)

    def no_waves(*args, **kwargs):
        raise AssertionError("the tile waves ran on a chain")

    monkeypatch.setattr(tapi, "bidiag_ldiv", counted)
    monkeypatch.setattr(tsolve, "bidiag_ldiv", counted)
    monkeypatch.setattr(tsolve.DeviceFactors, "tiles", no_waves)
    monkeypatch.setattr(tapi.ParallelSparseLU, "_tri_solve", no_waves)
    return calls


# ---------------------------------------------------------------------------
# detection and planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [7, 300])
def test_bands_and_planes_equal_jax(n, dtype):
    A, jf, tf = _chain_pair(n, dtype)
    assert tf._numeric.chain and jf._scan_perm_id
    for lower, M in ((True, tf.L), (False, tf.U)):
        got, want = bidiag_bands(M, lower=lower), jax_bidiag_bands(
            M, lower=lower)
        for key in ("diag", "off"):
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(tf.L.toarray(), jf.L.toarray())
    np.testing.assert_array_equal(tf.U.toarray(), jf.U.toarray())
    for key in ("aL", "sL", "aU", "sU"):
        got = tf._numeric.planes[key].numpy()
        want = np.asarray(jf._scan2d[key]).ravel()[:n]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the port keeps its bands on the host only: the same as JAX's device
    # bands at the solver's dtype
    bands = {"l": bidiag_bands(tf.L, lower=True),
             "u": bidiag_bands(tf.U, lower=False)}
    for key in ("ld", "lo", "ud", "uo"):
        band = bands[key[0]]["diag" if key[1] == "d" else "off"]
        np.testing.assert_array_equal(np.asarray(band, dtype),
                                      np.asarray(jf._scan_bands[key]))


def test_chain_planes_without_rs_have_no_forward_scale():
    lb = {"diag": np.array([1.0, 1.0]), "off": np.array([0.0, -0.5])}
    ub = {"diag": np.array([2.0, 4.0]), "off": np.array([1.0, 0.0])}
    planes = chain_planes(lb, ub, None, np.float64)
    assert "sL" not in planes
    np.testing.assert_array_equal(planes["aL"], [-0.0, 0.5])
    np.testing.assert_array_equal(planes["iL"], [1.0, 1.0])
    np.testing.assert_array_equal(planes["aU"], [-0.5, -0.0])
    np.testing.assert_array_equal(planes["sU"], [0.5, 0.25])
    planes = chain_planes(lb, ub, np.array([3.0, 2.0]), np.float32)
    np.testing.assert_array_equal(planes["sL"], np.float32([3.0, 2.0]))
    assert planes["sL"].dtype == np.float32


def test_bidiag_detection_negative():
    A = poisson_2d(10, 10)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(chunk_size=32),
                             device="cpu")
    # 2-D stencil factors are not bidiagonal
    assert F._numeric.planes is None and not F._numeric.chain
    lb = bidiag_bands(sp.csc_matrix(np.triu(np.ones((5, 5)))), lower=False)
    assert lb is None  # bandwidth > 1
    # an upper bidiagonal matrix is not a lower one
    assert bidiag_bands(sp.csc_matrix(np.eye(4, k=1) + np.eye(4)),
                        lower=True) is None


def test_chain_under_pivoting_orderings_keeps_waves_for_ldiv(rng):
    """colamd may leave the factors bidiagonal but not the permutations
    trivial: lsolve/rsolve take the chain, ldiv the tile waves (JAX
    ``_ldiv_callable``, api.py:779-784)."""
    A = laplacian_1d(200)
    cfgs = dict(chunk_size=16, dtype="float64", ordering="colamd")
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **cfgs))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfgs),
                              device="cpu")
    assert (tf._numeric.planes is None) == (jf._scan_bands is None)
    assert tf._numeric.chain == jf._scan_perm_id
    b = rng.random(200)
    np.testing.assert_allclose(tf.ldiv(b).numpy(),
                               spla.spsolve(A.tocsc(), b),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the plain version against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [7, 128, 257, 5000])
def test_plain_matches_pallas_bidiag_ldiv(rng, n, dtype):
    aL, sL, aU, sU = _random_planes(rng, n, dtype)
    aL[0] = aU[-1] = 0.0
    b = rng.standard_normal(n).astype(dtype)
    S = -(-n // 128)
    packed = [jnp.asarray(pack_bands_2d(v, 0.0, S))
              for v in (aL, sL, aU, sU, b)]
    want = np.asarray(pallas_bidiag_ldiv(*packed, n=n, interpret=True))
    want = want.reshape(-1)[:n]
    t = [torch.as_tensor(v) for v in (aL, sL, aU, sU)]
    got = bidiag_ldiv(torch.as_tensor(b)[:, None], lower=(t[0], t[1]),
                      upper=(t[2], t[3]))
    assert got.shape == (n, 1) and got.dtype == torch.as_tensor(b).dtype
    # the same Kogge-Stone recurrence: float32 agrees to a few ulps of the
    # largest entry, float64 at the scan bars
    if dtype == np.float32:
        np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("lower", [True, False])
def test_plain_matches_scan_bidiag_solve(rng, lower):
    """One sweep (lsolve/rsolve of a chain), R = 3, float64."""
    n = 300
    diag = rng.uniform(1.0, 2.0, n)
    off = rng.uniform(-0.9, 0.9, n)
    b = rng.random((n, 3))
    want = np.asarray(scan_bidiag_solve(jnp.asarray(diag), jnp.asarray(off),
                                        jnp.asarray(b), lower=lower))
    band = {"diag": diag, "off": off}
    if lower:
        off[0] = 0.0
        planes = chain_planes(band, band, None, np.float64)
        kw = {"lower": (torch.as_tensor(planes["aL"]),
                        torch.as_tensor(planes["iL"]))}
        T = sp.diags([off[1:], diag], [-1, 0]).tocsr()
    else:
        off[-1] = 0.0
        planes = chain_planes(band, band, None, np.float64)
        kw = {"upper": (torch.as_tensor(planes["aU"]),
                        torch.as_tensor(planes["sU"]))}
        T = sp.diags([diag, off[:-1]], [0, 1]).tocsr()
    got = bidiag_ldiv(torch.as_tensor(b), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, spla.spsolve_triangular(T, b, lower=lower), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("R", [1, 4])
def test_plain_sweeps_match_serial_substitution(rng, R):
    """Forward then backward sweep against a serial loop, float64."""
    n = 1000
    aL, sL, aU, sU = _random_planes(rng, n, np.float64)
    b = rng.standard_normal((n, R))
    y = np.zeros_like(b)
    for i in range(n):
        y[i] = (aL[i] * y[i - 1] if i else 0.0) + sL[i] * b[i]
    x = np.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[i] = (aU[i] * x[i + 1] if i < n - 1 else 0.0) + sU[i] * y[i]
    t = [torch.as_tensor(v) for v in (aL, sL, aU, sU)]
    bt = torch.as_tensor(b)
    got = bidiag_ldiv(bt, lower=(t[0], t[1]), upper=(t[2], t[3]))
    np.testing.assert_allclose(got.numpy(), x, rtol=RTOL, atol=ATOL)
    only_l = bidiag_ldiv_plain(bt, lower=(t[0], t[1]))
    np.testing.assert_allclose(only_l.numpy(), y, rtol=RTOL, atol=ATOL)
    assert bidiag_ldiv_plain(bt) is not bt  # no sweep: a copy


# ---------------------------------------------------------------------------
# the lifecycle (tests/test_scan_solve.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [7, 128, 257, 5000])
def test_chain_ldiv_matches_jax_and_spsolve(rng, chain_only, n):
    A, jf, tf = _chain_pair(n)
    assert tf._numeric.planes is not None and tf._numeric.chain
    for shape in ((n,), (n, 3)):
        b = rng.random(shape)
        x = tf.ldiv(b)
        assert x.shape == shape and x.dtype == torch.float64
        want = spla.spsolve(A.tocsc(), b)
        np.testing.assert_allclose(x.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(x.numpy(), np.asarray(jf.ldiv(b)),
                                   rtol=RTOL, atol=ATOL)
    assert chain_only == [["lower", "upper"]] * 2


def test_chain_ldiv_float32_matches_jax(rng, chain_only):
    """Config 1 at a small size in float32: the port's scan against the
    JAX package's on the same factors, and the backward-error guard of
    bench.py:198-208."""
    n = 2000
    A, jf, tf = _chain_pair(n, "float32")
    for R in (1, 3):
        b = rng.random((n, R)).astype(np.float32)
        x = tf.ldiv(b).numpy()
        assert_isapprox(x, np.asarray(jf.ldiv(b)), rtol=1e-5, atol=1e-5)
        r = np.linalg.norm(A @ x - b) / (
            spla.norm(A) * np.linalg.norm(x) + np.linalg.norm(b))
        assert r < 1e-6
    assert len(chain_only) == 2


def test_chain_lsolve_rsolve_match_triangular(rng, chain_only):
    A, jf, tf = _chain_pair(600)
    b = rng.random((600, 2))
    y = tf.lsolve(b).numpy()
    np.testing.assert_allclose(
        y, spla.spsolve_triangular(tf.L.tocsr(), b, lower=True),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, np.asarray(jf.lsolve(b)), rtol=RTOL,
                               atol=ATOL)
    z = tf.rsolve(b[:, 0]).numpy()
    assert z.shape == (600,)
    np.testing.assert_allclose(
        z, spla.spsolve_triangular(tf.U.tocsr(), b[:, 0], lower=False),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z, np.asarray(jf.rsolve(b[:, 0])),
                               rtol=RTOL, atol=ATOL)
    assert chain_only == [["lower"], ["upper"]]


def test_chain_host_refactor_redetects(rng):
    """Reference lifecycle (runtests.jl:108-188) through the chain path:
    solve -> new values refactor -> solve again."""
    A, _, F = _chain_pair(900)
    b = rng.random(900)
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A.tocsc(), b),
                               rtol=RTOL, atol=ATOL)
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.1 * rng.random(A2.nnz))
    num0 = F._numeric
    F.refactor(A2)
    assert F._numeric.planes is not None and F._numeric.chain  # re-detected
    assert F._numeric is not num0 and F._numeric.planes is not num0.planes
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                               rtol=1e-9, atol=1e-11)


def test_device_refactor_disables_stale_bands(rng):
    A, _, F = _chain_pair(512)
    b = rng.random(512)
    A2 = A.copy()
    A2.data = A2.data * 1.25
    num0 = F._numeric
    F.refactor_numeric(A2)
    assert F._numeric.planes is None and not F._numeric.chain  # would be stale
    assert F._numeric is not num0
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                               rtol=1e-8, atol=1e-10)
    # a re-pack of the device factors detects the chain again
    F.refactor(None)
    assert F._numeric.planes is not None and F._numeric.chain
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("refine_steps", [0, 1])
def test_chain_refactor_step_takes_the_tile_solve(rng, refine_steps):
    """On a chain solver the refactor-solve step solves on the tiles (its
    spans hold ``lu.ldiv.launch``, no ``lu.ldiv.chain``) and leaves the
    chain path on; ``refactor_numeric`` turns it off, with the step's
    bits, and ``refactor(None)`` turns it on again."""
    A, _, F = _chain_pair(300, "float32")
    step = F.make_refactor_solve_step(refine_steps=refine_steps)
    assert F.solve_path == "chain"
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.1 * rng.random(A2.nnz))
    b = torch.as_tensor(rng.random((300, 2)), dtype=torch.float32)
    trace.reset()
    x = step(A2.data, b)
    got = trace.totals()
    assert got["lu.ldiv.launch"][0] == 1 + refine_steps
    assert "lu.ldiv.chain" not in got
    assert F.solve_path == "chain"
    trace.reset()
    F.ldiv(b)
    assert "lu.ldiv.chain" in trace.totals()
    assert "lu.ldiv.launch" not in trace.totals()
    F.refactor_numeric(A2)
    assert F.solve_path == "tiles"
    assert torch.equal(F.ldiv(b, refine_steps=refine_steps), x)
    F.refactor(None)
    assert F.solve_path == "chain"
    y = F.ldiv(b)
    berr = (F.matvec(y) - b).norm() / (spla.norm(A2) * y.norm() + b.norm())
    assert float(berr) < 1e-6  # normwise backward error, float32


def test_factorize_device_chain_solves_through_waves(rng):
    """factorize="auto" under natural + pivot_threshold=0.0 factors on the
    device: the bands detected on the placeholder factors are cleared."""
    A = laplacian_1d(300)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        **_chain_cfg(factorize="auto")), device="cpu")
    assert F.config.factorize == "device"
    assert F._numeric.planes is None and not F._numeric.chain
    b = rng.random(300)
    np.testing.assert_allclose(F.ldiv(b).numpy(), spla.spsolve(A.tocsc(), b),
                               rtol=1e-8, atol=1e-10)


def test_cpu_chain_launches_no_kernel(rng):
    before = (bidiag_ldiv.LAUNCHES, wave_apply.LAUNCHES, perm_gather.LAUNCHES)
    A, _, F = _chain_pair(300, "float32")
    F.ldiv(rng.random((300, 2)), refine_steps=1)
    F.lsolve(rng.random(300))
    F.rsolve(rng.random(300))
    F.make_f64_ldiv()(rng.random(300))
    after = (bidiag_ldiv.LAUNCHES, wave_apply.LAUNCHES, perm_gather.LAUNCHES)
    assert after == before == (0, 0, 0)


def test_bidiag_ldiv_rejects_bad_inputs():
    n = 8
    a, s = torch.zeros(n), torch.ones(n)
    b = torch.ones((n, 2))
    with pytest.raises(ValueError, match="lower planes, the upper"):
        bidiag_ldiv(b)
    with pytest.raises(ValueError, match=r"\(n, R\)"):
        bidiag_ldiv(torch.ones(n), lower=(a, s))
    with pytest.raises(ValueError, match=r"\(8,\) vectors"):
        bidiag_ldiv(b, lower=(a[:-1], s))
    with pytest.raises(ValueError, match=r"\(8,\) vectors"):
        bidiag_ldiv(b, upper=(a, s[:, None]))
    with pytest.raises(ValueError, match="device type 'meta'"):
        bidiag_ldiv(b.to("meta"), lower=(a.to("meta"), s.to("meta")))
    with pytest.raises(ValueError, match="several devices"):
        bidiag_ldiv(b, lower=(a.to("meta"), s))


# ---------------------------------------------------------------------------
# the CUDA kernel's tiling (csrc/bidiag.cu), mirrored step by step
# ---------------------------------------------------------------------------

# tile sizes per n: one tile, many tiles that divide n or not, a ragged
# last tile, and the wrapper's own choice
TILINGS = {
    "one": lambda n: n,
    "many": lambda n: max(1, n // 8),
    "ragged": lambda n: max(1, n // 8) + 1,
    "default": lambda n: None,
}
_JAX_CHAIN = {}


def _jax_chain(n, dtype, R):
    """Seeded planes (Rs folded into sL), b (n, R) and the JAX Pallas
    kernel's solve of each column in interpret mode, made once."""
    key = (n, np.dtype(dtype).name, R)
    if key not in _JAX_CHAIN:
        rng = np.random.default_rng(n + 17 * R)
        aL, sL, aU, sU = _random_planes(rng, n, dtype)
        aL[0] = aU[-1] = 0.0
        sL = (sL * rng.uniform(0.5, 2.0, n)).astype(dtype)  # Rs folded in
        b = rng.standard_normal((n, R)).astype(dtype)
        S = -(-n // 128)
        planes = [jnp.asarray(pack_bands_2d(v, 0.0, S))
                  for v in (aL, sL, aU, sU)]
        want = np.stack([
            np.asarray(pallas_bidiag_ldiv(
                *planes, jnp.asarray(pack_bands_2d(b[:, j], 0.0, S)), n=n,
                interpret=True)).reshape(-1)[:n] for j in range(R)], 1)
        _JAX_CHAIN[key] = ([torch.as_tensor(v) for v in (aL, sL, aU, sU)],
                           torch.as_tensor(b), want)
    return _JAX_CHAIN[key]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("n", [7, 128, 257, 5000])
def test_tiled_mirror_matches_pallas_bidiag_ldiv(n, tiling, R, dtype):
    """The kernel's tiles, chunks, fixed-order composition and serial walk
    give the JAX Pallas kernel's solve, at the scan tolerances."""
    t, b, want = _jax_chain(n, dtype, R)
    got = bidiag_ldiv_tiled_plain(b, lower=(t[0], t[1]), upper=(t[2], t[3]),
                                  rows=TILINGS[tiling](n))
    assert got.shape == (n, R) and got.dtype == b.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lower", [True, False])
def test_tiled_mirror_matches_scan_bidiag_solve(rng, lower):
    """One sweep (lsolve/rsolve of a chain), R = 3, float64, ragged
    tiles."""
    n = 300
    diag = rng.uniform(1.0, 2.0, n)
    off = rng.uniform(-0.9, 0.9, n)
    b = rng.random((n, 3))
    want = np.asarray(scan_bidiag_solve(jnp.asarray(diag), jnp.asarray(off),
                                        jnp.asarray(b), lower=lower))
    band = {"diag": diag, "off": off}
    planes = chain_planes(band, band, None, np.float64)
    kw = ({"lower": (torch.as_tensor(planes["aL"]),
                     torch.as_tensor(planes["iL"]))} if lower else
          {"upper": (torch.as_tensor(planes["aU"]),
                     torch.as_tensor(planes["sU"]))})
    for rows in (37, 300):
        got = bidiag_ldiv_tiled_plain(torch.as_tensor(b), rows=rows, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_tiled_mirror_column_groups(rng):
    """More than 256 columns: the kernel walks them in groups of at most
    256 (two groups here, of 256 and 44), against a serial loop."""
    n, R = 40, 300
    aL, sL, aU, sU = _random_planes(rng, n, np.float64)
    b = rng.standard_normal((n, R))
    y = np.zeros_like(b)
    for i in range(n):
        y[i] = (aL[i] * y[i - 1] if i else 0.0) + sL[i] * b[i]
    x = np.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[i] = (aU[i] * x[i + 1] if i < n - 1 else 0.0) + sU[i] * y[i]
    t = [torch.as_tensor(v) for v in (aL, sL, aU, sU)]
    got = bidiag_ldiv_tiled_plain(torch.as_tensor(b), lower=(t[0], t[1]),
                                  upper=(t[2], t[3]), rows=9)
    np.testing.assert_allclose(got.numpy(), x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,R,tiles", [
    (20000, 1, 32), (20000, 16, 79), (1_048_577, 1, 257),
    (1_048_577, 16, 456), (1_048_577, 64, 497), (7, 3, 7)])
def test_tile_rows_policy(n, R, tiles):
    """Config 1 spreads over at least 32 tiles; long vectors take tiles of
    whole chunks, at most 512 a sweep."""
    rows = tile_rows(n, R)
    assert -(-n // rows) == tiles
    assert -(-n // rows) <= 512


def test_chain_words_per_stream():
    """One set of words and aggregate scratch per stream, made once."""
    a = chain_words(4, 3, torch.float32, "cpu", 11)
    b = chain_words(4, 3, torch.float32, "cpu", 12)
    assert a[0] is not b[0] and a[1] is not b[1]
    assert a[0] is chain_words(4, 3, torch.float32, "cpu", 11)[0]
    assert chain_words(4, 3, torch.float32, "cpu")[0] is chain_words(
        4, 3, torch.float32, "cpu", 0)[0]
    for s in (a, b, chain_words(6, 3, torch.float64, "cpu", 11)):
        assert s[0].tolist()[:3] == [0, 0, 1] and not s[0][3:].any()
        assert s[0].dtype == torch.int32
    assert a[0].numel() == 3 + 2 * 4 and a[1].numel() == 4 * (3 + 1)
    assert chain_words(6, 3, torch.float64, "cpu", 11)[1].dtype == \
        torch.float64
