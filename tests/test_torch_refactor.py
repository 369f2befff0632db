"""The port's device refactorization against the JAX package.

Same matrices, seeded with numpy, through both packages on the CPU:

* the refactor plan, the closure solve plans and the assembly plan —
  every array the JAX package also has — are equal;
* the assembled store and ``Rs`` equal the JAX assembly, and the span rows
  equal JAX ``span_gather`` in interpret mode, bit for bit (a copy);
* the plain tile LU and the plain elimination agree with JAX ``lu_tile``
  and ``fused_elimination`` in interpret mode and with
  ``_lu_nopivot``/``_blocked_elimination`` (float32: the JAX package's
  own bounds between its two implementations, ``tests/test_refactor.py:
  273,366-379``; float64: 1e-12, summation order only);
* the lifecycle — ``refactor_numeric``, ``make_refactor_solve_step``,
  ``factorize="device"/"auto"``, the memory guard, a JAX device
  factorization carried across — against JAX at 1e-9 in float64 (the JAX
  package's ``tri_mode="inv"`` bar, tests/test_solve.py:111) and against
  ``spsolve`` at the same bar, or the JAX float32 bars; at ``"trsm"`` and
  ``"inv_refine"`` at the reference's 1e-12 (test/runtests.jl:25).
"""

import dataclasses

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
from tpu_sparse_lu.assemble import assemble_windowed
from tpu_sparse_lu.models import (
    block_banded,
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
)
from tpu_sparse_lu.ops.pallas_elim import _neumann_inv, fused_elimination
from tpu_sparse_lu.ops.pallas_factor import lu_tile as jax_lu_tile
from tpu_sparse_lu.ops.pallas_span import span_gather as jax_span_gather
from tpu_sparse_lu.refactor import _blocked_elimination, _lu_nopivot
from tpu_sparse_lu_torch.assemble import assemble, assembly_device_arrays
from tpu_sparse_lu_torch.ops import assembly as tasm
from tpu_sparse_lu_torch.ops.elimination import (
    TILE_SHAPES,
    eliminate,
    make_groups,
    pick_tile,
    tile_mm,
    tile_mm_plain,
)
from tpu_sparse_lu_torch.ops.lu_tile import lu_nopivot, lu_tile
from tpu_sparse_lu_torch.ops.span_gather import span_gather, span_gather_plain
from tpu_sparse_lu_torch.ops.tri_inverse import tri_inverse
from tpu_sparse_lu_torch.refactor import blocked_fill, refactor_pipeline
from tpu_sparse_lu_torch.solve import refine

INV_TOL = 1e-9
TOL = 1e-12  # the reference's sparse bar (test/runtests.jl:25)

PLAN_CASES = {
    "block_banded": (lambda rng: block_banded(rng, 24, 12),
                     dict(chunk_size=16)),
    "poisson_nd": (lambda rng: poisson_2d(14, 11),
                   dict(chunk_size=16, ordering="nd")),
}

ASSEMBLY_CASES = {
    "bb_12_10": (lambda rng: block_banded(rng, 12, 10), 16),
    "poisson_20": (lambda rng: poisson_2d(20, 20), 32),
    "random_300": (lambda rng: sp.random(300, 300, density=0.02,
                                         random_state=7, format="csc")
                   + 10 * sp.eye(300, format="csc"), 32),
    "bb_24_12": (lambda rng: block_banded(rng, 24, 12), 16),
    "poisson_14_11": (lambda rng: poisson_2d(14, 11), 16),
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


def _perturb(rng, A, scale):
    """New values, same pattern (the reference lifecycle's lu! case)."""
    A2 = A.copy()
    A2.data = A2.data * (1.0 + scale * rng.standard_normal(A2.data.shape))
    return A2


def _pair(A, **cfg):
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **cfg))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                              device="cpu")
    return jf, tf


def _enabled_pair(A, **cfg):
    jf, tf = _pair(A, **cfg)
    jf.enable_device_refactor()
    tf.enable_device_refactor()
    return jf, tf


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_refactor_plan_matches_jax(rng, case):
    make, cfg = PLAN_CASES[case]
    jf, tf = _enabled_pair(make(rng), **cfg)
    jp, tp = jf._refactor_plan, tf._refactor_plan
    for fld in dataclasses.fields(jp):
        if fld.name == "win":
            continue
        np.testing.assert_array_equal(getattr(tp, fld.name),
                                      getattr(jp, fld.name), err_msg=fld.name)
    jw, tw = jp.win, tp.asm
    n_rows = (jw.TF2 + 1) * tp.cs
    for fld in dataclasses.fields(tw):
        want = getattr(jw, fld.name)
        if fld.name.startswith("span_") and fld.name[5:] in ("g", "lo", "hi"):
            # the JAX rows are padded to a TPU grid page; the port's are not
            assert not want[n_rows:].any()
            want = want[:n_rows]
        np.testing.assert_array_equal(getattr(tw, fld.name), want,
                                      err_msg=fld.name)
    # the closure solve plans the banks are extracted into
    for name in ("lplan", "uplan"):
        jt, tt = getattr(jf.plan, name), getattr(tf.plan, name)
        for fld in dataclasses.fields(jt):
            np.testing.assert_array_equal(getattr(tt, fld.name),
                                          getattr(jt, fld.name),
                                          err_msg=f"{name}.{fld.name}")


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_schur_groups_regroup_the_schedule(rng, case):
    """Per level, every real Schur entry appears once, under its own
    destination, destinations are distinct, and the entries of one
    destination keep their schedule order; padded slots are dropped."""
    make, cfg = PLAN_CASES[case]
    tf = tlu.ParallelSparseLU(make(rng), config=tlu.SolverConfig(**cfg),
                              device="cpu")
    tf.enable_device_refactor()
    rp = tf._refactor_plan
    shared = 0
    for l in range(rp.NL):
        dst, ptr, lt, ut = rp.schur_groups[l]
        real = rp.schur[l][rp.schur[l, :, 0] != rp.TF]
        assert len(np.unique(dst)) == len(dst) and ptr[-1] == len(real)
        for d in range(len(dst)):
            mine = real[real[:, 0] == dst[d]]
            np.testing.assert_array_equal(lt[ptr[d]:ptr[d + 1]], mine[:, 1])
            np.testing.assert_array_equal(ut[ptr[d]:ptr[d + 1]], mine[:, 2])
        shared += len(real) - len(dst)
    if case == "poisson_nd":
        assert shared > 0  # wide levels with shared destinations


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("with_extra", [False, True])
def test_plan_triangular_extra_tiles_matches_jax(lower, with_extra):
    from tpu_sparse_lu.symbolic import plan_triangular as jplan
    from tpu_sparse_lu_torch.symbolic import plan_triangular as tplan

    A = poisson_2d(14, 11)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(chunk_size=16))
    M = jf.L if lower else jf.U
    extra = None
    if with_extra:
        K = -(-A.shape[0] // 16)
        S = blocked_fill({(i, j) for i in range(K) for j in range(K)
                          if abs(i - j) <= 2}, K)
        extra = [(i, j) for (i, j) in S if (i > j if lower else i < j)]
    want = jplan(M, 16, lower=lower, extra_tiles=extra)
    got = tplan(M, 16, lower=lower, extra_tiles=extra)
    for fld in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, fld.name),
                                      getattr(want, fld.name),
                                      err_msg=fld.name)
    if with_extra:
        assert got.T > tplan(M, 16, lower=lower).T
        with pytest.raises(ValueError, match="wrong side"):
            tplan(M, 16, lower=lower, extra_tiles=[(0, 0)])


def test_blocked_fill_closes_the_pattern():
    K = 6
    S = blocked_fill({(3, 0), (0, 4), (5, 3), (3, 5)}, K)
    assert {(k, k) for k in range(K)} <= S
    assert (3, 4) in S  # (3,0)·(0,4)
    assert (5, 4) in S  # (5,3)·(3,4)
    for k in range(K):
        rows = [i for (i, j) in S if j == k and i > k]
        cols = [j for (i, j) in S if i == k and j > k]
        assert all((i, j) in S for i in rows for j in cols)


# ---------------------------------------------------------------------------
# assembly and span gather (B4)
# ---------------------------------------------------------------------------


def _jax_assembly(jf, a_data):
    rp, w = jf._refactor_plan, jf._refactor_plan.win
    return assemble_windowed(
        jnp.asarray(a_data), jf._refactor_dev, n=rp.n, cs=rp.cs, TF=rp.TF,
        TF2=w.TF2, W=w.W, R1=w.R1, Np=w.Np)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_assembly_matches_jax(rng, case, dtype):
    make, cs = ASSEMBLY_CASES[case]
    A = sp.csc_matrix(make(rng))
    jf, tf = _enabled_pair(A, chunk_size=cs, dtype=dtype)
    rp = tf._refactor_plan
    a = A.data.astype(dtype)
    want_t, want_rs = map(np.asarray, _jax_assembly(jf, a))
    dev = assembly_device_arrays(rp.asm, rp.cs, rp.TF, "cpu")
    got_t, got_rs = assemble(torch.as_tensor(a), dev, n=rp.n, cs=rp.cs,
                             TF=rp.TF, TF2=rp.asm.TF2)
    # the same values land in the same places, scaled by the same ops
    np.testing.assert_array_equal(got_rs.numpy(), want_rs)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("case", ["bb_24_12", "poisson_14_11"])
def test_span_rows_match_jax_span_gather(rng, case):
    """The span rows, leftovers and all, equal JAX ``span_gather`` run in
    interpret mode (tests/test_refactor.py:386) on the same plan."""
    make, cs = ASSEMBLY_CASES[case]
    A = sp.csc_matrix(make(rng))
    jf, tf = _enabled_pair(A, chunk_size=cs, dtype="float32")
    jdev, w = jf._refactor_dev, jf._refactor_plan.win
    a = A.data.astype(np.float32)
    nnz, n_rows = a.shape[0], (w.TF2 + 1) * cs
    Nq = nnz // cs + 3
    a2 = jnp.pad(jnp.asarray(a), (cs, Nq * cs - cs - nnz)).reshape(Nq, cs)
    want = jax_span_gather(a2, jdev["span_g"], jdev["span_lo"],
                           jdev["span_hi"], n_rows=n_rows, interpret=True)
    asm = tf._refactor_plan.asm
    a_pad = torch.zeros(cs + nnz)
    a_pad[cs:] = torch.as_tensor(a)
    got = span_gather(a_pad, *(torch.as_tensor(x) for x in
                               (asm.span_g, asm.span_lo, asm.span_hi)), cs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_span_gather_plain_semantics(rng):
    a = torch.as_tensor(rng.standard_normal(40))
    g = torch.tensor([0, 5, 33, -3, 100], dtype=torch.int32)
    lo = torch.tensor([0, 2, 0, 0, 0], dtype=torch.int32)
    hi = torch.tensor([8, 6, 8, 8, 8], dtype=torch.int32)
    got = span_gather(a, g, lo, hi, 8).numpy()
    want = np.zeros((5, 8))
    an = a.numpy()
    for i in range(5):
        for k in range(lo[i], hi[i]):
            s = int(g[i]) + k
            if 0 <= s < 40:
                want[i, k] = an[s]
    np.testing.assert_array_equal(got, want)


def _grouped(dev, kind, cs):
    """Flat positions ``tile·cs² + pos`` of a per-tile grouping."""
    ptr = dev[f"k_{kind}_ptr"].numpy().astype(np.int64)
    tile = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    return tile * cs * cs + dev[f"k_{kind}_pos"].numpy()


@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_assembly_groups_every_entry_in_its_tile(rng, case):
    """The kernels' per-tile groupings hold every leftover and nd one (by
    unpermuted tile) and every pad (by closure tile) once, at its own
    place, in the plan's order within a tile."""
    make, cs = ASSEMBLY_CASES[case]
    A = sp.csc_matrix(make(rng))
    _, tf = _enabled_pair(A, chunk_size=cs, dtype="float64")
    rp = tf._refactor_plan
    dev = assembly_device_arrays(rp.asm, rp.cs, rp.TF, "cpu")
    for kind, rows, cols, src, n_tiles in (
            ("left", "left_row", "left_col", "left_src", rp.asm.TF2 + 1),
            ("ones", "ones_row", "ones_col", None, rp.asm.TF2 + 1),
            ("pad", "pad_row", "pad_col", None, rp.TF + 2)):
        ptr = dev[f"k_{kind}_ptr"].numpy()
        assert ptr.shape == (n_tiles + 1,) and ptr[0] == 0
        assert (np.diff(ptr) >= 0).all()
        want = dev[rows].numpy() * cs + dev[cols].numpy()
        got = _grouped(dev, kind, cs)
        assert ptr[-1] == len(want) and (dev[f"k_{kind}_pos"].numpy()
                                         < cs * cs).all()
        order = np.argsort(want // (cs * cs), kind="stable")
        np.testing.assert_array_equal(got, want[order])
        if src:
            np.testing.assert_array_equal(dev["k_left_src"].numpy(),
                                          dev[src].numpy()[order])
    if case.startswith("poisson"):
        assert dev["k_ones_pos"].numel() == 0  # no nd embedding here
    assert dev["k_pad_pos"].numel() > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_assembly_kernel_stages_match_jax(rng, case, dtype):
    """The two kernels' stages in plain PyTorch (per-tile gather with its
    own leftovers and ones and the block-row maxima, the closure with the
    scales) equal the yardstick
    route and JAX ``assemble_windowed`` bit for bit; so do the wrappers,
    which run them on a CPU tensor and launch nothing."""
    make, cs = ASSEMBLY_CASES[case]
    A = sp.csc_matrix(make(rng))
    jf, tf = _enabled_pair(A, chunk_size=cs, dtype=dtype)
    rp = tf._refactor_plan
    a = A.data.astype(dtype)
    want_t, want_rs = map(np.asarray, _jax_assembly(jf, a))
    dev = assembly_device_arrays(rp.asm, rp.cs, rp.TF, "cpu")
    kw = dict(n=rp.n, cs=rp.cs, TF=rp.TF, TF2=rp.asm.TF2)
    at = torch.as_tensor(a)
    ref_t, ref_rs = assemble(at, dev, plain=True, **kw)
    before = [f.LAUNCHES for f in (tasm.assemble_tiles,
                                   tasm.assemble_closure)]
    for fn in (tasm.assemble_store_plain, tasm.assemble_store):
        got_t, got_rs = fn(at, dev, **kw)
        assert torch.equal(got_t, ref_t) and torch.equal(got_rs, ref_rs)
        np.testing.assert_array_equal(got_rs.numpy(), want_rs)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert [f.LAUNCHES for f in (tasm.assemble_tiles,
                                 tasm.assemble_closure)] == before


def test_assembly_wrappers_reject_other_devices():
    meta = torch.zeros(16, device="meta")
    i32 = torch.zeros(2, dtype=torch.int32)
    dev = {k: i32 for k in ("span_g", "span_lo", "span_hi")}
    with pytest.raises(ValueError, match="device type 'meta'"):
        tasm.assemble_tiles(meta, dev, 4, 0)
    with pytest.raises(ValueError, match="device type 'meta'"):
        tasm.assemble_closure(meta, meta, dev, 4, 4, 0)
    with pytest.raises(ValueError, match="several devices"):
        tasm.assemble_closure(meta, torch.zeros(4), dev, 4, 4, 0)


# ---------------------------------------------------------------------------
# tile LU (B2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs", [16, 45, 100, 128])
def test_lu_tile_plain_matches_jax(rng, cs):
    """Plain tile LU against JAX ``lu_tile`` in interpret mode and
    ``_lu_nopivot`` on diagonally dominant tiles (no-pivot LU is stable),
    at the JAX bound between its two (tests/test_refactor.py:273). The
    sizes are those the card holds the CUDA kernel to: one partial panel
    of 32 columns (16), ragged last panels (45, 100) and whole ones."""
    batch = 3 if cs < 32 else 2
    D = rng.standard_normal((batch, cs, cs)) + cs * np.eye(cs)
    D32 = D.astype(np.float32)
    got = lu_nopivot(torch.as_tensor(D32)).numpy()
    assert_isapprox(got, np.asarray(jax_lu_tile(jnp.asarray(D32),
                                                interpret=True)),
                    rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_lu_nopivot(jnp.asarray(D32))),
                               rtol=1e-5, atol=1e-5)
    # float64: the same rank-1 loop, so equal to rounding
    np.testing.assert_allclose(lu_nopivot(torch.as_tensor(D)).numpy(),
                               np.asarray(_lu_nopivot(jnp.asarray(D))),
                               rtol=1e-12, atol=1e-12)


def test_lu_tile_wrapper_in_place_with_inverses(rng):
    cs, N = 8, 5
    tiles0 = rng.standard_normal((N, cs, cs)) + cs * np.eye(cs)
    tiles = torch.as_tensor(tiles0.copy())
    ids = torch.tensor([3, 0], dtype=torch.int32)
    linv = torch.zeros((2, cs, cs), dtype=torch.float64)
    uinv = torch.zeros_like(linv)
    piv = lu_tile(tiles, ids, linv=linv, uinv=uinv)
    for b, t in enumerate((3, 0)):
        M = tiles[t].numpy()
        L = np.tril(M, -1) + np.eye(cs)
        U = np.triu(M)
        np.testing.assert_allclose(L @ U, tiles0[t], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(linv[b].numpy() @ L, np.eye(cs),
                                   atol=1e-12)
        np.testing.assert_allclose(uinv[b].numpy() @ U, np.eye(cs),
                                   atol=1e-12)
        assert float(piv[b]) == np.abs(np.diag(U)).min()
    for t in (1, 2, 4):  # untouched
        np.testing.assert_array_equal(tiles[t].numpy(), tiles0[t])
    assert lu_tile.LAUNCHES == 0


def _blocked_inverses(M):
    """``(L⁻¹, U⁻¹)`` of a merged L\\U tile in the order of the CUDA
    kernel's inverse pass (``csrc/lu_tile.cu``), in place over a copy
    ``S`` of the factor (its shared-memory tile, rows padded with NaN):
    each 32 x 32 diagonal block inverted by substitution into its own
    triangles, then for s = 1 .. nb-1 block row s of L⁻¹ and block column
    s of U⁻¹, every sum of the step taken before any of its results is
    stored (the kernel's block barrier)."""
    cs, K = M.shape[0], 32
    nb = -(-cs // K)
    S = np.full((cs, 132), np.nan, M.dtype)
    S[:, :cs] = M

    def blk(i):
        return slice(K * i, min(K * (i + 1), cs))

    for b in range(nb):
        D = S[blk(b), blk(b)]
        w = D.shape[0]
        X = np.eye(w, dtype=M.dtype)
        for m in range(1, w):  # columns at once: lane c holds column c
            X[m] -= D[m, :m] @ X[:m]
        Y = np.eye(w, dtype=M.dtype)
        for m in reversed(range(w)):
            Y[m] = (Y[m] - D[m, m + 1:] @ Y[m + 1:]) * (1 / D[m, m])
        S[blk(b), blk(b)] = np.tril(X, -1) + np.triu(Y)

    def diag(s, lower):  # X_ss (unit lower) or Y_ss from the diagonal slot
        B = S[blk(s), blk(s)]
        return np.tril(B, -1) + np.eye(B.shape[0], dtype=M.dtype) if lower \
            else np.triu(B)

    def inv(i, j, lower):  # a finished block of X or Y
        return diag(i, lower) if i == j else S[blk(i), blk(j)]

    for s in range(1, nb):
        T = {j: sum(S[blk(s), blk(k)] @ inv(k, j, True) for k in range(j, s))
             for j in range(s)}
        U = {i: sum(inv(i, k, False) @ S[blk(k), blk(s)] for k in range(i, s))
             for i in range(s)}
        for j in range(s):  # after the barrier: each over its own slot
            S[blk(s), blk(j)] = -(diag(s, True) @ T[j])
        for i in range(s):
            S[blk(i), blk(s)] = -(U[i] @ diag(s, False))
    F = S[:, :cs]
    return np.tril(F, -1) + np.eye(cs, dtype=M.dtype), np.triu(F)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cs", [16, 45, 100, 128])
def test_blocked_inverses_match_tri_inverse_and_jax(rng, cs, dtype):
    """The block recurrence of the CUDA ``lu_tile`` kernel against the
    port's ``tri_inverse`` (the plain twin's inverses) and JAX's
    ``_neumann_inv`` (``pallas_elim.py:110``, plain jnp), on seeded
    diagonally dominant tiles at the sizes the card holds the kernel to:
    one partial block (16), ragged last blocks (45, 100) and whole ones.
    Against ``tri_inverse`` at the kernel's bound against its plain twin
    (``chip_smoke.LU_TOL``: 1e-5 / 1e-12 max relative, summation order
    only); against JAX at 1e-5 in both types, since ``_neumann_inv``'s
    products accumulate in float32 (``preferred_element_type``)."""
    tol = {"float32": 1e-5, "float64": 1e-12}[dtype]
    D = (rng.standard_normal((cs, cs)) + cs * np.eye(cs)).astype(dtype)
    M = lu_nopivot(torch.as_tensor(D)).numpy()
    X, Y = _blocked_inverses(M)
    eye = np.eye(cs, dtype=dtype)
    L, U = np.tril(M, -1) + eye, np.triu(M)
    assert _rel(X, tri_inverse(torch.as_tensor(L)[None], lower=True)[0]
                .numpy()) <= tol
    assert _rel(Y, tri_inverse(torch.as_tensor(U)[None], lower=False)[0]
                .numpy()) <= tol
    assert np.abs(X @ L - eye).max() <= 10 * tol
    assert np.abs(Y @ U - eye).max() <= 10 * tol
    M32 = jnp.asarray(M.astype(np.float32))
    du = jnp.diagonal(M32)
    jx = _neumann_inv(-jnp.tril(M32, -1))
    jy = _neumann_inv(-(jnp.triu(M32, 1) / du[:, None])) / du[None, :]
    assert _rel(X, np.asarray(jx, np.float64)) <= 1e-5
    assert _rel(Y, np.asarray(jy, np.float64)) <= 1e-5


# ---------------------------------------------------------------------------
# elimination (B3)
# ---------------------------------------------------------------------------


def _jax_elim_args(jf):
    d = jf._refactor_dev
    return (d["diag_ids"], d["diag_cnt"], d["row_ids"], d["row_owner"],
            d["col_ids"], d["col_owner"], d["schur"])


def _compare_elimination(tf, got, want, rtol, atol):
    rp = tf._refactor_plan
    t_got, mp_got, li_got, ui_got = got
    t_ref, mp_ref, li_ref, ui_ref = map(np.asarray, want)
    # real tiles only: the JAX padded slots write the dummy tile by design
    np.testing.assert_allclose(t_got[: rp.TF].numpy(), t_ref[: rp.TF],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(mp_got), float(mp_ref), rtol=rtol)
    for l in range(rp.NL):
        for b in range(int(rp.diag_cnt[l])):
            np.testing.assert_allclose(li_got[l, b].numpy(), li_ref[l, b],
                                       rtol=rtol, atol=atol)
            np.testing.assert_allclose(ui_got[l, b].numpy(), ui_ref[l, b],
                                       rtol=rtol, atol=atol)


def test_elimination_plain_matches_jax_fused(rng):
    """Against JAX ``fused_elimination`` in interpret mode on the case of
    tests/test_refactor.py:345-347, at the bounds JAX holds its own two
    implementations to (:366-379)."""
    A = block_banded(rng, 24, 12)
    jf, tf = _enabled_pair(A, chunk_size=16, dtype="float32")
    rp = jf._refactor_plan
    tiles, _ = _jax_assembly(jf, A.data.astype(np.float32))
    args = _jax_elim_args(jf)
    NL, BL = args[0].shape
    want = fused_elimination(
        tiles, *args, cs=rp.cs, NL=NL, BL=BL, MR=args[2].shape[1],
        MU=args[4].shape[1], MS=args[6].shape[1], interpret=True)
    got = eliminate(torch.as_tensor(np.array(tiles)),
                    tf._refactor_dev.elim)
    _compare_elimination(tf, got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_elimination_plain_matches_jax_wide_levels(rng, dtype):
    """Against ``_blocked_elimination`` on an nd case with wide levels whose
    Schur updates share destination tiles."""
    A = poisson_2d(14, 11)
    jf, tf = _enabled_pair(A, chunk_size=16, ordering="nd", dtype=dtype)
    rp = tf._refactor_plan
    assert rp.diag_ids.shape[1] > 1
    assert any(len(g[2]) > len(g[0]) for g in rp.schur_groups)
    a = A.data.astype(dtype)
    # through the nd embedding's value stream
    tiles, _ = _jax_assembly(jf, a)
    want = _blocked_elimination(tiles, *_jax_elim_args(jf), cs=rp.cs)
    got = eliminate(torch.as_tensor(np.array(tiles)),
                    tf._refactor_dev.elim)
    tol = (2e-5, 1e-5) if dtype == "float32" else (1e-12, 1e-12)
    _compare_elimination(tf, got, want, *tol)


def test_tile_mm_plain_semantics(rng):
    cs = 4
    out0 = rng.standard_normal((6, cs, cs))
    a = torch.as_tensor(rng.standard_normal((3, cs, cs)))
    b = torch.as_tensor(rng.standard_normal((4, cs, cs)))
    g = make_groups([5, 1], [[(0, 1), (2, 3)], [(1, 0)]], "cpu")
    out = torch.as_tensor(out0.copy())
    assert tile_mm(out, a, b, g, side="row", subtract=True) is out
    want = out0.copy()
    an, bn = a.numpy(), b.numpy()
    want[5] -= an[0] @ bn[1] + an[2] @ bn[3]
    want[1] -= an[1] @ bn[0]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)
    out = torch.as_tensor(out0.copy())
    tile_mm_plain(out, a, b, g, side="col", subtract=False)
    np.testing.assert_allclose(out[1].numpy(), an[1] @ bn[0], rtol=1e-12)
    with pytest.raises(ValueError, match="index past"):
        tile_mm(out[:3], a, b, g, side="row", subtract=False)
    with pytest.raises(ValueError, match="side"):
        tile_mm(out, a, b, g, side="diag", subtract=False)
    with pytest.raises(ValueError, match="two groups"):
        make_groups([1, 1], [[(0, 0)], [(1, 1)]], "cpu")
    with pytest.raises(ValueError, match="at least one"):
        make_groups([1], [[]], "cpu")
    with pytest.raises(ValueError, match="negative"):
        make_groups([1], [[(-1, 0)]], "cpu")


def _headline_plan_case(rng):
    return poisson_2d(100, 100)


# the plans above, and the 2D Poisson 100x100 nd headline at cs = 128
SPLIT_CASES = dict(PLAN_CASES, headline=(
    _headline_plan_case, dict(chunk_size=128, ordering="nd", nd_cutoff=512)))


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_elimination_launches_meet_the_split_rule(rng, case):
    """What the kernel's sub-tile split relies on: a panel group's
    destination is its own in-place operand (the a tile of a row panel,
    the b tile of a column panel), and no Schur destination of a level is
    an a or b operand of the same launch, so a Schur block may split the
    destination both ways."""
    make, cfg = SPLIT_CASES[case]
    tf = tlu.ParallelSparseLU(make(rng), config=tlu.SolverConfig(**cfg),
                              device="cpu")
    tf.enable_device_refactor()
    sched = tf._refactor_dev.elim
    n_schur = 0
    for lvl in sched.levels:
        if lvl.rows is not None:
            np.testing.assert_array_equal(lvl.rows.a_idx.numpy(),
                                          lvl.rows.dst.numpy())
            assert lvl.rows.dst_in_a
        if lvl.cols is not None:
            np.testing.assert_array_equal(lvl.cols.b_idx.numpy(),
                                          lvl.cols.dst.numpy())
            assert lvl.cols.dst_in_b
        if lvl.schur is not None:
            g = lvl.schur
            ops = np.union1d(g.a_idx.numpy(), g.b_idx.numpy())
            assert not np.isin(g.dst.numpy(), ops).any()
            assert not (g.dst_in_a or g.dst_in_b)
            n_schur += g.a_idx.shape[0]
    assert n_schur > 0
    if case == "headline":
        assert (sched.cs, len(sched.levels), n_schur) == (128, 8, 337)


@pytest.mark.parametrize("n_sm", [78, 132])
@pytest.mark.parametrize("owner", ["rows", "cols", None])
@pytest.mark.parametrize("n_groups", [1, 2, 23, 51, 113, 300])
def test_pick_tile_choices(n_groups, owner, n_sm):
    cs = 128
    bm, bn = pick_tile(n_groups, cs, owner, n_sm)
    assert (bm, bn) in TILE_SHAPES[owner]
    blocks = n_groups * (cs // bm) * (cs // bn)
    assert blocks >= 8  # even a one-product launch spreads
    if owner == "rows":
        assert bn >= cs  # a block owns whole rows of its own a operand
    if owner == "cols":
        assert bm >= cs  # whole columns of its own b operand
    # the largest shape that fills the card; the smallest when none does
    shapes = list(TILE_SHAPES[owner])
    if blocks >= n_sm:
        bigger = shapes[:shapes.index((bm, bn))]
        assert all(n_groups * (cs // m) * (cs // n) < n_sm
                   for m, n in bigger)
    else:
        assert (bm, bn) == shapes[-1]


def test_tile_mm_refuses_a_destination_on_the_other_side(rng):
    """side="row" lets a destination be its own a operand only; an alias
    of b (or, with side="col", of a) would be a race in the kernel."""
    cs = 4
    out = torch.as_tensor(rng.standard_normal((4, cs, cs)))
    other = torch.as_tensor(rng.standard_normal((4, cs, cs)))
    g = make_groups([1], [[(0, 1)]], "cpu")
    with pytest.raises(ValueError, match="b operand"):
        tile_mm(out, other, out, g, side="row", subtract=False)
    with pytest.raises(ValueError, match="a operand"):
        tile_mm(out, out, other, make_groups([0], [[(0, 1)]], "cpu"),
                side="col", subtract=False)
    # the same indices in another bank are no alias
    want = other[0] @ other[1]
    tile_mm(out, other, other, g, side="row", subtract=False)
    np.testing.assert_allclose(out[1].numpy(), want.numpy(), rtol=1e-12)


def test_kernel_wrappers_reject_other_devices():
    meta = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device type 'meta'"):
        lu_tile(meta)
    with pytest.raises(ValueError, match="device type 'meta'"):
        span_gather(torch.zeros(4, device="meta"),
                    *(torch.zeros(2, dtype=torch.int32, device="meta"),) * 3,
                    4)
    g = make_groups([0], [[(0, 0)]], "cpu")
    with pytest.raises(ValueError, match="several devices"):
        tile_mm(meta, meta, meta, g, side="row", subtract=False)
    with pytest.raises(ValueError, match="together"):
        lu_tile(torch.zeros((1, 4, 4)), linv=torch.zeros((1, 4, 4)))


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

LIFE_CASES = {
    "laplace_cs8": (lambda rng: laplacian_1d(100), dict(chunk_size=8), 0.05),
    "poisson": (lambda rng: poisson_2d(10, 8), dict(chunk_size=8), 0.05),
    "block_banded": (lambda rng: block_banded(rng, 12, 6),
                     dict(chunk_size=8), 0.1),
    "fe": (lambda rng: fe_block_matrix(rng, 10, 5), dict(chunk_size=8), 0.0),
    "poisson_nd": (lambda rng: poisson_2d(14, 11),
                   dict(chunk_size=16, ordering="nd"), 0.05),
}


@pytest.mark.parametrize("case", sorted(LIFE_CASES))
def test_refactor_numeric_matches_jax(rng, case):
    """refactor_numeric then ldiv, both packages, float64 (the fe case
    refactors with the same values and must reproduce the host solve)."""
    make, cfg, scale = LIFE_CASES[case]
    A = make(rng)
    jf, tf = _pair(A, **cfg)
    b = rng.random(A.shape[0])
    x_host = tf.ldiv(b).numpy()
    A2 = _perturb(rng, A, scale)
    assert jf.refactor_numeric(A2) and tf.refactor_numeric(A2)
    assert tf.has_device_refactor
    got = tf.ldiv(b).numpy()
    assert_isapprox(got, np.asarray(jf.ldiv(b)), rtol=INV_TOL, atol=INV_TOL)
    assert_isapprox(got, spla.spsolve(A2.tocsc(), b), rtol=INV_TOL,
                    atol=INV_TOL)
    if scale == 0.0:
        assert_isapprox(got, x_host, rtol=INV_TOL, atol=INV_TOL)
    # the residual uses the new values
    assert_isapprox(tf.matvec(got).numpy(), A2 @ got, rtol=1e-12, atol=1e-12)
    # Rs and the factors, as JAX's device refactorization left them
    np.testing.assert_allclose(tf.Rs, np.asarray(jf.Rs), rtol=1e-12)
    Af = A2 if tf._ext is None else sp.csc_matrix(
        (tf._ext_values(sp.csc_matrix(A2)), tf._a_factor_pattern[1],
         tf._a_factor_pattern[0]), shape=(tf.n_factor, tf.n_factor))
    B = (sp.diags(tf.Rs) @ Af).toarray()[tf.p][:, tf.q]
    assert_isapprox((tf.L @ tf.U).toarray(), B, rtol=1e-12, atol=1e-12)
    assert (abs(tf.L - jf.L) > 1e-9).nnz == 0
    assert (abs(tf.U - jf.U) > 1e-9).nnz == 0


def test_refactor_numeric_repeated_with_refinement(rng):
    A = laplacian_1d(64)
    jf, tf = _pair(A, chunk_size=8)
    for _ in range(4):
        A = _perturb(rng, A, 0.02)
        jf.refactor_numeric(A)
        tf.refactor_numeric(A)
        b = rng.random(64)
        got = tf.ldiv(b, refine_steps=1).numpy()
        assert_isapprox(got, spla.spsolve(A, b), rtol=INV_TOL, atol=INV_TOL)
        assert_isapprox(got, np.asarray(jf.ldiv(b, refine_steps=1)),
                        rtol=INV_TOL, atol=INV_TOL)


def test_refactor_numeric_float32_bars(rng):
    """float32: the JAX f32 bars — backward error < 5e-6 after one
    refinement step (tests/test_solve.py:303), and agreement with JAX."""
    A = poisson_2d(14, 11)
    jf, tf = _pair(A, chunk_size=16, ordering="nd", dtype="float32")
    A2 = _perturb(rng, A, 0.05)
    jf.refactor_numeric(A2)
    tf.refactor_numeric(A2)
    B = rng.random((A.shape[0], 3)).astype(np.float32)
    got = tf.ldiv(B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.ldiv(B)),
                               rtol=1e-4, atol=1e-5)
    X = tf.ldiv(B, refine_steps=1).numpy().astype(np.float64)
    An = spla.norm(A2)
    for j in range(3):
        r = np.linalg.norm(A2 @ X[:, j] - B[:, j]) / (
            An * np.linalg.norm(X[:, j]) + np.linalg.norm(B[:, j]))
        assert r < 5e-6, f"backward error {r}"


def test_refactor_numeric_rejects_pattern_change():
    A = laplacian_1d(32)
    tf = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    A2 = A.tolil()
    A2[0, 31] = 1.0
    with pytest.raises(ValueError, match="same sparsity pattern"):
        tf.refactor_numeric(A2.tocsc())
    with pytest.raises(ValueError, match="same sparsity pattern"):
        tf.refactor_numeric(laplacian_1d(31))


def test_host_refactor_resets_device_refactor(rng):
    A = laplacian_1d(48)
    tf = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    tf.refactor_numeric(_perturb(rng, A, 0.05))
    assert tf.has_device_refactor
    A3 = _perturb(rng, A, 0.5)
    tf.refactor(A3)
    assert not tf.has_device_refactor
    b = rng.random(48)
    assert_isapprox(tf.ldiv(b).numpy(), spla.spsolve(A3, b), rtol=INV_TOL,
                    atol=INV_TOL)
    # refactor(None) after a device refactorization re-packs the NEW values
    A4 = _perturb(rng, A, 0.05)
    tf.refactor_numeric(A4)
    tf.refactor(None)
    assert_isapprox(tf.ldiv(b).numpy(), spla.spsolve(A4, b), rtol=INV_TOL,
                    atol=INV_TOL)


def test_check_benign_values_keeps_device(rng):
    A = laplacian_1d(64)
    tf = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    assert tf.refactor_numeric(_perturb(rng, A, 0.05), check=True)
    d = tf.refactor_diagnostics
    assert np.isfinite(float(d["growth"])) and float(d["growth"]) < 100
    assert float(d["min_pivot"]) > 0


def test_check_hostile_values_fall_back(rng):
    """tests/test_refactor.py:155-177: the leading pivot collapses, the
    frozen order blows up, check=True falls back to the host path."""
    n = 32
    rng2 = np.random.default_rng(3)
    A = sp.csc_matrix(np.eye(n) * 4.0 + 0.5 * rng2.standard_normal((n, n)))
    jf, tf = _pair(A, chunk_size=8)
    A2 = A.copy().tolil()
    A2[0, 0] = 1e-13
    A2 = sp.csc_matrix(A2)
    assert A2.nnz == A.nnz
    assert not jf.refactor_numeric(A2, check=True)
    assert not tf.refactor_numeric(A2, check=True)
    assert not tf.has_device_refactor
    b = rng.random(n)
    got = tf.ldiv(b).numpy()
    assert_isapprox(got, spla.spsolve(A2, b), rtol=1e-9, atol=1e-9)
    assert_isapprox(got, np.asarray(jf.ldiv(b)), rtol=1e-9, atol=1e-9)
    # unchecked, the same values are kept and the diagnostics show it
    tf2 = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    assert tf2.refactor_numeric(A2)
    g = float(tf2.refactor_diagnostics["growth"])
    assert (not np.isfinite(g)) or g > 1e7


@pytest.mark.parametrize("refine_steps", [0, 1])
def test_fused_step_matches_two_call_path(rng, refine_steps):
    A = poisson_2d(8, 8)
    n = A.shape[0]
    jf, tf = _pair(A, chunk_size=8)
    step = tf.make_refactor_solve_step(refine_steps=refine_steps)
    jstep = jf.make_refactor_solve_step(refine_steps=refine_steps)
    A2 = _perturb(rng, A, 0.05)
    b = rng.random((n, 3))
    x = step(A2.data, b)
    assert isinstance(x, torch.Tensor) and x.shape == (n, 3)
    assert_isapprox(x.numpy(), np.asarray(jstep(A2.data, b)), rtol=INV_TOL,
                    atol=INV_TOL)
    for j in range(3):
        assert_isapprox(x[:, j].numpy(), spla.spsolve(A2, b[:, j]),
                        rtol=INV_TOL, atol=INV_TOL)
    assert step(A2.data, b[:, 0]).shape == (n,)
    # F's state untouched: ldiv still solves the original A
    b1 = rng.random(n)
    assert_isapprox(tf.ldiv(b1).numpy(), spla.spsolve(A, b1), rtol=INV_TOL,
                    atol=INV_TOL)
    # the two-call path gives the same answer
    tf.refactor_numeric(A2)
    assert_isapprox(tf.ldiv(b, refine_steps=refine_steps).numpy(), x.numpy(),
                    rtol=INV_TOL, atol=INV_TOL)
    with pytest.raises(ValueError, match="values of A"):
        step(A2.data[:-1], b)
    # a host refactor makes the step stale; a new step works
    tf.refactor(_perturb(rng, A, 0.3))
    with pytest.raises(RuntimeError, match="stale"):
        step(A.data, b)
    step2 = tf.make_refactor_solve_step(refine_steps=refine_steps)
    assert_isapprox(step2(A.data, b).numpy(), spla.spsolve(A, b),
                    rtol=INV_TOL, atol=INV_TOL)


def test_fused_step_in_step_refinement_float32(rng):
    """tests/test_refactor.py:180-199: in float32 one in-step sweep
    tightens the solution."""
    A = poisson_2d(8, 8)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=8, dtype="float32"), device="cpu")
    A2 = _perturb(rng, A, 0.05)
    b = rng.random((A.shape[0], 2))
    x_exact = np.column_stack([spla.spsolve(A2, b[:, j]) for j in range(2)])
    e0 = np.linalg.norm(tf.make_refactor_solve_step()(A2.data, b).numpy()
                        - x_exact)
    e1 = np.linalg.norm(
        tf.make_refactor_solve_step(refine_steps=1)(A2.data, b).numpy()
        - x_exact)
    assert e1 <= e0 and e1 < 1e-4 * np.linalg.norm(x_exact)


@pytest.mark.parametrize("tri_mode", ["trsm", "inv_refine"])
def test_refactor_numeric_tri_modes(rng, tri_mode):
    """tests/test_refactor.py:115-122: static pivots in float64 still reach
    1e-12 in these modes, against ``spsolve`` and the JAX package."""
    A = poisson_2d(8, 8)
    cfg = dict(chunk_size=8, tri_mode=tri_mode)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(**cfg))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                              device="cpu")
    A2 = _perturb(rng, A, 0.05)
    jf.refactor_numeric(A2)
    tf.refactor_numeric(A2)
    b = rng.random(A.shape[0])
    x = tf.ldiv(b).numpy()
    assert_isapprox(x, spla.spsolve(A2, b), rtol=TOL, atol=TOL)
    assert_isapprox(x, np.asarray(jf.ldiv(b)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tri_mode", ["trsm", "inv_refine"])
def test_fused_step_tri_modes(rng, tri_mode):
    """The fused step feeds the mode's solve: 1e-12 against ``spsolve``
    and JAX's step, and the same bits as ``refactor_numeric`` + ``ldiv``."""
    A = poisson_2d(8, 8)
    cfg = dict(chunk_size=8, tri_mode=tri_mode)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(**cfg))
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(**cfg),
                              device="cpu")
    A2 = _perturb(rng, A, 0.05)
    b = rng.random((A.shape[0], 3))
    x = tf.make_refactor_solve_step()(A2.data, b)
    assert_isapprox(x.numpy(), np.asarray(
        jf.make_refactor_solve_step()(A2.data, b)), rtol=TOL, atol=TOL)
    for j in range(3):
        assert_isapprox(x[:, j].numpy(), spla.spsolve(A2, b[:, j]), rtol=TOL,
                        atol=TOL)
    tf.refactor_numeric(A2)
    assert torch.equal(tf.ldiv(b), x)


@pytest.mark.parametrize("refine_steps", [0, 1])
@pytest.mark.parametrize("ordering, tri_mode, dtype", [
    ("nd", "inv", "float32"), ("colamd", "trsm", "float64")])
def test_with_banks_is_the_one_bank_swap(rng, ordering, tri_mode, dtype,
                                         refine_steps):
    """``refactor_pipeline`` then ``DeviceFactors.with_banks`` solves to
    the bits of ``refactor_numeric`` then ``ldiv``, and of the
    refactor-solve step on the same values; the new state keeps the
    plans, the permutations and the task list."""
    A = poisson_2d(12, 10)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering=ordering, tri_mode=tri_mode, dtype=dtype),
        device="cpu")
    step = tf.make_refactor_solve_step(refine_steps=refine_steps)
    A2 = _perturb(rng, A, 0.05)
    b = torch.as_tensor(rng.random((A.shape[0], 3)), dtype=tf.dtype)
    before = tf._numeric
    N = before.with_banks(
        refactor_pipeline(torch.as_tensor(A2.data, dtype=tf.dtype),
                          tf._refactor_dev), tf._ext_pos_dev)
    assert N is not before and tf._numeric is before
    assert all(getattr(N, k) is getattr(before, k)
               for k in ("pidx", "qidx", "sched", "mode"))
    x_step = step(A2.data, b)
    assert tf._numeric is before  # the step leaves the solver's state
    tf.refactor_numeric(A2)
    assert tf._numeric is not before
    x = refine(N.solve, tf._residual, b, N.solve(b), refine_steps)
    assert torch.equal(x, tf.ldiv(b, refine_steps=refine_steps))
    assert torch.equal(x, x_step)


@pytest.mark.parametrize("tri_mode", ["trsm", "inv_refine"])
def test_factorize_device_tri_modes(rng, tri_mode):
    """A first factorization on the device feeds the mode's solve: 1e-12
    against ``spsolve`` after construction and after ``refactor_numeric``;
    the kernel and plain routes agree."""
    A = poisson_2d(14, 11)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", factorize="device", tri_mode=tri_mode),
        device="cpu")
    b = rng.random((A.shape[0], 2))
    assert_isapprox(tf.ldiv(b).numpy(), spla.spsolve(A.tocsc(), b), rtol=TOL,
                    atol=TOL)
    A2 = _perturb(rng, A, 0.05)
    tf.refactor_numeric(A2)
    assert_isapprox(tf.ldiv(b).numpy(), spla.spsolve(A2.tocsc(), b),
                    rtol=TOL, atol=TOL)
    B = torch.as_tensor(b)
    N = tf._numeric
    assert torch.equal(N.tiles(B, plain=True), N.tiles(B))


def test_plain_route_equals_kernel_route_on_cpu(rng):
    A = poisson_2d(14, 11)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd"), device="cpu")
    A2 = _perturb(rng, A, 0.05)
    tf.refactor_numeric(A2)
    b = torch.as_tensor(rng.random((A.shape[0], 2)))
    x = tf._numeric.tiles(b)
    tf.refactor_numeric(A2, plain=True)
    assert torch.equal(tf._numeric.tiles(b), x)


def test_cpu_refactor_launches_no_kernel(rng):
    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather, wave_apply

    A = poisson_2d(14, 11)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", factorize="device"), device="cpu")
    tf.refactor_numeric(_perturb(rng, A, 0.05))
    tf.make_refactor_solve_step(refine_steps=1)(A.data, rng.random(A.shape[0]))
    counts = (span_gather.LAUNCHES, lu_tile.LAUNCHES, tile_mm.LAUNCHES,
              perm_gather.LAUNCHES, wave_apply.LAUNCHES)
    assert counts == (0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# factorize="device" / "auto"
# ---------------------------------------------------------------------------


def test_factorize_auto_resolution():
    A = poisson_2d(10, 10)
    nd = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", factorize="auto"), device="cpu")
    assert nd.config.factorize == "device" and nd.has_device_refactor
    nat = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="natural", pivot_threshold=0.0,
        factorize="auto"), device="cpu")
    assert nat.config.factorize == "device"
    co = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, factorize="auto"), device="cpu")
    assert co.config.factorize == "host" and not co.has_device_refactor
    with pytest.raises(ValueError, match="static-diagonal-pivot"):
        tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
            chunk_size=8, factorize="device"), device="cpu")
    with pytest.raises(ValueError, match="unknown factorize"):
        tlu.SolverConfig(factorize="gpu")


def test_factorize_device_runs_no_superlu(rng, monkeypatch):
    """The first factorization runs on the device: the port's
    ``api.factorize_host`` (the name the solver calls) is never reached,
    not even by the pattern-only ``nd_cutoff="auto"`` trials."""
    calls = []
    orig = tapi.factorize_host
    monkeypatch.setattr(tapi, "factorize_host",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    A = poisson_2d(20, 20)
    n = A.shape[0]
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd", factorize="device", nd_cutoff="auto"),
        device="cpu")
    assert calls == [] and tf.has_device_refactor
    b = rng.random(n)
    assert_isapprox(tf.ldiv(b, refine_steps=1).numpy(),
                    spla.spsolve(A.tocsc(), b), rtol=INV_TOL, atol=INV_TOL)
    A2 = _perturb(rng, A, 0.05)
    tf.refactor_numeric(A2)
    assert_isapprox(tf.ldiv(b, refine_steps=1).numpy(),
                    spla.spsolve(A2.tocsc(), b), rtol=INV_TOL, atol=INV_TOL)
    assert calls == []
    # the guard is live: a host factorization does call it
    tlu.ParallelSparseLU(A, chunk_size=16, device="cpu")
    assert calls


def test_factorize_device_factors_match_jax(rng):
    """``factorize="device"`` in both packages: the same factors, Rs and
    solves, and the reference identity L @ U == (Rs·A)[p, q]."""
    A = poisson_2d(12, 12)
    cfg = dict(chunk_size=16, ordering="nd", factorize="device")
    jf, tf = _pair(A, **cfg)
    assert tf._nd_cutoff == jf._nd_cutoff
    np.testing.assert_allclose(tf.Rs, np.asarray(jf.Rs), rtol=1e-12)
    for name in ("L", "U"):
        got, want = getattr(tf, name), getattr(jf, name)
        assert got.shape == want.shape
        assert abs(got - want).max() < 1e-12
    Af = sp.csc_matrix(
        (tf._ext_values(sp.csc_matrix(A)), tf._a_factor_pattern[1],
         tf._a_factor_pattern[0]), shape=(tf.n_factor, tf.n_factor))
    B = (sp.diags(tf.Rs) @ Af)[tf.p][:, tf.q]
    assert abs(tf.L @ tf.U - B).max() < 1e-12
    assert np.allclose(tf.L.diagonal(), 1.0)
    b = rng.random(A.shape[0])
    assert_isapprox(tf.ldiv(b).numpy(), np.asarray(jf.ldiv(b)), rtol=INV_TOL,
                    atol=INV_TOL)


def test_from_jax_arrays_of_a_device_factorization(rng, tmp_path):
    """A JAX ``save(values=True)`` of a ``factorize="device"`` solver (its
    closure plans and materialized factors) carries across; both packages
    solve alike, and the port can refactor on from there."""
    A = poisson_2d(12, 12)
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
        chunk_size=16, ordering="nd", factorize="device", tri_mode="inv"))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        tf = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    b = rng.random(A.shape[0])
    assert_isapprox(tf.ldiv(b).numpy(), np.asarray(jf.ldiv(b)), rtol=INV_TOL,
                    atol=INV_TOL)
    A2 = _perturb(rng, A, 0.05)
    jf.refactor_numeric(A2)
    tf.refactor_numeric(A2)
    assert_isapprox(tf.ldiv(b).numpy(), np.asarray(jf.ldiv(b)), rtol=INV_TOL,
                    atol=INV_TOL)


# ---------------------------------------------------------------------------
# memory guard, close
# ---------------------------------------------------------------------------


def test_store_budget_guard(rng):
    A = poisson_2d(12, 12)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="working set"):
        tf.enable_device_refactor(store_budget=1)
    assert not tf.has_device_refactor
    b = rng.random(A.shape[0])
    np.testing.assert_allclose(tf.ldiv(b).numpy(), spla.spsolve(A.tocsc(), b),
                               rtol=1e-4, atol=1e-5)
    tf2 = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, dtype="float32", refactor_store_budget=1),
        device="cpu")
    with pytest.raises(RuntimeError, match="working set"):
        tf2.enable_device_refactor()
    with pytest.raises(RuntimeError, match="working set"):
        tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
            chunk_size=16, ordering="nd", factorize="device",
            refactor_store_budget=1), device="cpu")
    tf.enable_device_refactor(store_budget=8 * 1024**3)
    assert tf.has_device_refactor
    # the default budget is the device's free memory
    tf3 = tlu.ParallelSparseLU(A, chunk_size=16, device="cpu")
    tf3.enable_device_refactor()
    assert tf3.has_device_refactor


def test_close_releases_refactor_state(rng):
    A = poisson_2d(8, 8)
    tf = tlu.ParallelSparseLU(A, chunk_size=8, device="cpu")
    tf.refactor_numeric(_perturb(rng, A, 0.05))
    tf.close()
    assert not tf.has_device_refactor and tf._refactor_dev is None
    assert tf.refactor_diagnostics is None and tf._numeric is None


def _refined_oracle(A, b):
    """scipy's sparse LU solve refined twice with the residual in
    extended precision (``np.longdouble``): ~1e-16 relative, so the
    comparison measures the solver under test alone."""
    A = A.tocsc()
    lu = spla.splu(A)
    x = lu.solve(b)
    Al, bl = A.astype(np.longdouble), np.asarray(b, np.longdouble)
    for _ in range(2):
        x = x + lu.solve(np.asarray(bl - Al @ x.astype(np.longdouble),
                                    np.float64))
    return x


@pytest.mark.parametrize("path", ["refactor_numeric", "fused_step"])
@pytest.mark.parametrize("tri_mode", ["inv", "trsm", "inv_refine"])
def test_static_pivots_meet_1e12_with_one_refinement(tri_mode, path):
    """Static diagonal pivots (nd) on perturbed values can miss 1e-12 in
    float64 without refinement; one refinement step meets it, after
    ``refactor_numeric`` (``ldiv(refine_steps=1)``) and in the fused
    ``make_refactor_solve_step(refine_steps=1)``, in every mode."""
    A = poisson_2d(40, 40).tocsc()
    rng = np.random.default_rng(0)
    A2 = A.copy()
    A2.data = A.data * (1.0 + 0.05 * rng.standard_normal(A.data.shape))
    b = rng.random(A.shape[0])
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=64, ordering="nd", dtype="float64", tri_mode=tri_mode),
        device="cpu")
    if path == "refactor_numeric":
        F.refactor_numeric(A2)
        x = F.ldiv(b, refine_steps=1)
    else:
        x = F.make_refactor_solve_step(refine_steps=1)(A2.data, b)
    assert_isapprox(x.numpy(), _refined_oracle(A2, b), rtol=TOL, atol=0.0)
