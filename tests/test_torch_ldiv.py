"""The port's ldiv kernel module against the JAX fused Pallas ldiv.

The plain versions of the two kernels (``perm_gather_plain``,
``wave_apply_plain``) are what a CPU tensor runs, and what the CUDA kernels
are held against on the card; here they are held against the JAX package's
``pallas_fused_ldiv`` in interpret mode on the very same factorization,
carried across with ``ParallelSparseLU.from_jax_arrays``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _approx import assert_isapprox

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.models import fe_block_matrix, laplacian_1d, poisson_2d
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
from tpu_sparse_lu.pack import pack_factor_np
from tpu_sparse_lu.solve import block_rhs as jax_block_rhs
from tpu_sparse_lu.solve import unblock_rhs as jax_unblock_rhs
from tpu_sparse_lu_torch.ops.fused_ldiv import (
    Wave,
    build_waves,
    make_wave,
    perm_gather,
    perm_gather_plain,
    wave_apply,
    wave_apply_plain,
)
from tpu_sparse_lu_torch.pack import pack_factor


@pytest.fixture(autouse=True)
def _no_tf32():
    # full-precision float32 products in the plain path, on every device
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _jax_fused_ldiv(F, b):
    """JAX fused Pallas ldiv in interpret mode (as tests/test_pallas.py)."""
    ops = build_ldiv_ops(
        F._pvec, F.plan.lplan, F.plan.uplan, F._qvec, KA=F._K_in
    )
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
        jnp.asarray(ops.res_p), jnp.asarray(ops.res_q),
    )
    s_lu = build_lu_stream(
        jnp.asarray(stream_gather_spec(ops, sizes, 1)),
        F.ldata.diag_inv, F.ldata.offdiag,
        F.udata.diag_inv, F.udata.offdiag,
        dtype=F._stream_dt,
    )
    xw = jax_block_rhs(b, F.n, F._K_in, F.plan.cs) * F._rs_blk
    out = pallas_fused_ldiv(ops, s_perm, s_lu, xw, interpret=True)
    return np.asarray(jax_unblock_rhs(out, F.n))


def _carried(A, tmp_path, **cfg):
    """A JAX solver and the port solver built from its saved state."""
    jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(tri_mode="inv",
                                                         **cfg))
    path = tmp_path / "state.npz"
    jf.save(str(path), values=True)
    with np.load(path) as z:
        tf = tlu.ParallelSparseLU.from_jax_arrays(A, dict(z), device="cpu")
    return jf, tf


def _jax_bank(jdata):
    """The JAX solver's tile inverses and negated off-diagonal tiles as the
    port's transposed tile bank."""
    bank = np.concatenate([np.asarray(jdata.diag_inv),
                           np.asarray(jdata.offdiag)])
    return torch.as_tensor(bank.transpose(0, 2, 1).copy())


def _plain_ldiv(jf, tf, b):
    """The port's ldiv as the kernel module runs it — perm_gather, the L and
    U waves, perm_gather, all plain on CPU tensors — on the JAX solver's own
    tiles, so only the order of the sums differs from the JAX kernel."""
    R = b.shape[1]
    bt = torch.as_tensor(b, dtype=tf.dtype)
    N = tf._numeric
    xw = perm_gather_plain(bt, N.pidx, N.rs).view(
        tf.plan.lplan.K + 1, tf.plan.cs, R)
    for jdata, data in ((jf.ldata, N.ldata), (jf.udata, N.udata)):
        bank = _jax_bank(jdata)
        for w in data.waves:
            wave_apply_plain(xw, bank, w)
    return perm_gather_plain(xw.view(-1, R), N.qidx).numpy()


CASES = {
    "poisson": (lambda rng: poisson_2d(10, 8), dict(chunk_size=8)),
    "laplace1d": (lambda rng: laplacian_1d(50), dict(chunk_size=8)),
    "fe": (lambda rng: fe_block_matrix(rng, 10, 5), dict(chunk_size=8)),
    "poisson_nd": (lambda rng: poisson_2d(12, 12),
                   dict(chunk_size=16, ordering="nd")),
}


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ldiv_matches_jax_fused_ldiv(rng, tmp_path, case, R):
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _carried(A, tmp_path, dtype="float32", **cfg)
    if case == "poisson_nd":
        assert tf.n_factor > tf.n  # the embedding actually extended
    b = rng.random((A.shape[0], R)).astype(np.float32)
    ref = _jax_fused_ldiv(jf, jnp.asarray(b))
    got = _plain_ldiv(jf, tf, b)
    # the tolerance of tests/test_pallas.py:82, normwise as the reference
    # suite compares (Julia isapprox); elementwise too, except on the FE
    # system (cond ~ 3e2), whose smallest solution components carry f32
    # noise above 1e-6 absolute under any change of summation order
    assert_isapprox(got, ref, rtol=1e-5, atol=1e-6)
    if case != "fe":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["fe", "poisson_nd"])
def test_tiles_match_jax(rng, tmp_path, case):
    """Packed tiles equal the JAX packer's; the tile inverses agree with
    the JAX package's recursive inverses."""
    make, cfg = CASES[case]
    A = make(rng)
    jf, tf = _carried(A, tmp_path, **cfg)
    for tplan, M, jdata, tdata in (
            (tf.plan.lplan, tf.L, jf.ldata, tf._numeric.ldata),
            (tf.plan.uplan, tf.U, jf.udata, tf._numeric.udata)):
        diag, off = pack_factor(tplan, torch.as_tensor(M.data))
        want_d, want_o = pack_factor_np(tplan, np.asarray(M.data))
        np.testing.assert_array_equal(diag.numpy(), want_d)
        np.testing.assert_array_equal(off.numpy(), want_o)
        np.testing.assert_array_equal(tdata.offdiag.numpy(),
                                      np.asarray(jdata.offdiag))
        np.testing.assert_allclose(tdata.diag_inv.numpy(),
                                   np.asarray(jdata.diag_inv),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_schedule_structure(rng, case):
    """Each chunk is solved once, each tile applied once, a wave never
    reads a block it writes, and every tile's source is solved before it
    is applied and its destination after."""
    make, cfg = CASES[case]
    F = tlu.ParallelSparseLU(make(rng), config=tlu.SolverConfig(**cfg),
                             device="cpu")
    for tplan in (F.plan.lplan, F.plan.uplan):
        K, T = tplan.K, tplan.T
        waves = build_waves(tplan, "cpu")
        solved_at = np.full(K, -1)
        applied = np.zeros(T, dtype=int)
        for i, w in enumerate(waves):
            dst, src = w.dst.numpy(), w.ent_src.numpy()
            tile = w.ent_tile.numpy()
            assert len(set(dst.tolist())) == len(dst)
            assert np.array_equal(np.diff(w.ptr.numpy()) > 0,
                                  np.ones(len(dst), bool))
            if not w.accumulate:
                assert np.array_equal(src, dst) and np.array_equal(tile, dst)
                assert (solved_at[dst] == -1).all()
                solved_at[dst] = i
            else:
                assert not set(src.tolist()) & set(dst.tolist())
                t = tile - (K + 1)
                assert (t >= 0).all() and (t < T).all()
                applied[t] += 1
                assert (solved_at[src] >= 0).all()
                assert (solved_at[dst] == -1).all()
                rows = w.ent_row.numpy()
                assert np.array_equal(dst[rows], tplan.tile_brow[t])
                assert np.array_equal(src, tplan.tile_bcol[t])
        assert (solved_at >= 0).all()
        assert (applied == 1).all()
        assert len(waves) == tplan.num_levels + int(
            np.count_nonzero(tplan.level_tile_counts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [1, 3])
def test_wave_apply_plain_semantics(rng, dtype, R):
    """x[dst] = acc·x[dst] + Σ tile·x[src], in place, against a loop."""
    cs, nb = 4, 6
    x0 = rng.standard_normal((nb, cs, R))
    tiles = rng.standard_normal((5, cs, cs))
    cases = [
        ([0, 2, 4], [[(1, 0)], [(3, 2)], [(4, 4)]], False),
        ([5, 1], [[(0, 0), (2, 2), (4, 4)], [(1, 2)]], True),
    ]
    for dst, groups, acc in cases:
        want = x0.copy()
        for d, g in zip(dst, groups):
            s = sum(tiles[t] @ x0[sb] for t, sb in g)
            want[d] = s + (x0[d] if acc else 0)
        x = torch.as_tensor(x0, dtype=dtype)
        tiles_t = torch.as_tensor(tiles.transpose(0, 2, 1).copy(),
                                  dtype=dtype)
        out = wave_apply(x, tiles_t, make_wave(dst, groups, acc, "cpu"))
        assert out is x
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        np.testing.assert_allclose(x.numpy(), want, rtol=tol, atol=tol)


def test_perm_gather_plain_semantics(rng):
    v = rng.standard_normal((7, 3))
    scale = rng.random(7) + 0.5
    idx = np.array([3, -1, 0, 6, -1, 2, 7], dtype=np.int32)
    inside = ((idx >= 0) & (idx < 7))[:, None]
    src = np.where(idx < 7, idx, 0)
    want = np.where(inside, (scale[:, None] * v)[src], 0.0)
    got = perm_gather(torch.as_tensor(v), torch.as_tensor(idx),
                      torch.as_tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)
    got = perm_gather(torch.as_tensor(v), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(inside, v[src], 0.0))


def test_cpu_tensors_launch_no_kernel(rng):
    before = (perm_gather.LAUNCHES, wave_apply.LAUNCHES)
    A = poisson_2d(12, 12)
    F = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(
        chunk_size=16, ordering="nd"), device="cpu")
    F.ldiv(rng.random((A.shape[0], 2)), refine_steps=1)
    F.lsolve(rng.random(F.n_factor))
    assert (perm_gather.LAUNCHES, wave_apply.LAUNCHES) == before == (0, 0)


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="device type 'meta'"):
        perm_gather(torch.zeros((2, 1), device="meta"),
                    torch.zeros(2, dtype=torch.int32, device="meta"))
    w = make_wave([0], [[(0, 0)]], False, "cpu")
    with pytest.raises(ValueError, match="several devices"):
        wave_apply(torch.zeros((2, 4, 1), device="meta"),
                   torch.zeros((1, 4, 4)), w)
    with pytest.raises(ValueError, match="several devices"):
        perm_gather(torch.zeros((2, 1)), torch.zeros(2, dtype=torch.int32,
                                                     device="meta"))


def test_wave_rejects_bad_index_arrays():
    w = make_wave([0, 2], [[(1, 0)], [(0, 2), (1, 0)]], True, "cpu")
    with pytest.raises(ValueError, match="int32"):
        Wave(dst=w.dst.long(), ptr=w.ptr, ent_tile=w.ent_tile,
             ent_src=w.ent_src, ent_row=w.ent_row, accumulate=True)
    with pytest.raises(ValueError, match="inconsistent"):
        Wave(dst=w.dst, ptr=w.ptr[:-1], ent_tile=w.ent_tile,
             ent_src=w.ent_src, ent_row=w.ent_row, accumulate=True)
    with pytest.raises(ValueError, match="ptr"):
        Wave(dst=w.dst, ptr=w.ptr.flip(0), ent_tile=w.ent_tile,
             ent_src=w.ent_src, ent_row=w.ent_row, accumulate=True)
    with pytest.raises(ValueError, match="negative"):
        Wave(dst=w.dst, ptr=w.ptr, ent_tile=-w.ent_tile, ent_src=w.ent_src,
             ent_row=w.ent_row, accumulate=True)
    assert (w.blocks, w.tiles) == (3, 2)
    with pytest.raises(ValueError, match="past the carrier"):
        wave_apply(torch.zeros((2, 4, 1)), torch.zeros((2, 4, 4)), w)
    with pytest.raises(ValueError, match="tile bank"):
        wave_apply(torch.zeros((3, 4, 1)), torch.zeros((1, 4, 4)), w)
