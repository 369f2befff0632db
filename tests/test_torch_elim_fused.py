"""The one-launch elimination's task list (``ops/elim_fused.py``) against
the per-level route and the JAX package, on the CPU.

Same matrices, seeded with numpy, through both packages:

* the task list keeps the hazard rule: every dependency is a real
  conflict over store tiles and inverse slots, every conflicting pair of
  tasks is ordered (directly or through other tasks), every dependency
  lies at an earlier ticket, and each product's sub-tile shape is one
  the in-place rule allows;
* ``elim_fused_plain`` in the ticket order and in 3 seeded random
  topological orders gives the same bits, and agrees with the per-level
  plain route (``eliminate(route="levels", plain=True)``) within
  ``chip_smoke.ELIM_TOL`` (it sums the products of a task in the same
  order; only the batching of ``bmm`` differs);
* it agrees with JAX ``fused_elimination`` (interpret mode) and
  ``_blocked_elimination`` at the bounds ``tests/test_torch_refactor.py``
  holds the per-level route to: float32 the JAX package's own bounds
  between its two implementations, float64 1e-12 (summation order only).

The cases: a chain of one-tile levels (BASELINE config 2's shape at
small n) and nd cases with wide levels whose Schur updates share
destination tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse_lu as jlu
import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu.assemble import assemble_windowed
from tpu_sparse_lu.models import block_banded, poisson_2d
from tpu_sparse_lu.ops.pallas_elim import fused_elimination
from tpu_sparse_lu.refactor import _blocked_elimination
from tpu_sparse_lu_torch.assemble import assemble
from tpu_sparse_lu_torch.ops import elim_fused as ef
from tpu_sparse_lu_torch.ops.elimination import eliminate

# chip_smoke.ELIM_TOL: max relative difference of two eliminations that
# differ in rounding order only
ELIM_TOL = {"float32": 1e-4, "float64": 1e-11}

CASES = {
    # one-tile levels, a chain (config 2's shape)
    "chain_bb_24_12": (lambda rng: block_banded(rng, 24, 12),
                       dict(chunk_size=16)),
    "chain_bb_40_6": (lambda rng: block_banded(rng, 40, 6),
                      dict(chunk_size=16)),
    # nd: wide levels, shared Schur destinations
    "nd_poisson_14_11": (lambda rng: poisson_2d(14, 11),
                         dict(chunk_size=16, ordering="nd")),
    "nd_poisson_20_20": (lambda rng: poisson_2d(20, 20),
                         dict(chunk_size=32, ordering="nd", nd_cutoff=64)),
}


def _solver(rng, case, dtype="float32", jax_too=False):
    make, cfg = CASES[case]
    A = make(rng)
    tf = tlu.ParallelSparseLU(A, config=tlu.SolverConfig(dtype=dtype, **cfg),
                              device="cpu")
    tf.enable_device_refactor()
    jf = None
    if jax_too:
        jf = jlu.ParallelSparseLU(A, config=jlu.SolverConfig(
            tri_mode="inv", dtype=dtype, **cfg))
        jf.enable_device_refactor()
    return A, tf, jf


def _store(A, tf):
    dev = tf._refactor_dev
    a = torch.as_tensor(A.tocsc().data, dtype=tf.dtype)
    return assemble(a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF,
                    TF2=dev.TF2)[0]


def _conflict(x, y) -> bool:
    (rx, wx), (ry, wy) = x, y
    return bool(set(wx) & (set(ry) | set(wy)) or set(rx) & set(wy))


def _random_order(tasks, seed):
    """A seeded random topological order of the task list (Kahn's
    algorithm, a random ready task each step)."""
    r = np.random.default_rng(seed)
    succ = [[] for _ in range(tasks.n_tasks)]
    for t, d in enumerate(tasks.deps):
        for s in d:
            succ[s].append(t)
    waiting = [len(d) for d in tasks.deps]
    ready = [t for t in range(tasks.n_tasks) if not waiting[t]]
    order = []
    while ready:
        t = ready.pop(int(r.integers(len(ready))))
        order.append(t)
        for s in succ[t]:
            waiting[s] -= 1
            if not waiting[s]:
                ready.append(s)
    assert len(order) == tasks.n_tasks
    return order


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_list_keeps_the_hazard_rule(rng, case):
    _, tf, _ = _solver(rng, case)
    sched = tf._refactor_dev.elim
    tasks = sched.tasks
    n = tasks.n_tasks
    kinds = tasks.task[:, 0] & ef.KIND_MASK
    # one LU task per real diagonal tile, one product task per destination
    assert (kinds == ef.LU).sum() == sched.n_diag
    for kind, attr in ((ef.ROWS, "rows"), (ef.COLS, "cols"),
                       (ef.SCHUR, "schur")):
        want = sum(len(getattr(lvl, attr).host[0]) for lvl in sched.levels
                   if getattr(lvl, attr) is not None)
        assert (kinds == kind).sum() == want
    # every dependency is earlier and a real conflict; reach[t]: the tasks
    # t is ordered after, directly or through others
    reach = [0] * n
    for t in range(n):
        for s in tasks.deps[t]:
            assert s < t
            assert _conflict(tasks.access[s], tasks.access[t]), (s, t)
            reach[t] |= reach[s] | (1 << s)
    # every conflicting pair is ordered
    for t in range(n):
        for s in range(t):
            if _conflict(tasks.access[s], tasks.access[t]):
                assert reach[t] >> s & 1, (s, t)
    # a task's ticket waits on every ticket of its dependencies
    for t in range(n):
        got = tasks.dep[tasks.dep_ptr[t]:tasks.dep_ptr[t + 1]].tolist()
        want = [x for s in tasks.deps[t]
                for x in range(tasks.tick0[s], tasks.tick0[s + 1])]
        assert got == want
    assert (tasks.ticket_task[tasks.tick0[:-1]] == np.arange(n)).all()
    # tickets: one per LU, one a sub-tile for a product, of a shape the
    # in-place rule allows
    cs = tasks.cs
    for t in range(n):
        flags = int(tasks.task[t, 0])
        kind, code = flags & ef.KIND_MASK, flags >> ef.SHAPE_SHIFT
        n_tick = tasks.tick0[t + 1] - tasks.tick0[t]
        if kind == ef.LU:
            assert n_tick == 1
            continue
        bm, bn = ef.FUSED_SHAPES[code]
        assert code in ef._SHAPE_CODES[kind]
        assert n_tick == -(-cs // bm) * -(-cs // bn)
        if kind == ef.ROWS:
            assert bn >= cs
        if kind == ef.COLS:
            assert bm >= cs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_twin_in_any_order_matches_the_level_route(rng, case, dtype):
    A, tf, _ = _solver(rng, case, dtype)
    sched = tf._refactor_dev.elim
    store = _store(A, tf)
    TF = sched.n_tiles - 2
    want = eliminate(store.clone(), sched, route="levels", plain=True)
    first = ef.elim_fused_plain(store.clone(), sched.tasks)
    for g, w in zip(first[1:], want[1:]):
        assert g.shape == w.shape
    tol = ELIM_TOL[dtype]
    for g, w in ((first[0][:TF], want[0][:TF]), *zip(first[1:], want[1:])):
        scale = max(float(w.abs().max()), 1e-300)
        assert float((g - w).abs().max()) / scale <= tol
    # the dummy tiles are never touched
    assert torch.equal(first[0][TF:], store[TF:])
    for seed in range(3):
        got = ef.elim_fused_plain(store.clone(), sched.tasks,
                                  order=_random_order(sched.tasks, seed))
        for g, f in zip(got, first):
            assert torch.equal(g, f)
    # the entry point on a CPU tensor runs the plain twin, no launch
    ef.elim_fused.LAUNCHES = 0
    out = eliminate(store.clone(), sched)
    assert ef.elim_fused.LAUNCHES == 0
    for g, f in zip(out, first):
        assert torch.equal(g, f)


def _jax_elim_args(jf):
    d = jf._refactor_dev
    return (d["diag_ids"], d["diag_cnt"], d["row_ids"], d["row_owner"],
            d["col_ids"], d["col_owner"], d["schur"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_twin_matches_jax(rng, case, dtype):
    """Against JAX ``fused_elimination`` (interpret mode) on the float32
    chains, ``_blocked_elimination`` on the rest: the nd cases' levels are
    wider than the Pallas kernel's gate (``pallas_elim.py:53-66``), and its
    float64 trace stops at a float32 store into its float64 scratch (as
    in ``tests/test_torch_refactor.py``, which runs it in float32 only)."""
    A, tf, jf = _solver(rng, case, dtype, jax_too=True)
    rp = jf._refactor_plan
    w = rp.win
    tiles, _ = assemble_windowed(
        jnp.asarray(A.tocsc().data.astype(dtype)), jf._refactor_dev, n=rp.n,
        cs=rp.cs, TF=rp.TF, TF2=w.TF2, W=w.W, R1=w.R1, Np=w.Np)
    args = _jax_elim_args(jf)
    NL, BL = args[0].shape
    assert (BL == 1) == case.startswith("chain")
    if BL == 1 and dtype == "float32":
        want = fused_elimination(
            tiles, *args, cs=rp.cs, NL=NL, BL=BL, MR=args[2].shape[1],
            MU=args[4].shape[1], MS=args[6].shape[1], interpret=True)
    else:
        want = _blocked_elimination(tiles, *args, cs=rp.cs)
    got = ef.elim_fused_plain(torch.as_tensor(np.array(tiles)),
                              tf._refactor_dev.elim.tasks)
    rtol, atol = (2e-5, 1e-5) if dtype == "float32" else (1e-12, 1e-12)
    t_ref, mp_ref, li_ref, ui_ref = map(np.asarray, want)
    np.testing.assert_allclose(got[0][: rp.TF].numpy(), t_ref[: rp.TF],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(got[1]), float(mp_ref), rtol=rtol)
    for l in range(rp.NL):
        c = int(rp.diag_cnt[l])
        np.testing.assert_allclose(got[2][l, :c].numpy(), li_ref[l, :c],
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(got[3][l, :c].numpy(), ui_ref[l, :c],
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ticket_order_runs_the_longest_path_first(rng, case):
    """The ticket order is the level order's graph in another topological
    order: it starts with the diagonal LU that heads the longest weighted
    path, and it is made the same way every time."""
    _, tf, _ = _solver(rng, case)
    sched = tf._refactor_dev.elim
    tasks = sched.tasks
    assert tasks.task[0, 0] & ef.KIND_MASK == ef.LU
    assert tasks.task[0, 1] in sched.levels[0].diag_host
    again = ef.build_elim_tasks(sched, "cpu")
    for k in ("task", "tick0", "dep_ptr", "dep", "ent_a", "ent_b"):
        np.testing.assert_array_equal(getattr(again, k), getattr(tasks, k))
    # the same tasks as the level order, each once
    level = ef._level_tasks(sched, ef.DEFAULT_SMS)
    assert sorted((f, d) for f, d, *_ in level) == sorted(
        map(tuple, tasks.task[:, :2].tolist()))


def test_entry_point_checks(rng):
    A, tf, _ = _solver(rng, "chain_bb_24_12")
    sched = tf._refactor_dev.elim
    store = _store(A, tf)
    with pytest.raises(ValueError, match="route"):
        eliminate(store, sched, route="tiles")
    with pytest.raises(ValueError, match="does not match"):
        eliminate(store[:-1], sched)
    # a plan made for a card picks its shapes for the card's SMs: fewer
    # SMs never pick a smaller sub-tile
    few = ef.build_elim_tasks(sched, "cpu", n_sm=1)
    many = ef.build_elim_tasks(sched, "cpu", n_sm=1000)
    assert few.n_tickets <= many.n_tickets
