"""The blocked elimination in one launch (B3): counterpart of
``tpu_sparse_lu/ops/pallas_elim.py`` ``fused_elimination``.

The TPU kernel runs every level of the elimination as one program, the
store resident in VMEM. Here the same work is a task list the host makes
once per plan (:func:`build_elim_tasks`, kept on the
:class:`~tpu_sparse_lu_torch.ops.elimination.ElimSchedule`), run by one
persistent launch of ``csrc/elim_fused.cu``: an LU task per real diagonal
tile (with its two inverses and its min |pivot|), a row-panel and a
column-panel task per destination tile, a Schur task per destination
group. Each product task is cut into sub-tiles of one shape
(:data:`FUSED_SHAPES`): a ticket is a task and one of its sub-tiles. A task waits for every ticket of the earlier tasks
it conflicts with over store tiles and inverse slots
(:func:`~tpu_sparse_lu_torch.ops._tasks.hazard_deps`).

:func:`elim_fused` launches the kernel on a CUDA tensor and runs
:func:`elim_fused_plain` (the tasks one by one with ``lu_tile_plain`` and
``tile_mm_plain``) on a CPU tensor; ``elim_fused.LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from ._launch import KERNEL_DTYPES, check, device_kind, lib, require, stream
from ._tasks import hazard_deps
from .elimination import make_groups, tile_mm_plain
from .lu_tile import lu_tile_plain

__all__ = ["FUSED_SHAPES", "ElimTasks", "build_elim_tasks", "elim_fused",
           "elim_fused_plain"]

# task kinds, in the low bits of a task's flags; the sub-tile shape's
# code (an index of FUSED_SHAPES) above SHAPE_SHIFT
LU, ROWS, COLS, SCHUR = 0, 1, 2, 3
KIND_MASK = 15
SHAPE_SHIFT = 4
TASK_WORDS = 6  # flags, dst, e0, e1, inverse slot, pivot index

# The sub-tiles (rows, cols) a product ticket computes, as
# csrc/elim_fused.cu builds them (kShapeBM, kShapeBN), by what a
# sub-tile must own: whole rows for a row panel (its destination is its
# own a operand), whole columns for a column panel (its own b), any split
# for a Schur update. Largest first.
FUSED_SHAPES = ((32, 128), (16, 128), (128, 32), (128, 16), (64, 64),
                (32, 64), (32, 32))
_SHAPE_CODES = {ROWS: (0, 1), COLS: (2, 3), SCHUR: (4, 5, 6)}
# SMs assumed when a plan is made off the card; on a card, its own count
DEFAULT_SMS = 132
# the model of the ticket order's list schedule, in us a ticket on an
# H100 (the launch's per-ticket clocks, tools/elim_sweep.py --clocks,
# PERF.md): a diagonal LU of a 128 x 128 tile with both inverses, and a
# product sub-tile per entry
_LU_US, _ENTRY_US = 75.0, 12.0


def _n_sub(cs: int, code: int) -> int:
    bm, bn = FUSED_SHAPES[code]
    return -(-cs // bm) * -(-cs // bn)


def _n_tickets(cs: int, flags: int) -> int:
    """Tickets of a task: one for an LU, one a sub-tile for a product."""
    if flags & KIND_MASK == LU:
        return 1
    return _n_sub(cs, flags >> SHAPE_SHIFT)


def pick_fused_shape(n_tasks: int, cs: int, kind: int, n_sm: int) -> int:
    """The flags of a level's ``n_tasks`` product tasks of ``kind``: the
    largest shape whose sub-tiles are at least two per SM (the larger
    shapes do more FMAs a shared-memory load, and a wide level is bound by
    throughput), else the smallest (a narrow level is a step of the chain
    of diagonal tiles, where a sub-tile's latency counts)."""
    codes = _SHAPE_CODES[kind]
    code = next((c for c in codes if n_tasks * _n_sub(cs, c) >= 2 * n_sm),
                codes[-1])
    return kind | code << SHAPE_SHIFT


@dataclasses.dataclass
class ElimTasks:
    """The whole elimination as one list of tasks in ticket order: the
    host side of :func:`elim_fused`.

    ``task[t]`` is ``(flags, dst, e0, e1, slot, piv)``: the kind and the
    sub-tile shape's code (``kind | code << SHAPE_SHIFT``,
    :func:`pick_fused_shape`), the store tile
    it writes, for a product its entries ``e0:e1`` of ``ent_a``/``ent_b``
    (the operand tiles, in the plan's order), for an LU its slot in the
    inverse stacks and its index in the pivot vector. Task ``t`` owns
    tickets ``tick0[t]:tick0[t+1]`` (``ticket_task`` maps back); the
    tickets it waits for are ``dep[dep_ptr[t]:dep_ptr[t+1]]``, every
    ticket of each task in ``deps[t]``. ``access[t]`` is its
    ``(reads, writes)``: store tile ``i`` is resource ``i``, ``L⁻¹`` slot
    ``s`` resource ``n_tiles + s``, ``U⁻¹`` slot ``s`` resource
    ``n_tiles + NL·BL + s``. Host arrays are NumPy int32.
    """

    cs: int
    n_tiles: int
    NL: int
    BL: int  # inverse slots: NL * BL
    n_diag: int
    task: np.ndarray  # (n_tasks, TASK_WORDS)
    tick0: np.ndarray  # (n_tasks + 1,)
    dep_ptr: np.ndarray  # (n_tasks + 1,)
    dep: np.ndarray
    ent_a: np.ndarray
    ent_b: np.ndarray
    deps: list  # per task, the earlier tasks it waits for
    access: list  # per task, (reads, writes) resources
    device: torch.device

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.ticket_task = np.repeat(
            np.arange(self.n_tasks, dtype=np.int32),
            np.diff(self.tick0)).astype(np.int32)
        self._on = {}
        self._state = {}
        self.on(self.device)

    @property
    def n_tasks(self) -> int:
        return self.task.shape[0]

    @property
    def n_tickets(self) -> int:
        return int(self.tick0[-1])

    def on(self, device) -> dict:
        """The index arrays as int32 tensors on ``device`` (kept)."""
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = {
                k: torch.as_tensor(np.ascontiguousarray(getattr(self, k)),
                                   device=dev)
                for k in ("task", "tick0", "ticket_task", "dep_ptr", "dep",
                          "ent_a", "ent_b")}
        return self._on[dev]

    def state(self, device, stream: int = 0) -> torch.Tensor:
        """The kernel's int32 words on the raw CUDA stream ``stream``,
        made once and then left to the kernel: ticket counter, exit
        counter, generation (starts at 1), one ready flag per ticket
        (start at 0). One set serves one launch at a time: launches on one
        stream run one after another."""
        key = (torch.device(device), stream)
        if key not in self._state:
            s = torch.zeros(3 + self.n_tickets, dtype=torch.int32,
                            device=device)
            s[2] = 1
            self._state[key] = s
        return self._state[key]


def _level_tasks(sched, n_sm):
    """The tasks of the elimination in level order, as
    ``(flags, dst, entries, slot, piv, reads, writes)``."""
    cs, T, S = sched.cs, sched.n_tiles, sched.NL * sched.BL
    out, piv = [], 0
    for lvl in sched.levels:
        for b, d in enumerate(lvl.diag_host.tolist()):
            s = lvl.slot0 + b
            out.append((LU, d, [], s, piv, (d,), (d, T + s, T + S + s)))
            piv += 1
        for kind, g in ((ROWS, lvl.rows), (COLS, lvl.cols),
                        (SCHUR, lvl.schur)):
            if g is None:
                continue
            dst, ptr, a, b = g.host
            flags = pick_fused_shape(len(dst), cs, kind, n_sm)
            for i, d in enumerate(dst.tolist()):
                ent = list(zip(a[ptr[i]:ptr[i + 1]].tolist(),
                               b[ptr[i]:ptr[i + 1]].tolist()))
                if kind == ROWS:  # A_d <- A_d . Uinv[s]
                    reads = [d] + [T + S + y for _, y in ent]
                elif kind == COLS:  # A_d <- Linv[s] . A_d
                    reads = [T + x for x, _ in ent] + [d]
                else:  # A_d <- A_d - sum L . U
                    reads = [d] + [t for e in ent for t in e]
                out.append((flags, d, ent, 0, 0, tuple(reads), (d,)))
    return out


def _simulated_order(level, deps, tickets, n_sm):
    """A topological order of the tasks: the order in which a list
    schedule of their tickets on ``n_sm`` blocks starts them, a ticket to
    a block, the ready task with the longest weighted path to the end
    first (an LU ``_LU_US``, a product ticket ``_ENTRY_US`` an entry). The
    kernel's blocks take tickets in this order, so a ticket taken tends to
    be one whose dependencies are done or about to be, and blocks do not
    sit on tickets of a later level while ready products wait behind
    them."""
    n = len(level)
    succ = [[] for _ in range(n)]
    for t, d in enumerate(deps):
        for s in d:
            succ[s].append(t)
    cost = [_LU_US if f & KIND_MASK == LU else _ENTRY_US * len(e)
            for f, _, e, *_ in level]
    height = [0.0] * n
    for t in range(n - 1, -1, -1):  # successors come later in level order
        height[t] = cost[t] + max((height[s] for s in succ[t]), default=0)
    waiting = [len(d) for d in deps]
    left, done = list(tickets), [0] * n
    ready = [(-height[t], t) for t in range(n) if not waiting[t]]
    heapq.heapify(ready)
    events, order, free, now = [], [], n_sm, 0.0
    while ready or events:
        while free and ready:  # the free blocks take ready tickets
            t = ready[0][1]
            if left[t] == tickets[t]:
                order.append(t)
            left[t] -= 1
            free -= 1
            heapq.heappush(events, (now + cost[t], t))
            if not left[t]:
                heapq.heappop(ready)
        now, t = heapq.heappop(events)
        free += 1
        done[t] += 1
        if done[t] == tickets[t]:
            for s in succ[t]:
                waiting[s] -= 1
                if not waiting[s]:
                    heapq.heappush(ready, (-height[s], s))
    assert len(order) == n, "the task graph has a cycle"
    return order


def build_elim_tasks(sched, device, n_sm: Optional[int] = None) -> ElimTasks:
    """The task list of :func:`elim_fused` (:class:`ElimTasks`) from an
    ``ElimSchedule``'s levels: the dependencies come from the level order,
    the ticket order from a list schedule on the card's blocks. ``n_sm``
    — the SMs the sub-tile shapes and the order are made for (default:
    the card's, on a CUDA device, else ``DEFAULT_SMS``)."""
    device = torch.device(device)
    if n_sm is None:
        n_sm = (torch.cuda.get_device_properties(device)
                .multi_processor_count if device.type == "cuda"
                else DEFAULT_SMS)
    level = _level_tasks(sched, n_sm)
    n_res = sched.n_tiles + 2 * sched.NL * sched.BL
    level_deps = hazard_deps([(r, w) for *_, r, w in level], n_res)
    tickets = [_n_tickets(sched.cs, f) for f, *_ in level]
    order = _simulated_order(level, level_deps, tickets, n_sm)
    pos = np.empty(len(order), dtype=np.int64)
    pos[order] = np.arange(len(order))
    task, ent, tick0, deps = [], [], [0], []
    for t in order:
        flags, d, e, slot, p, _, _ = level[t]
        e0 = len(ent)
        ent.extend(e)
        task.append((flags, d, e0, len(ent), slot, p))
        tick0.append(tick0[-1] + tickets[t])
        deps.append(sorted(int(pos[s]) for s in level_deps[t]))
    tick0 = np.asarray(tick0, dtype=np.int32)
    dep = [list(range(tick0[s], tick0[s + 1])) for d in deps for s in d]
    n_dep = [sum(int(tick0[s + 1] - tick0[s]) for s in d) for d in deps]
    ent = np.asarray(ent, dtype=np.int32).reshape(-1, 2)
    return ElimTasks(
        cs=sched.cs, n_tiles=sched.n_tiles, NL=sched.NL, BL=sched.BL,
        n_diag=sched.n_diag, task=np.asarray(task, dtype=np.int32),
        tick0=tick0,
        dep_ptr=np.concatenate([[0], np.cumsum(n_dep)]).astype(np.int32),
        dep=np.asarray([x for d in dep for x in d], dtype=np.int32),
        ent_a=np.ascontiguousarray(ent[:, 0]),
        ent_b=np.ascontiguousarray(ent[:, 1]),
        deps=deps, access=[level[t][5:] for t in order], device=device)


def _outputs(store: torch.Tensor, tasks: ElimTasks):
    """Zeroed inverse stacks and a pivot vector of infinities."""
    linv = torch.zeros((tasks.NL * tasks.BL, tasks.cs, tasks.cs),
                       dtype=store.dtype, device=store.device)
    piv = torch.full((max(tasks.n_diag, 1),), float("inf"),
                     dtype=store.dtype, device=store.device)
    return linv, torch.zeros_like(linv), piv


def _result(store, tasks, linv, uinv, piv):
    """``eliminate``'s tuple; the min is NaN-propagating, as the JAX
    package's jnp.min."""
    shape = (tasks.NL, tasks.BL, tasks.cs, tasks.cs)
    return store, piv.amin(), linv.view(shape), uinv.view(shape)


def _plain_steps(tasks: ElimTasks, dev) -> list:
    """Per task, what :func:`elim_fused_plain` needs on ``dev``, made
    once: an LU's tile, slot and pivot index, a product's kind and its one
    group (``make_groups``)."""
    idx = tasks.on(dev)
    if "steps" not in idx:
        ea, eb = tasks.ent_a.tolist(), tasks.ent_b.tolist()
        steps = []
        for flags, d, e0, e1, slot, p in tasks.task.tolist():
            kind = flags & KIND_MASK
            if kind == LU:
                steps.append((LU, d, slot, p))
            else:
                steps.append((kind, make_groups(
                    [d], [list(zip(ea[e0:e1], eb[e0:e1]))], dev)))
        idx["steps"] = steps
    return idx["steps"]


def elim_fused_plain(store: torch.Tensor, tasks: ElimTasks, order=None):
    """The task list run one task after another with the plain pieces:
    :func:`lu_tile_plain` for an LU (consecutive LU tasks, which never
    depend on each other, as one batch: the same elementwise arithmetic)
    and :func:`tile_mm_plain` for a product task. ``order`` — the task ids
    in the order to run them (any topological order of the dependencies
    gives the same bits); ticket order by default. Returns what
    ``eliminate`` returns."""
    linv, uinv, piv = _outputs(store, tasks)
    steps = _plain_steps(tasks, store.device)
    pending = []

    def factor():  # the pending LU tasks
        ids, slots, pidx = (torch.as_tensor(x, device=store.device)
                            for x in zip(*pending))
        li = torch.empty((len(pending),) + tuple(linv.shape[1:]),
                         dtype=store.dtype, device=store.device)
        ui = torch.empty_like(li)
        piv[pidx] = lu_tile_plain(store, ids.int(), linv=li, uinv=ui)
        linv[slots] = li
        uinv[slots] = ui
        pending.clear()

    for t in range(tasks.n_tasks) if order is None else order:
        kind, *rest = steps[t]
        if kind == LU:
            pending.append(rest)
            continue
        if pending:
            factor()
        g = rest[0]
        if kind == ROWS:
            tile_mm_plain(store, store, uinv, g, side="row", subtract=False)
        elif kind == COLS:
            tile_mm_plain(store, linv, store, g, side="col", subtract=False)
        else:
            tile_mm_plain(store, store, store, g, side="row", subtract=True)
    if pending:
        factor()
    return _result(store, tasks, linv, uinv, piv)


_CAPACITY = {}  # (dtype, device, cs) -> resident blocks


def elim_fused(store: torch.Tensor, tasks: ElimTasks, *,
               grid: Optional[int] = None,
               clocks: Optional[torch.Tensor] = None):
    """The blocked LU of the merged store ``(n_tiles, cs, cs)`` in place,
    in one launch of ``elim_fused`` (``csrc/elim_fused.cu``); returns
    ``(store, min_piv, linv, uinv)`` as ``eliminate`` does.

    The blocks take the tasks by ticket and wait on ready flags kept in
    ``tasks.state``, one set per stream; the last block to leave resets
    the counters and advances the generation the flags are read against,
    so the launch needs nothing from the host per call and may be
    captured in a CUDA graph (warm up on the capture stream first, so the
    flags' zeroing stays out of the graph). ``grid`` — blocks of the
    launch (default: as many as the card holds at once); any number from
    1 up gives the same bits. ``clocks`` — an int64 ``(n_tickets, 6)``
    tensor the diagnostic build (``-DELIM_FUSED_CLOCKS``) fills. A CPU
    tensor runs :func:`elim_fused_plain`.
    """
    if device_kind(store) == "cpu":
        return elim_fused_plain(store, tasks)
    cs = tasks.cs
    require(store.dtype in KERNEL_DTYPES, f"unsupported dtype {store.dtype}")
    require(store.shape == (tasks.n_tiles, cs, cs) and store.is_contiguous(),
            f"store must be a contiguous ({tasks.n_tiles}, {cs}, {cs}) "
            f"bank, got {tuple(store.shape)}")
    L = lib()
    require(cs <= L.max_chunk,
            f"the CUDA elim_fused kernel takes cs <= {L.max_chunk}, got {cs}")
    name = f"elim_fused_{KERNEL_DTYPES[store.dtype]}"
    if grid is None:
        key = (store.dtype, store.device, cs)
        if key not in _CAPACITY:
            cap = getattr(L, f"{name}_capacity")(cs)
            if cap < 0:
                check(-cap, name)
            _CAPACITY[key] = cap
        grid = _CAPACITY[key]
    grid = max(1, min(int(grid), tasks.n_tickets))
    linv, uinv, piv = _outputs(store, tasks)
    s = stream(store)
    state = tasks.state(store.device, s)
    i = tasks.on(store.device)
    rc = getattr(L, name)(
        store.data_ptr(), linv.data_ptr(), uinv.data_ptr(), piv.data_ptr(),
        i["task"].data_ptr(), i["tick0"].data_ptr(),
        i["ticket_task"].data_ptr(), i["dep_ptr"].data_ptr(),
        i["dep"].data_ptr(), i["ent_a"].data_ptr(), i["ent_b"].data_ptr(),
        state.data_ptr(), None if clocks is None else clocks.data_ptr(),
        tasks.n_tickets, cs, grid, s)
    check(rc, name)
    elim_fused.LAUNCHES += 1
    return _result(store, tasks, linv, uinv, piv)


elim_fused.LAUNCHES = 0
