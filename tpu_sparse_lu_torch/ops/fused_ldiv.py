"""The ldiv kernels and their host schedule: counterpart of
``tpu_sparse_lu/ops/pallas_ldiv.py``.

The TPU kernel runs the whole ``ldiv`` (perm-in → L levels → U levels →
perm-out) as one serial op stream ``X[dst] = X[src] @ tileᵀ + acc·X[dst]``
because one TensorCore executes it. On the H100 ``ldiv`` is one launch of
:func:`fused_ldiv` (``csrc/ldiv_fused.cu``): the host turns the waves of
both factors into one task list (:func:`build_ldiv_schedule`, once per
plan), and the blocks of the launch take its tasks by ticket, each
waiting on the ready flags of the tasks it depends on, so levels overlap
where the data allows and every tile loads before its task's wait.
:func:`fused_ldiv_bf16` is the same launch on bfloat16 tiles.

The wave kernels below (``csrc/ldiv.cu``) serve ``lsolve``/``rsolve``; a
task of the one-launch solve computes exactly what their blocks compute,
so the one launch and the 32-launch route (``perm_gather``, the waves,
``perm_gather``) give the same bits:

* :func:`perm_gather` — ``y[i] = scale[s]·v[s]`` with ``s = idx[i]`` (0 where
  ``s < 0``): perm-in with the row scaling ``Rs`` folded in, and perm-out;
* :func:`wave_apply` — one wave of one level: for every destination block
  ``x[dst] = acc·x[dst] + Σ tile·x[src]``. Each level of a factor is two
  waves, the diagonal wave (``acc=0``, ``src == dst``, tile = ``Dinv_k``)
  and the off-diagonal wave (``acc=1``, tiles stored negated) — the wave
  boundaries ``_tri_ops`` emits on the TPU, without its padding;
* :func:`wave_apply_bf16` — the same wave with a bfloat16 tile bank and a
  float32 carrier (``SolverConfig.stream_dtype="bfloat16"``): each tile
  widens to float32 as it is read, as the TPU kernel widens its bf16 L/U
  stream, and the arithmetic stays float32.

Each wrapper runs its kernel on a CUDA tensor and the plain PyTorch version
beside it (``*_plain``) on a CPU tensor, and raises on anything else. The
plain versions are the reference the kernels are held against. Each
wrapper's ``LAUNCHES`` counts its kernel's launches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..symbolic import TriPlan
from ._launch import KERNEL_DTYPES as _KERNEL_DTYPES
from ._launch import check as _check
from ._launch import device_kind as _device_kind
from ._launch import lib as _lib
from ._launch import require as _require
from ._launch import stream as _stream
from ._tasks import hazard_deps

__all__ = [
    "LdivSchedule",
    "Wave",
    "build_ldiv_schedule",
    "build_waves",
    "fused_ldiv",
    "fused_ldiv_bf16",
    "fused_ldiv_plain",
    "make_wave",
    "perm_gather",
    "perm_gather_plain",
    "wave_apply",
    "wave_apply_bf16",
    "wave_apply_plain",
]

@dataclasses.dataclass
class Wave:
    """One wave of a level, grouped by destination block (CSR).

    Destination ``dst[d]`` receives the entries ``ptr[d]:ptr[d+1]``, each a
    tile of the factor's tile bank (``ent_tile``) applied to the carrier
    block ``ent_src``; ``ent_row`` is each entry's ``d``. All int32.
    ``blocks``/``tiles`` (set here) are the carrier blocks and bank tiles
    the wave needs, so a launch can check its operands without reading
    the device; ``dst_long`` is ``dst`` as an int64 index.
    """

    dst: torch.Tensor
    ptr: torch.Tensor
    ent_tile: torch.Tensor
    ent_src: torch.Tensor
    ent_row: torch.Tensor
    accumulate: bool

    def __post_init__(self):
        # checked once here rather than on every launch
        idx = (self.dst, self.ptr, self.ent_tile, self.ent_src, self.ent_row)
        for t in idx:
            _require(t.dtype == torch.int32 and t.dim() == 1
                     and t.is_contiguous() and t.device == self.dst.device,
                     "wave index arrays must be contiguous int32 vectors "
                     "on one device")
        _require(self.ptr.shape[0] == self.dst.shape[0] + 1
                 and self.ent_src.shape == self.ent_tile.shape
                 == self.ent_row.shape, "inconsistent wave shapes")
        ptr = self.ptr.cpu()
        n_ent = self.ent_tile.shape[0]
        _require(int(ptr[0]) == 0 and int(ptr[-1]) == n_ent
                 and bool((ptr[1:] >= ptr[:-1]).all()),
                 "wave ptr must run from 0 to the entry count")
        blocks = torch.cat([self.dst, self.ent_src]).cpu()
        tiles = self.ent_tile.cpu()
        _require(bool((blocks >= 0).all()) and bool((tiles >= 0).all()),
                 "negative block or tile index in a wave")
        self.blocks = int(blocks.max()) + 1 if blocks.numel() else 0
        self.tiles = int(tiles.max()) + 1 if n_ent else 0
        # ``dst`` as an index: the level's chunks where the wave is a
        # diagonal one, which the trsm / inv_refine steps gather
        self.dst_long = self.dst.long()


def make_wave(dst, groups, accumulate: bool, device) -> Wave:
    """A :class:`Wave` from destination blocks ``dst`` and, per
    destination, its list of ``(tile, src)`` entries."""
    ptr = np.zeros(len(dst) + 1, dtype=np.int32)
    ptr[1:] = np.cumsum([len(g) for g in groups])
    ent = [e for g in groups for e in g]
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32),
                                     device=device)
    return Wave(
        dst=as_t(dst), ptr=as_t(ptr),
        ent_tile=as_t([t for t, _ in ent]),
        ent_src=as_t([s for _, s in ent]),
        ent_row=as_t(np.repeat(np.arange(len(dst)), np.diff(ptr))),
        accumulate=accumulate,
    )


def _level_waves(plan: TriPlan):
    """The waves of one factor as host lists ``(dst, groups, accumulate)``
    (see :func:`build_waves`)."""
    K = plan.K
    waves = []
    for l in range(plan.num_levels):
        chunks = plan.level_chunks[l, : int(plan.level_chunk_counts[l])]
        chunks = [int(k) for k in chunks]
        waves.append((chunks, [[(k, k)] for k in chunks], False))
        tiles = plan.level_tiles[l, : int(plan.level_tile_counts[l])]
        if tiles.size == 0:
            continue
        by_dst = {}
        for t in sorted(tiles.tolist()):
            by_dst.setdefault(int(plan.tile_brow[t]), []).append(
                (K + 1 + t, int(plan.tile_bcol[t]))
            )
        dst = sorted(by_dst)
        waves.append((dst, [by_dst[d] for d in dst], True))
    return waves


def build_waves(plan: TriPlan, device) -> List[Wave]:
    """The dependency waves of one factor's level schedule.

    Tile ids index the factor's bank ``[Dinv_0..Dinv_K, Off_0..Off_T]``:
    chunk ``k``'s inverse is ``k``, off-diagonal tile ``t`` is ``K+1+t``.
    Only the real ``level_chunk_counts``/``level_tile_counts`` entries are
    read; the padding slots of the level arrays are never touched.
    """
    return [make_wave(dst, groups, acc, device)
            for dst, groups, acc in _level_waves(plan)]


# ---------------------------------------------------------------------------
# perm_gather
# ---------------------------------------------------------------------------


def perm_gather_plain(v: torch.Tensor, idx: torch.Tensor,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y[i] = scale[idx[i]] * v[idx[i]]``; rows whose index lies outside
    ``[0, Nv)`` are 0."""
    outside = (idx < 0) | (idx >= v.shape[0])
    src = idx.long().masked_fill(outside, 0)
    y = v[src]
    if scale is not None:
        y = y * scale[src, None]
    return y.masked_fill_(outside[:, None], 0)


def perm_gather(v: torch.Tensor, idx: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row gather with an optional per-source-row scale.

    ``v`` (Nv, R) float32/float64; ``idx`` (Ny,) int32, rows whose index
    lies outside ``[0, Nv)`` (-1 by convention) come out 0; ``scale``
    (Nv,) of ``v``'s dtype or ``None``. Returns a new (Ny, R) tensor.
    """
    tensors = (v, idx) if scale is None else (v, idx, scale)
    if _device_kind(*tensors) == "cpu":
        return perm_gather_plain(v, idx, scale)
    _require(v.dtype in _KERNEL_DTYPES, f"unsupported dtype {v.dtype}")
    _require(v.dim() == 2 and v.is_contiguous(), "v must be contiguous (Nv, R)")
    _require(idx.dtype == torch.int32 and idx.dim() == 1
             and idx.is_contiguous(), "idx must be contiguous int32 (Ny,)")
    if scale is not None:
        _require(scale.dtype == v.dtype and scale.shape == (v.shape[0],)
                 and scale.is_contiguous(), "scale must be contiguous (Nv,)")
    n_out, R = idx.shape[0], v.shape[1]
    y = torch.empty((n_out, R), dtype=v.dtype, device=v.device)
    fn = getattr(_lib(), f"ldiv_perm_gather_{_KERNEL_DTYPES[v.dtype]}")
    rc = fn(y.data_ptr(), v.data_ptr(), idx.data_ptr(),
            None if scale is None else scale.data_ptr(), v.shape[0], n_out,
            R, _stream(v))
    _check(rc, "perm_gather")
    perm_gather.LAUNCHES += 1
    return y


perm_gather.LAUNCHES = 0


# ---------------------------------------------------------------------------
# wave_apply
# ---------------------------------------------------------------------------


def wave_apply_plain(x: torch.Tensor, tiles_t: torch.Tensor,
                     wave: Wave) -> torch.Tensor:
    """``x[dst] = acc·x[dst] + Σ tile·x[src]`` with a batched matmul and
    ``index_add_``; ``tiles_t`` holds the tiles transposed, of ``x``'s
    dtype or bfloat16 (the tiles a wave reads widen exactly to ``x``'s
    dtype: the plain version of both :func:`wave_apply` and
    :func:`wave_apply_bf16`)."""
    contrib = torch.bmm(tiles_t[wave.ent_tile].to(x.dtype).transpose(1, 2),
                        x[wave.ent_src])
    if wave.accumulate:
        out = x[wave.dst]
    else:
        out = torch.zeros((wave.dst.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
    out.index_add_(0, wave.ent_row, contrib)
    x[wave.dst] = out
    return x


def _check_wave(x: torch.Tensor, tiles_t: torch.Tensor, wave: Wave) -> None:
    """The operand checks of a wave launch on a CUDA tensor."""
    _require(x.dim() == 3 and x.is_contiguous(),
             "x must be a contiguous (blocks, cs, R) carrier")
    cs = x.shape[1]
    _require(tiles_t.dim() == 3 and tiles_t.shape[1:] == (cs, cs)
             and tiles_t.is_contiguous(),
             "tiles_t must be contiguous (n_tiles, cs, cs)")
    _require(cs <= _lib().max_chunk, f"the CUDA ldiv kernel takes "
             f"chunk_size <= {_lib().max_chunk}, got {cs}")


def _launch_wave(name: str, x: torch.Tensor, tiles_t: torch.Tensor,
                 wave: Wave) -> None:
    fn = getattr(_lib(), name)
    rc = fn(x.data_ptr(), tiles_t.data_ptr(), wave.dst.data_ptr(),
            wave.ptr.data_ptr(), wave.ent_tile.data_ptr(),
            wave.ent_src.data_ptr(), wave.dst.shape[0], x.shape[1],
            x.shape[2], int(wave.accumulate), _stream(x))
    _check(rc, name)


def wave_apply(x: torch.Tensor, tiles_t: torch.Tensor,
               wave: Wave) -> torch.Tensor:
    """Apply one wave to the carrier ``x`` (blocks, cs, R) in place.

    ``tiles_t`` (n_tiles, cs, cs) is the factor's tile bank, each tile
    transposed, of ``x``'s dtype. Returns ``x``.
    """
    _require(wave.blocks <= x.shape[0] and wave.tiles <= tiles_t.shape[0],
             "wave indexes past the carrier or the tile bank")
    _require(tiles_t.dtype == x.dtype, f"tiles of {tiles_t.dtype} for a "
             f"{x.dtype} carrier (bfloat16 tiles: wave_apply_bf16)")
    if _device_kind(x, tiles_t, wave.dst) == "cpu":
        return wave_apply_plain(x, tiles_t, wave)
    _require(x.dtype in _KERNEL_DTYPES, f"unsupported dtype {x.dtype}")
    _check_wave(x, tiles_t, wave)
    _launch_wave(f"ldiv_wave_apply_{_KERNEL_DTYPES[x.dtype]}", x, tiles_t,
                 wave)
    wave_apply.LAUNCHES += 1
    return x


wave_apply.LAUNCHES = 0


def wave_apply_bf16(x: torch.Tensor, tiles_t: torch.Tensor,
                    wave: Wave) -> torch.Tensor:
    """:func:`wave_apply` with a bfloat16 tile bank and a float32 carrier
    ``x``, in place; returns ``x``."""
    _require(wave.blocks <= x.shape[0] and wave.tiles <= tiles_t.shape[0],
             "wave indexes past the carrier or the tile bank")
    _require(tiles_t.dtype == torch.bfloat16 and x.dtype == torch.float32,
             f"wave_apply_bf16 takes bfloat16 tiles and a float32 carrier, "
             f"got {tiles_t.dtype}/{x.dtype}")
    if _device_kind(x, tiles_t, wave.dst) == "cpu":
        return wave_apply_plain(x, tiles_t, wave)
    _check_wave(x, tiles_t, wave)
    _launch_wave("ldiv_wave_apply_bf16", x, tiles_t, wave)
    wave_apply_bf16.LAUNCHES += 1
    return x


wave_apply_bf16.LAUNCHES = 0


# ---------------------------------------------------------------------------
# the whole ldiv in one launch: task list, plain executor, fused_ldiv
# ---------------------------------------------------------------------------

# kinds and flags of a task (LdivSchedule.task[:, 0]); csrc/ldiv_fused.cu
# reads the same bits
PERM_IN, WAVE, PERM_OUT = 0, 1, 2
KIND_MASK = 3
BANK_U = 4
ACCUMULATE = 8


def _device(device) -> torch.device:
    """``device`` with its index: ``cuda`` means the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def strip_width(R: int) -> int:
    """Columns of R one ticket covers: as wide as R up to 16, as
    ``launch_wave`` picks them (``csrc/ldiv.cu``)."""
    return 1 if R == 1 else (4 if R <= 4 else 16)


@dataclasses.dataclass
class LdivSchedule:
    """The whole ``ldiv`` as one list of tasks in ticket order, with the
    tasks each one waits for: the host side of :func:`fused_ldiv`.

    Tasks, in order: ``K+1`` perm-in tasks (carrier block ``k`` of
    ``x = Rs ⊙ b[pidx]``), one task per destination block of every wave of
    the L factor then of the U factor, in wave order, and one perm-out
    task per block of ``cs`` rows of ``y = x[qidx]``. ``task[t]`` is
    ``(flags, dst, e0, e1)``: the kind and bits of the ``*`` constants
    above, the block written, and the task's entries ``e0:e1`` of
    ``ent_tile``/``ent_src`` (a tile of the task's factor bank applied to
    a carrier block), in the wave's CSR order. ``dep[dep_ptr[t]:
    dep_ptr[t+1]]`` are the earlier tasks ``t`` waits for: every
    read-after-write, write-after-write and write-after-read conflict on a
    carrier block. Each task runs once per strip of
    :func:`strip_width` columns, and a strip waits only for the same strip
    of its dependencies: ticket ``t * strips + strip``.

    Host arrays are NumPy int32; :meth:`on` gives them on a device.
    :meth:`state` holds the kernel's counters and ready flags, one set per
    stream (see :func:`fused_ldiv`).
    """

    n: int  # rows of b and y
    cs: int
    K: int  # carrier blocks: K + 1
    task: np.ndarray  # (n_tasks, 4)
    dep_ptr: np.ndarray  # (n_tasks + 1,)
    dep: np.ndarray
    ent_tile: np.ndarray
    ent_src: np.ndarray
    pidx: np.ndarray  # ((K + 1) * cs,) row of b of each carrier row, -1: 0
    qidx: np.ndarray  # (n,) carrier row of each row of y
    device: torch.device

    def __post_init__(self):
        self.device = _device(self.device)
        self._on = {}
        self._state = {}
        # the tiles each bank must hold; the entries lie in task order
        upper = np.repeat((self.task[:, 0] & BANK_U) != 0,
                          self.task[:, 3] - self.task[:, 2])
        self.l_tiles, self.u_tiles = (
            int(t.max()) + 1 if t.size else 0
            for t in (self.ent_tile[~upper], self.ent_tile[upper]))
        self.on(self.device)

    @property
    def n_tasks(self) -> int:
        return self.task.shape[0]

    def on(self, device) -> dict:
        """The index arrays as int32 tensors on ``device`` (kept)."""
        dev = _device(device)
        if dev not in self._on:
            self._on[dev] = {
                k: torch.as_tensor(np.ascontiguousarray(getattr(self, k)),
                                   device=dev)
                for k in ("task", "dep_ptr", "dep", "ent_tile", "ent_src",
                          "pidx", "qidx")}
        return self._on[dev]

    def state(self, n_tickets: int, device, stream: int = 0) -> torch.Tensor:
        """The kernel's int32 words for ``n_tickets`` tickets on the raw
        CUDA stream ``stream``, made once and then left to the kernel:
        ticket counter, exit counter, generation (starts at 1), then one
        ready flag per ticket (start at 0, so a fresh state never reads as
        done). Launches on one stream run one after another, so each
        stream's words serve one launch at a time."""
        key = (n_tickets, _device(device), stream)
        if key not in self._state:
            s = torch.zeros(3 + n_tickets, dtype=torch.int32, device=device)
            s[2] = 1
            self._state[key] = s
        return self._state[key]


def build_ldiv_schedule(lplan: TriPlan, uplan: TriPlan, pidx, qidx, n: int,
                        cs: int, device) -> LdivSchedule:
    """The task list of one solve (:class:`LdivSchedule`) from the two
    factors' level plans and the perm-in/perm-out row maps: ``pidx``
    ((K+1)·cs,), the row of ``b`` each carrier row takes (-1: 0), and
    ``qidx`` (n,), the carrier row of each row of ``y``."""
    K = lplan.K
    _require(uplan.K == K and lplan.cs == uplan.cs == cs,
             "L and U plans of different chunkings")
    pidx = np.asarray(pidx, dtype=np.int32)
    qidx = np.asarray(qidx, dtype=np.int32)
    _require(pidx.shape == ((K + 1) * cs,) and qidx.shape == (n,),
             f"pidx {pidx.shape} / qidx {qidx.shape} for K={K}, cs={cs}, "
             f"n={n}")
    _require(bool((qidx >= 0).all() and (qidx < (K + 1) * cs).all()),
             "qidx outside the carrier")
    task, ent, access = [], [], []
    for k in range(K + 1):
        task.append((PERM_IN, k, 0, 0))
        access.append(((), (k,)))
    for bank, plan in ((0, lplan), (BANK_U, uplan)):
        for dst, groups, acc in _level_waves(plan):
            for d, g in zip(dst, groups):
                e0 = len(ent)
                ent.extend(g)
                task.append((WAVE | bank | (ACCUMULATE if acc else 0), d,
                             e0, len(ent)))
                access.append(([s for _, s in g] + ([d] if acc else []),
                               (d,)))
    for m in range(-(-n // cs)):
        task.append((PERM_OUT, m, 0, 0))
        rows = qidx[m * cs:(m + 1) * cs]
        access.append((np.unique(rows // cs).tolist(), ()))
    deps = hazard_deps(access, K + 1)
    for t, d in enumerate(deps):
        # the ticket order is the wave order: every dependency comes first
        assert all(x < t for x in d), (t, d)
    ent = np.asarray(ent, dtype=np.int32).reshape(-1, 2)
    return LdivSchedule(
        n=n, cs=cs, K=K, task=np.asarray(task, dtype=np.int32),
        dep_ptr=np.concatenate([[0], np.cumsum([len(d) for d in deps])])
        .astype(np.int32),
        dep=np.asarray([x for d in deps for x in d], dtype=np.int32),
        ent_tile=np.ascontiguousarray(ent[:, 0]),
        ent_src=np.ascontiguousarray(ent[:, 1]),
        pidx=pidx, qidx=qidx, device=device)


def _plain_steps(sched: LdivSchedule, dev) -> list:
    """Per task, what :func:`fused_ldiv_plain` needs on ``dev``, made once:
    kind, flags, destination block, and as long tensors its rows (perm
    tasks) or its entries' tiles and sources (wave tasks)."""
    idx = sched.on(dev)
    if "steps" not in idx:
        cs, n_x = sched.cs, (sched.K + 1) * sched.cs
        steps = []
        for flags, d, e0, e1 in sched.task.tolist():
            kind = flags & KIND_MASK
            if kind == WAVE:
                steps.append((kind, flags, d, idx["ent_tile"][e0:e1].long(),
                              idx["ent_src"][e0:e1].long()))
            else:
                hi = min((d + 1) * cs, n_x if kind == PERM_IN else sched.n)
                steps.append((kind, flags, d,
                              torch.arange(d * cs, hi, device=dev)))
        idx["steps"] = steps
    return idx["steps"]


def fused_ldiv_plain(b: torch.Tensor, sched: LdivSchedule,
                     lbank: torch.Tensor, ubank: torch.Tensor,
                     rs: torch.Tensor, order=None) -> torch.Tensor:
    """The task list of ``sched`` run one task after another with the
    plain pieces: :func:`perm_gather_plain` for a perm task (consecutive
    perm tasks of one kind as one gather, which is the same elementwise
    arithmetic), and for a wave task the per-destination ``bmm`` of
    :func:`wave_apply_plain`, its products added to the old block (or to
    0) in entry order, as ``index_add_`` adds them. ``order`` — the task ids
    in the order to run them (any topological order of the dependencies
    gives the same bits); ticket order by default."""
    R, cs = b.shape[1], sched.cs
    dev = b.device
    x = torch.empty((sched.K + 1, cs, R), dtype=b.dtype, device=dev)
    y = torch.empty((sched.n, R), dtype=b.dtype, device=dev)
    idx, steps = sched.on(dev), _plain_steps(sched, dev)
    xf = x.view(-1, R)
    rows, rows_kind = [], None

    def gather():  # the pending perm tasks, mutually independent
        r = rows[0] if len(rows) == 1 else torch.cat(rows)
        if rows_kind == PERM_IN:
            xf[r] = perm_gather_plain(b, idx["pidx"][r], rs)
        else:
            y[r] = perm_gather_plain(xf, idx["qidx"][r])
        rows.clear()

    for t in range(sched.n_tasks) if order is None else order:
        kind, flags, d, *ent = steps[t]
        if rows and kind != rows_kind:
            gather()
        if kind != WAVE:
            rows.append(ent[0])
            rows_kind = kind
            continue
        tiles, src = ent
        bank = ubank if flags & BANK_U else lbank
        contrib = torch.bmm(bank[tiles].to(b.dtype).transpose(1, 2), x[src])
        xd = x[d]
        if not flags & ACCUMULATE:
            xd.zero_()
        for c in contrib:
            xd.add_(c)
    if rows:
        gather()
    return y


_CAPACITY = {}  # (kernel, device, cs, strip width) -> resident blocks


def _launch_fused(name: str, b: torch.Tensor, sched: LdivSchedule,
                  lbank: torch.Tensor, ubank: torch.Tensor, rs: torch.Tensor,
                  grid: Optional[int]) -> torch.Tensor:
    n, R = b.shape
    cs = sched.cs
    _require(b.dim() == 2 and b.is_contiguous() and n == sched.n,
             f"b must be contiguous ({sched.n}, R), got {tuple(b.shape)}")
    _require(rs.shape == (n,) and rs.dtype == b.dtype and rs.is_contiguous(),
             "rs must be contiguous (n,) of b's dtype")
    for bank, need in ((lbank, sched.l_tiles), (ubank, sched.u_tiles)):
        _require(bank.dim() == 3 and bank.shape[1:] == (cs, cs)
                 and bank.is_contiguous() and bank.shape[0] >= need,
                 f"a tile bank must be contiguous (>= {need}, {cs}, {cs}), "
                 f"got {tuple(bank.shape)}")
    _require(cs <= _lib().max_chunk, f"the CUDA ldiv kernel takes "
             f"chunk_size <= {_lib().max_chunk}, got {cs}")
    rb = strip_width(R)
    n_tickets = sched.n_tasks * -(-R // rb)
    if grid is None:
        key = (name, b.device, cs, rb)
        if key not in _CAPACITY:
            cap = getattr(_lib(), f"{name}_capacity")(cs, R)
            if cap < 0:
                _check(-cap, name)
            _CAPACITY[key] = cap
        grid = _CAPACITY[key]
    grid = max(1, min(int(grid), n_tickets))
    stream = _stream(b)
    state = sched.state(n_tickets, b.device, stream)
    x = torch.empty((sched.K + 1, cs, R), dtype=b.dtype, device=b.device)
    y = torch.empty((n, R), dtype=b.dtype, device=b.device)
    i = sched.on(b.device)
    rc = getattr(_lib(), name)(
        y.data_ptr(), x.data_ptr(), b.data_ptr(), rs.data_ptr(),
        lbank.data_ptr(), ubank.data_ptr(), i["task"].data_ptr(),
        i["dep_ptr"].data_ptr(), i["dep"].data_ptr(),
        i["ent_tile"].data_ptr(), i["ent_src"].data_ptr(),
        i["pidx"].data_ptr(), i["qidx"].data_ptr(), state.data_ptr(),
        sched.n_tasks, n, cs, R, grid, stream)
    _check(rc, name)
    return y


def fused_ldiv(b: torch.Tensor, sched: LdivSchedule, lbank: torch.Tensor,
               ubank: torch.Tensor, rs: torch.Tensor, *,
               grid: Optional[int] = None) -> torch.Tensor:
    """``y = ldiv`` of ``b`` (n, R) in one launch of ``ldiv_fused``
    (``csrc/ldiv_fused.cu``): perm-in with the row scaling ``rs`` (n,),
    the L and U waves on the factor banks ``lbank``/``ubank`` (transposed
    tiles of ``b``'s dtype, float32 or float64), perm-out. Returns a new
    (n, R) tensor.

    The blocks of the launch take the tasks of ``sched`` by ticket and
    wait on ready flags kept in ``sched.state``, one set per stream; the
    last block to leave resets the counters and advances the generation
    the flags are read against, so the launch needs nothing from the host
    per call and may be captured in a CUDA graph. Solves on different
    streams may run at once. A graph keeps the flags of the stream it was
    captured on, so one replay of it may run at a time (and a first solve
    on that stream inside the capture puts the flags' zeroing into every
    replay: warm up on the capture stream). ``grid`` — blocks of the
    launch (default: as many as the card holds at once); any number from
    1 up gives the same bits. A CPU tensor runs :func:`fused_ldiv_plain`.
    """
    if _device_kind(b, lbank, ubank, rs) == "cpu":
        return fused_ldiv_plain(b, sched, lbank, ubank, rs)
    _require(b.dtype in _KERNEL_DTYPES, f"unsupported dtype {b.dtype}")
    _require(lbank.dtype == ubank.dtype == b.dtype, f"banks of "
             f"{lbank.dtype}/{ubank.dtype} for {b.dtype} (bfloat16 banks: "
             f"fused_ldiv_bf16)")
    y = _launch_fused(f"ldiv_fused_{_KERNEL_DTYPES[b.dtype]}", b, sched,
                      lbank, ubank, rs, grid)
    fused_ldiv.LAUNCHES += 1
    return y


fused_ldiv.LAUNCHES = 0


def fused_ldiv_bf16(b: torch.Tensor, sched: LdivSchedule,
                    lbank: torch.Tensor, ubank: torch.Tensor,
                    rs: torch.Tensor, *,
                    grid: Optional[int] = None) -> torch.Tensor:
    """:func:`fused_ldiv` with bfloat16 banks and a float32 ``b``: each
    tile widens to float32 as it is read, as in
    :func:`wave_apply_bf16`."""
    _require(lbank.dtype == ubank.dtype == torch.bfloat16
             and b.dtype == torch.float32, f"fused_ldiv_bf16 takes bfloat16 "
             f"banks and float32 b, got {lbank.dtype}/{ubank.dtype}/"
             f"{b.dtype}")
    if _device_kind(b, lbank, ubank, rs) == "cpu":
        return fused_ldiv_plain(b, sched, lbank, ubank, rs)
    y = _launch_fused("ldiv_fused_bf16", b, sched, lbank, ubank, rs, grid)
    fused_ldiv_bf16.LAUNCHES += 1
    return y


fused_ldiv_bf16.LAUNCHES = 0
