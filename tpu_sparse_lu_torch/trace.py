"""Host spans of the solver's phases, and the hand-written launches made in
each.

``span(name)`` times a phase on the host clock and adds one call and its
seconds to a per-thread registry, whether or not anything records. Each
thread keeps two: one for the calls made while ``torch.profiler`` records,
one for the rest, so the profiler's cost can be read apart from the
phases it measures. While a profiler records, the span also opens a user
range of the same name, the one ``torch.profiler.record_function`` opens,
so the phase sits in the profiler's trace (as a ``user_annotation`` event)
on the clock of the kernels it launches, and each idle gap of the device
can be put down to what the host was doing. Without a profiler no range is
opened.

Launches: each wrapper of a hand-written kernel (``ops/*.py``) calls
``ops/_launch.check`` once after its launch, which adds one to its
thread's count of launches. A span counts the launches made on its thread
between its start and its end, nested spans' included, so a set-up span
counts its whole subtree, as it does its seconds. A launch made under no
open span counts under the name ``lu.unspanned`` (no calls, no seconds),
so a gap in the spans shows. Only the port's own kernels are counted:
PyTorch's operations (casts, fills, copies) and library calls (cuSPARSE in
a float64 residual) are not: the counts are of hand-written launches.

Names are ``lu.<layer>.<phase>``:

* a solve: ``lu.ldiv.rhs`` (checks, the right-hand side to a contiguous
  panel; once a call of ``ldiv`` and of a ``make_f64_ldiv`` solve),
  ``lu.ldiv.launch`` (one direct solve on the tiles: checks, buffers, the
  kernel launch; at ``tri_mode`` ``"trsm"`` and ``"inv_refine"``, the
  level-step solve, each perm and each off-diagonal wave a call, with each
  level's diagonal step between them a call of ``lu.ldiv.diag``) or,
  where ``ldiv`` runs the chain solve, ``lu.ldiv.chain`` (the same for the
  chain kernel), ``lu.ldiv.residual``
  (a refinement sweep's residual, and its update, each a call),
  ``lu.ldiv.cast`` (in ``make_f64_ldiv``, a direct solve's right-hand
  side to float32, and its answer to float64, each a call);
* the refactor-solve step: ``lu.step.inputs`` (once a step),
  ``lu.refactor.assemble``, ``lu.refactor.eliminate``,
  ``lu.refactor.extract`` (the solve banks' tiles and the pivot growth),
  ``lu.refactor.banks`` (the banks and the row scaling handed to the
  solve), then the solve's spans;
* construction, once each: ``lu.setup.order``, ``lu.setup.factorize``,
  ``lu.setup.plan``, ``lu.setup.device`` (every re-pack),
  ``lu.setup.refactor_plan``, ``lu.setup.kernels`` (the first load of the
  kernel library) and, inside it when the library is compiled,
  ``lu.setup.kernel_build``.

The spans of a solve or a step follow one another and do not nest; the
set-up spans may nest, and each is counted whole. To see where a window of
host time goes without a profiler: :func:`reset`, run the window, read
:func:`totals` (calls and seconds over both registries) or
:func:`phases` (one registry, with launches).
"""

from __future__ import annotations

import threading
from time import perf_counter_ns

import torch.autograd
import torch.autograd.profiler as _profiler

__all__ = ["span", "totals", "phases", "reset", "UNSPANNED"]

UNSPANNED = "lu.unspanned"

# one state a thread, so that a span adds to it without a lock; the lock
# guards the list of them
_lock = threading.Lock()
_threads: list = []
_local = threading.local()
# the user range of ``record_function`` without its Python wrapper, which
# costs the host several times as much a span and leaves a gap of
# microseconds between two spans written one after another
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit


class _Thread:
    """A thread's registries, ``{name: [calls, nanoseconds, launches]}``
    for the calls made without a profiler (``plain``) and under one
    (``profiled``); its launches so far and its open spans."""

    __slots__ = ("plain", "profiled", "launches", "depth")

    def __init__(self):
        self.plain: dict = {}
        self.profiled: dict = {}
        self.launches = 0
        self.depth = 0


def _thread_state() -> _Thread:
    st = _Thread()
    with _lock:
        _threads.append(st)
    _local.state = st
    return st


class span:
    """``with span(name): ...`` — one call of ``name``, its host time and
    the launches made inside it into the registry of its side (profiled or
    not); a user range while a profiler records."""

    __slots__ = ("name", "_t0", "_range", "_st", "_n0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        try:
            st = _local.state
        except AttributeError:
            st = _thread_state()
        self._st = st
        self._n0 = st.launches
        st.depth += 1
        # the range opens first and closes last, so that spans written one
        # after another leave no gap between them in the profiler's trace
        self._range = (_range_enter(self.name)
                       if _profiler._is_profiler_enabled else None)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = perf_counter_ns() - self._t0
        st = self._st
        st.depth -= 1
        rng = self._range
        reg = st.plain if rng is None else st.profiled
        entry = reg.get(self.name)
        if entry is None:
            reg[self.name] = [1, dt, st.launches - self._n0]
        else:
            entry[0] += 1
            entry[1] += dt
            entry[2] += st.launches - self._n0
        if rng is not None:
            _range_exit(rng)


def _unspanned(st: _Thread) -> None:
    """Count a launch made under no open span of ``st``'s thread."""
    reg = st.profiled if _profiler._is_profiler_enabled else st.plain
    entry = reg.get(UNSPANNED)
    if entry is None:
        reg[UNSPANNED] = [0, 0, 1]
    else:
        entry[2] += 1


def _sum(side: str) -> dict:
    with _lock:
        regs = [getattr(st, side) for st in _threads]
    out: dict = {}
    for reg in regs:
        for name, (calls, ns, n) in list(reg.items()):
            c, t, k = out.get(name, (0, 0, 0))
            out[name] = (c + calls, t + ns, k + n)
    return out


def phases(profiled: bool) -> dict:
    """``{name: (calls, seconds, launches)}`` of one side: the calls made
    while a profiler recorded (``profiled``) or the others, over all
    threads, since the start of the process or the last :func:`reset`.
    ``lu.unspanned`` holds the launches made under no span (0 calls, 0
    seconds)."""
    return {k: (c, ns * 1e-9, n)
            for k, (c, ns, n) in _sum("profiled" if profiled
                                      else "plain").items()}


def totals() -> dict:
    """``{name: (calls, seconds)}``: every span's calls and host seconds,
    profiled or not, over all threads, since the start of the process or
    the last :func:`reset`."""
    out: dict = {}
    for side in ("plain", "profiled"):
        for name, (calls, ns, _) in _sum(side).items():
            if calls:
                c, t = out.get(name, (0, 0))
                out[name] = (c + calls, t + ns)
    return {k: (c, ns * 1e-9) for k, (c, ns) in out.items()}


def reset() -> None:
    """Empty both registries of every thread."""
    with _lock:
        for st in _threads:
            st.plain.clear()
            st.profiled.clear()
