"""Host spans of the solver's phases.

``span(name)`` times a phase on the host clock and adds one call and its
seconds to a process-wide registry, whether or not anything records. While
``torch.profiler`` records, the span also opens a user range of the same
name, the one ``torch.profiler.record_function`` opens, so the phase sits
in the profiler's trace (as a ``user_annotation`` event) on the clock of
the kernels it launches, and each idle gap of the device can be put down
to what the host was doing. Without a profiler no range is opened.

Names are ``lu.<layer>.<phase>``:

* a solve: ``lu.ldiv.rhs`` (checks, the right-hand side to a contiguous
  panel), ``lu.ldiv.launch`` (one direct solve on the tiles: checks,
  buffers, the kernel launch; at ``tri_mode`` ``"trsm"`` and
  ``"inv_refine"``, the level-step solve, each perm and each off-diagonal
  wave a call, with each level's diagonal step between them a call of
  ``lu.ldiv.diag``, counted in ``solve.blocked_tri_solve.DIAG_STEPS``) or,
  where ``ldiv`` runs the chain solve, ``lu.ldiv.chain`` (the same for the
  chain kernel), ``lu.ldiv.residual``
  (a refinement sweep's residual, and its update, each a call),
  ``lu.ldiv.cast`` (in ``make_f64_ldiv``, a direct solve's right-hand
  side to float32, and its answer to float64, each a call);
* the refactor-solve step: ``lu.step.inputs``, ``lu.refactor.assemble``,
  ``lu.refactor.eliminate``, ``lu.refactor.extract`` (the solve banks'
  tiles and the pivot growth), ``lu.refactor.banks`` (the banks and the
  row scaling handed to the solve), then the solve's spans;
* construction, once each: ``lu.setup.order``, ``lu.setup.factorize``,
  ``lu.setup.plan``, ``lu.setup.device`` (every re-pack),
  ``lu.setup.refactor_plan``, ``lu.setup.kernels`` (the first load of the
  kernel library) and, inside it when the library is compiled,
  ``lu.setup.kernel_build``.

The spans of a solve or a step follow one another and do not nest; the
set-up spans may nest, and each is counted whole. To see where a window of
host time goes without a profiler: :func:`reset`, run the window, read
:func:`totals`.
"""

from __future__ import annotations

import threading
from time import perf_counter_ns

import torch.autograd
import torch.autograd.profiler as _profiler

__all__ = ["span", "totals", "reset"]

# one registry a thread, {name: [calls, nanoseconds]}, so that a span adds
# to it without a lock; the lock guards the list of them
_lock = threading.Lock()
_registries: list = []
_local = threading.local()
# the user range of ``record_function`` without its Python wrapper, which
# costs the host several times as much a span and leaves a gap of
# microseconds between two spans written one after another
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit


def _thread_registry() -> dict:
    reg: dict = {}
    with _lock:
        _registries.append(reg)
    _local.registry = reg
    return reg


class span:
    """``with span(name): ...`` — one call of ``name`` and its host time
    into the registry; a user range while a profiler records."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        # the range opens first and closes last, so that spans written one
        # after another leave no gap between them in the profiler's trace
        self._range = (_range_enter(self.name)
                       if _profiler._is_profiler_enabled else None)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = perf_counter_ns() - self._t0
        try:
            reg = _local.registry
        except AttributeError:
            reg = _thread_registry()
        entry = reg.get(self.name)
        if entry is None:
            reg[self.name] = [1, dt]
        else:
            entry[0] += 1
            entry[1] += dt
        if self._range is not None:
            _range_exit(self._range)


def totals() -> dict:
    """``{name: (calls, seconds)}``: every span's calls and host seconds,
    over all threads, since the start of the process or the last
    :func:`reset`."""
    with _lock:
        regs = list(_registries)
    out: dict = {}
    for reg in regs:
        for name, (calls, ns) in list(reg.items()):
            c, t = out.get(name, (0, 0))
            out[name] = (c + calls, t + ns)
    return {k: (c, ns * 1e-9) for k, (c, ns) in out.items()}


def reset() -> None:
    """Empty the registry."""
    with _lock:
        for reg in _registries:
            reg.clear()
