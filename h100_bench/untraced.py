"""The program's registry of spans, read by side: the calls made while no
profiler recorded and those made under the traced window's profiler.

``tpu_sparse_lu_torch.trace.phases(profiled)`` gives ``{name: (calls,
seconds, launches)}`` of one side in this process, where ``launches``
counts the program's hand-written kernel launches made inside the span
(``lu.unspanned``: those made under no span). A run is one process, so
the unprofiled side is its set-up, its warm-up and its whole window; the
profiled side is the traced window with its warm-up.

A step is a call of the span the cell's entry opens exactly once a call:
``lu.ldiv.rhs`` for ``ldiv`` and a ``make_f64_ldiv`` solve,
``lu.step.inputs`` for the refactor-solve step. The step's phases are the
program's spans but the set-up spans (``lu.setup.*``); a set-up span that
opens inside a step (the kernel library's first load, in the first
warm-up step, with the ``nvcc`` build in a checkout's first run) counts
in the step span around it. Every reading is a mean over the side's
steps, not a median.

A program without the two sides, or a side without a step, has nothing to
read: each reader then returns None.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import numpy as np

from .spans import PREFIX

SOLVE_STEP = "lu.ldiv.rhs"
REFACTOR_STEP = "lu.step.inputs"
SETUP_PREFIX = "lu.setup."
UNSPANNED = "lu.unspanned"

Side = Dict[str, Tuple[int, float, int]]


def phases(profiled: bool) -> Optional[Side]:
    """One side of the program's registry, or None when the program keeps
    no sides."""
    try:
        trace = importlib.import_module("tpu_sparse_lu_torch.trace")
    except ImportError:
        return None
    read = getattr(trace, "phases", None)
    return None if read is None else read(profiled)


def _side(step: str, profiled: bool):
    """(steps, the step's phases) of one side, or None."""
    reg = phases(profiled)
    if not reg or step not in reg or not reg[step][0]:
        return None
    hot = {k: v for k, v in reg.items() if k.startswith(PREFIX)
           and not k.startswith(SETUP_PREFIX) and k != UNSPANNED}
    return reg[step][0], hot, reg


def host_ms(step: str, profiled: bool = False) -> Optional[float]:
    """Mean host ms a step in the step's phases, on one side."""
    got = _side(step, profiled)
    if got is None:
        return None
    steps, hot, _ = got
    return sum(s for _, s, _ in hot.values()) / steps * 1e3


def unspanned_host_ms(run, step: str) -> Optional[float]:
    """Mean ms of a window step's dispatch (``run.dispatch_s``: the call
    into the program to its return) less :func:`host_ms`: host time inside
    the entry that no span covers. Not clamped: the two means are over
    other steps (the window's; set-up's, warm-up's and the window's)."""
    h = host_ms(step)
    if h is None or not len(run.dispatch_s):
        return None
    return float(np.mean(run.dispatch_s)) * 1e3 - h


def tracing_cost_ms(step: str) -> Optional[float]:
    """What the profiler adds to a step's phases: profiled less unprofiled
    mean host ms a step."""
    traced, plain = host_ms(step, True), host_ms(step, False)
    if traced is None or plain is None:
        return None
    return traced - plain


def launch_host_us(step: str) -> Optional[float]:
    """Unprofiled host µs a launch: the seconds of the step's phases that
    launched at least once, over their launches."""
    got = _side(step, False)
    if got is None:
        return None
    _, hot, _ = got
    n = sum(k for _, _, k in hot.values())
    if not n:
        return None
    return sum(s for _, s, k in hot.values() if k) / n * 1e6


def launches(step: str) -> Optional[float]:
    """Unprofiled hand-written launches a step: the step's phases' and
    those made under no span."""
    got = _side(step, False)
    if got is None:
        return None
    steps, hot, reg = got
    n = sum(k for _, _, k in hot.values())
    return (n + reg.get(UNSPANNED, (0, 0.0, 0))[2]) / steps
