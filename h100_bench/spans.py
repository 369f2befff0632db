"""The program's own spans, for the per-layer metrics that read them.

``tpu_sparse_lu_torch`` names its spans ``lu.<layer>.<phase>``
(``tpu_sparse_lu_torch/trace.py``). While the profiler records they are
``user_annotation`` events of the traced window, in ``run.trace.spans``
beside the benchmark's own; a step is the benchmark's span of the entry
(``api.ldiv``, ``api.refactor_solve_step``), which holds the program's
spans of that step. Whether or not anything records, the program's
registry holds each span's calls and host seconds in the process: a run
is one process, so its set-up spans are the run's construction.

A program without spans has nothing to read: each reader then returns
None.
"""

from __future__ import annotations

import bisect
import importlib
from typing import List, Optional, Tuple

import numpy as np

PREFIX = "lu."
STEP_PREFIX = "api."

Interval = Tuple[float, float]


def program_spans(trace) -> List[Tuple[str, float, float]]:
    """The program's spans of the traced window, in order of start."""
    return sorted((sp for sp in trace.spans if sp[0].startswith(PREFIX)),
                  key=lambda sp: sp[1])


def step_spans(trace) -> List[Tuple[str, float, float]]:
    """The steps: the benchmark's spans of the entry, in order of start."""
    return sorted((sp for sp in trace.spans
                   if sp[0].startswith(STEP_PREFIX)), key=lambda sp: sp[1])


def per_step_s(trace, name: str) -> Optional[List[float]]:
    """Host seconds of the spans ``name`` inside each step (0 in a step
    without one), or None when the window has no such span."""
    if trace is None:
        return None
    mine = [sp for sp in program_spans(trace) if sp[0] == name]
    steps = step_spans(trace)
    if not mine or not steps:
        return None
    starts = [s for _, s, _ in steps]
    out = [0.0] * len(steps)
    for _, s, e in mine:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and e <= steps[j][2]:
            out[j] += e - s
    return out


def step_median_ms(trace, name: str) -> Optional[float]:
    """The median over the traced steps of the host time in ``name``."""
    per = per_step_s(trace, name)
    return None if per is None else float(np.median(per)) * 1e3


def union(intervals) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """Seconds in both of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Interval]:
    """The traced window's intervals with no device operation."""
    out: List[Interval] = []
    t = 0.0
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.window_s > t:
        out.append((t, trace.window_s))
    return out


def program_idle_s(trace) -> Optional[float]:
    """Idle device seconds inside some span of the program, or None when
    the window has none."""
    if trace is None:
        return None
    mine = union((s, e) for _, s, e in program_spans(trace))
    if not mine:
        return None
    return overlap_s(idle_intervals(trace), mine)


def registry() -> Optional[dict]:
    """The program's ``{name: (calls, seconds)}`` in this process, or None
    when the program has no registry."""
    try:
        trace = importlib.import_module("tpu_sparse_lu_torch.trace")
    except ImportError:
        return None
    return trace.totals()


def registry_s(name: str) -> Optional[float]:
    """Host seconds of the spans ``name`` in this process, or None."""
    reg = registry()
    if not reg or name not in reg:
        return None
    return reg[name][1]
