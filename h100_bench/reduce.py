"""The reduction of a profiler trace to device times, the idle share and
the breakdown.

Reads the Chrome trace ``torch.profiler`` exports: device operations are
the events of the categories in ``DEVICE_CATS``, the benchmark's own spans
are ``user_annotation`` events. Only what lies inside the ``bench.window``
span counts.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"

_ANON = re.compile(r"\(anonymous namespace\)::")


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = _ANON.sub("", name)
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0]


@dataclasses.dataclass
class Trace:
    """Device operations and host spans of one traced window; times in
    seconds from the window's start."""

    window_s: float
    steps: int
    ops: List[Tuple[str, float, float]]    # (name, start, end)
    spans: List[Tuple[str, float, float]]  # (name, start, end)

    def op_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def launches(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.ops if rx.search(n))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle device time, summed by the host span that held the gap's
        middle (``other`` between spans), longest first."""
        edges = [0.0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.window_s)
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [a for _, a, _ in spans]
        by: dict = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            j = bisect.bisect_right(starts, mid) - 1
            # the benchmark's spans do not nest: the one that started last
            # before the middle holds it, if it has not ended
            name = spans[j][0] if j >= 0 and mid < spans[j][2] else "other"
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> List[Tuple[str, float]]:
        """Device seconds by kernel, longest first."""
        by: dict = {}
        for n, s, e in self.ops:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [list(kv) for kv in self.device_ops()[:top]],
                "idle_gaps": [list(kv) for kv in self.idle_gaps()[:top]]}


def read_chrome_trace(path: str, steps: int) -> Optional[Trace]:
    """The :class:`Trace` of the ``bench.window`` span of an exported
    trace, or None when the trace has no such span."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        if end <= t0 or s >= t1:
            continue
        item = (e.get("name", ""), (max(s, t0) - t0) * 1e-6,
                (min(end, t1) - t0) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            ops.append(item)
        elif e.get("cat") == "user_annotation" and item[0] != WINDOW_SPAN:
            spans.append(item)
    return Trace(window_s=(t1 - t0) * 1e-6, steps=steps, ops=ops,
                 spans=spans)
