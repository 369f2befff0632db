"""The benchmark of ``tpu_sparse_lu_torch``: one run of one cell.

A cell is a deployment (``configs/<name>.json``: the matrix, its family
in ``families/<name>.py``, the solver's settings, the reference) under a
traffic mix (``traffic/<name>.json``: the entry in ``entries/<name>.py``,
the right-hand sides, the value changes). Metrics are readers in
``metrics/<name>.py``, limits of the output check ``limits/<cell>.json``.
Everything is found by the names in ``BENCHMARK.json``: a cell, a mix or
a metric is added with files and entries, without editing a file.

The loop is a time-stepper's: closed, one step in flight. Each step takes
the next inputs from a ring made on the device from the seed in set-up,
calls the program's entry, and ends when the host has synchronised with
the device. After the window the benchmark judges a sample of the steps'
answers, drawn from the seed, against the plain float64 reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "tpu_sparse_lu_torch"
# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_sparse_lu")
SAMPLE = 32      # answers judged a run, drawn from the seed
WARMUP_S = 1.0   # warm-up steps in set-up (at least WARMUP_STEPS of them)
WARMUP_STEPS = 20
TRACE_S = 1.0    # length of the traced window of a --trace 1 run
TRACE_WARMUP_STEPS = 20
SYNC_SPAN = "sync"
INPUTS_SPAN = "traffic.next_inputs"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Bench:
    """The benchmark's registry: ``BENCHMARK.json``'s entries, and the
    files they name, searched for in ``dirs`` in order."""

    def __init__(self, spec: dict, dirs=(HERE,)):
        self.spec = spec
        self.dirs = [Path(d) for d in dirs]

    @classmethod
    def load(cls, root: Path = ROOT) -> "Bench":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f))

    def file(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def data(self, kind: str, name: str) -> dict:
        with open(self.file(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py``; for a metric ``<stem>.<variant>`` without
        a file of its own, the stem's reader ``metrics/<stem>.py``."""
        try:
            path = self.file(kind, name, ".py")
        except FileNotFoundError:
            if kind != "metrics" or "." not in name:
                raise
            path = self.file(kind, name.split(".", 1)[0], ".py")
        spec = importlib.util.spec_from_file_location(
            f"h100_bench_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


@dataclasses.dataclass
class Ring:
    """A traffic mix's inputs, made on the device from the run's seed:
    ``b`` (rhs_ring, n, R) right-hand sides, and ``values`` (value_ring,
    nnz) same-pattern values of ``A`` (``None`` when the mix keeps A
    fixed). Step ``i`` takes ``b[i % rhs_ring]`` and
    ``values[i % value_ring]``.

    The mix's ``value_change`` says how values change:
    ``"independent"``, every entry ``a·(1 + value_scale·N(0, 1))``; or
    ``"keep_dominance"``, the off-diagonal entries so and each diagonal
    entry moved by the change of its row's off-diagonal magnitudes, so
    that every row keeps its margin of diagonal dominance, as the
    coefficients of a diffusion operator do when they change."""

    b: "torch.Tensor"
    values: Optional["torch.Tensor"]

    @classmethod
    def make(cls, A: sp.csc_matrix, traffic: dict, seed: int, device,
             dtype) -> "Ring":
        import torch

        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 63)
        b = torch.randn((traffic["rhs_ring"], A.shape[0], traffic["rhs"]),
                        generator=g, device=device, dtype=dtype)
        values = None
        if traffic["value_ring"]:
            a0 = torch.as_tensor(A.data, dtype=torch.float64, device=device)
            noise = torch.randn((traffic["value_ring"], a0.shape[0]),
                                generator=g, device=device,
                                dtype=torch.float64)
            values = a0 * (1.0 + traffic["value_scale"] * noise)
            change = traffic.get("value_change", "independent")
            if change == "keep_dominance":
                values = cls._keep_dominance(A, a0, values)
            elif change != "independent":
                raise ValueError(f"unknown value_change {change!r}")
            values = values.to(dtype)
        return cls(b, values)

    @staticmethod
    def _keep_dominance(A: sp.csc_matrix, a0, values):
        import torch

        rows = torch.as_tensor(A.indices, dtype=torch.int64,
                               device=a0.device)
        cols = torch.as_tensor(np.repeat(np.arange(A.shape[1]),
                                         np.diff(A.indptr)),
                               dtype=torch.int64, device=a0.device)
        diag = rows == cols
        if int(diag.sum()) != A.shape[0]:
            raise ValueError("keep_dominance needs every diagonal entry "
                             "stored")
        grow = torch.where(diag, 0.0, values.abs() - a0.abs())
        delta = torch.zeros((values.shape[0], A.shape[0]),
                            dtype=values.dtype, device=values.device)
        delta.index_add_(1, rows, grow)
        return torch.where(diag, a0 + torch.sign(a0) * delta[:, rows],
                           values)

    def __post_init__(self):
        # the views a step takes, made once: indexing a tensor costs the
        # host some microseconds a step
        self._b = list(self.b)
        self._a = [None] if self.values is None else list(self.values)

    def inputs(self, i: int):
        return self._a[i % len(self._a)], self._b[i % len(self._b)]


class Sample:
    """A uniform sample of ``k`` of a window's answers, drawn from the
    seed (reservoir sampling), each copied as it is drawn."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: list = []  # (step, answer)

    def offer(self, i: int, x) -> bool:
        if len(self.kept) < self.k:
            self.kept.append((i, x.clone()))
            return True
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, x.clone())
            return True
        return False


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float
    construct_s: float
    steps: int
    window_s: float
    latency_s: np.ndarray   # a step: from the call to the synchronise's return
    dispatch_s: np.ndarray  # a step: from the call to the entry's return
    work: object            # work.Work
    trace: object = None    # reduce.Trace of a --trace 1 run

    @property
    def step_s(self) -> float:
        return self.window_s / self.steps

    @property
    def p95_s(self) -> float:
        return float(np.percentile(self.latency_s, 95))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


@dataclasses.dataclass
class Setup:
    A: sp.csc_matrix
    F: object
    step: object
    span: str
    ring: Ring
    work: object
    construct_s: float


def setup(bench: Bench, cell: str, seed: int, device) -> Setup:
    """Build the deployment, the entry and the ring, and warm up."""
    import torch

    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig

    from . import work as work_mod

    c = bench.cell(cell)
    cfg = bench.data("configs", c["config"])
    traffic = bench.data("traffic", c["traffic"])
    A = sp.csc_matrix(bench.module("families", cfg["family"]).build(
        **cfg["matrix"]))
    A.sort_indices()
    t = time.perf_counter()
    F = ParallelSparseLU(A, config=SolverConfig(**cfg["solver"]),
                         device=device)
    construct_s = time.perf_counter() - t
    # the host factors' patterns, before the device plan re-tiles them
    work = work_mod.count(A, F.L, F.U, traffic["rhs"], cfg["solver"]["dtype"])
    if traffic["value_ring"]:  # the refactor plan, where values change
        t = time.perf_counter()
        F.enable_device_refactor()
        construct_s += time.perf_counter() - t
    entry = bench.module("entries", traffic["entry"])
    ring = Ring.make(A, traffic, seed, device, getattr(torch, cfg["solver"]
                                                       ["dtype"]))
    step = entry.make(F)
    sync = _sync(device)
    t_end = time.perf_counter() + WARMUP_S
    i = 0
    while i < WARMUP_STEPS or time.perf_counter() < t_end:
        step(*ring.inputs(i))
        sync()
        i += 1
    return Setup(A, F, step, entry.SPAN, ring, work, construct_s)


def window(s: Setup, seconds: float, sample: Optional[Sample], device):
    """Run steps for ``seconds``; returns (steps, window_s, latencies,
    dispatch times). Copying the sampled answers is left out of the
    window."""
    sync = _sync(device)
    step, inputs = s.step, s.ring.inputs
    lat, disp = [], []
    left_out = 0.0
    i = 0
    t_start = time.perf_counter()
    t_stop = t_start + seconds
    t2 = t_start
    while t2 < t_stop:
        t0 = time.perf_counter()
        x = step(*inputs(i))
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        disp.append(t1 - t0)
        if sample is not None and sample.offer(i, x):
            sync()
            t3 = time.perf_counter()
            left_out += t3 - t2
            t2 = t3
        i += 1
    return (i, t2 - t_start - left_out, np.asarray(lat),
            np.asarray(disp))


def traced(s: Setup, steps: int, first: int):
    """``steps`` steps under ``torch.profiler``, inside a ``bench.window``
    span, each part of a step in a span of its own; returns the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .reduce import WINDOW_SPAN, read_chrome_trace

    step, inputs = s.step, s.ring.inputs
    sync = torch.cuda.synchronize
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + TRACE_WARMUP_STEPS):
            step(*inputs(i))
            sync()
        first += TRACE_WARMUP_STEPS
        with record_function(WINDOW_SPAN):
            for i in range(first, first + steps):
                with record_function(INPUTS_SPAN):
                    a, b = inputs(i)
                with record_function(s.span):
                    step(a, b)
                with record_function(SYNC_SPAN):
                    sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, steps)


def by_matrix(A: sp.csc_matrix, kept: list):
    """The sampled steps grouped by the matrix they solved: (A with the
    group's values, indices into ``kept``). ``kept`` holds (values or
    None, b, x) on the host."""
    groups: dict = {}
    for j, (a, _, _) in enumerate(kept):
        groups.setdefault(None if a is None else a.tobytes(),
                          (a, []))[1].append(j)
    for a, js in groups.values():
        yield (A if a is None else sp.csc_matrix(
            (a.astype(np.float64), A.indices, A.indptr), shape=A.shape)), js


def judge(bench: Bench, cfg: dict, A: sp.csc_matrix, kept: list,
          device) -> List[dict]:
    """Each sampled answer against the configuration's reference: its
    widest forward error against the reference's float64 solve
    (``fwd_err``) and its widest normwise backward error (``bwd_err``),
    over its columns."""
    ref = bench.module("reference", cfg["reference"])
    out = [None] * len(kept)
    for As, js in by_matrix(A, kept):
        B = np.concatenate([kept[j][1] for j in js], axis=1).astype(
            np.float64)
        X = np.concatenate([kept[j][2] for j in js], axis=1).astype(
            np.float64)
        fwd = ref.forward_errors(X, ref.solve(As, B, device))
        bwd = ref.backward_errors(As, X, B, device)
        col = 0
        for j in js:
            r = kept[j][1].shape[1]
            f, b = fwd[col:col + r], bwd[col:col + r]
            ok = np.all(np.isfinite(X[:, col:col + r]))
            out[j] = {"fwd_err": float(f.max()) if ok else math.inf,
                      "bwd_err": float(b.max()) if ok else math.inf}
            col += r
    return out


def host_copies(s: Setup, sample: Sample) -> list:
    """(values or None, b, x) of each sampled step, on the host."""
    out = []
    for i, x in sample.kept:
        a, b = s.ring.inputs(i)
        out.append((None if a is None else a.cpu().numpy(),
                    b.cpu().numpy(), x.cpu().numpy()))
    return out


def free(s: Setup, device) -> None:
    """Drop the program's state before the reference runs."""
    import torch

    s.F = s.step = s.ring = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device, t0: float) -> dict:
    """One run; returns the result: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``trace`` ``breakdown``,
    and ``checks`` (each number compared, with its limit)."""
    import torch

    c = bench.cell(cell)
    cfg = bench.data("configs", c["config"])
    limits = bench.data("limits", cell)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    s = setup(bench, cell, seed, device)
    setup_s = time.perf_counter() - t0
    sample = Sample(SAMPLE, seed)
    gc.collect()  # set-up's garbage is not the window's
    steps, window_s, lat, disp = window(s, seconds, sample, device)
    trc = None
    if trace:
        n = max(TRACE_WARMUP_STEPS, int(round(TRACE_S * steps / window_s)))
        trc = traced(s, n, first=steps)
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if is_cuda else 0}
    if trc is not None:
        dev["busy_s"] = trc.busy_s
        dev["window_s"] = trc.window_s
    kept = host_copies(s, sample)
    free(s, device)
    judged = judge(bench, cfg, s.A, kept, device)
    checks = {k: max(j[k] for j in judged) for k in limits} if judged else {}
    failed = sum(1 for j in judged
                 if not all(j[k] <= lim for k, lim in limits.items()))
    run = Run(setup_s=setup_s, construct_s=s.construct_s,
              steps=steps, window_s=window_s, latency_s=lat,
              dispatch_s=disp, work=s.work, trace=trc)
    metrics = {}
    for m in bench.metrics(cell, trace):
        v = bench.module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": failed == 0 and bool(judged), "attempted": steps,
              "failed": failed, "metrics": metrics, "device": dev}
    if trc is not None:
        result["breakdown"] = trc.breakdown()
        # the cost of tracing: the mean step with and without the profiler
        result["tracing"] = {"step_ms": run.step_s * 1e3,
                             "traced_step_ms": trc.window_s / trc.steps * 1e3}
    result["checks"] = {k: {"value": checks.get(k), "limit": lim}
                        for k, lim in limits.items()}
    return result
