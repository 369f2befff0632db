#!/usr/bin/env python3
"""Time the headline ``ldiv`` (B1) on one CUDA card, route by route.

    python3 tools/ldiv_sweep.py [--tree NAME=PATH ...] [--rs 1,16,64]
                                [--deployment NAME] [--strip 1,4,8,16]
                                [--clocks] [NAME=PATH.cu ...]

Needs one CUDA card and ``nvcc``. On the headline deployment
(``chip_smoke._headline_solver``: 2D Poisson 100x100, chunk_size=128,
nd, nd_cutoff=512), or the one ``--deployment`` names (``DEPLOYMENTS``:
the benchmark's block-banded plans), in float32, float64 and float32
with the bfloat16 tile stream, at each R of ``--rs``, it records:

* ``F._numeric.tiles(b)`` per solve (the solver's own route: one
  ``ldiv_fused`` launch where the tree has it), eager (CUDA events,
  ``chip_smoke._median_ms``) and by CUDA-graph replay
  (``chip_smoke._graph_ms``);
* the same for the 32-launch route (``perm_gather``, the L and U waves of
  ``blocked_tri_solve``, ``perm_gather``) and for its waves alone;
* at R = 16, ``torch.profiler``'s device time of every launch of one
  solve of each route, their sum and the span from the first launch's
  start to the last one's end, eager and by graph replay: the device's
  busy share during a solve;
* the critical path: the dependent waves of each factor, and each wave's
  blocks (destinations x column strips) against the card's SMs.

``--strip 1,4,8,16`` instead times one ``ldiv_fused`` launch at each strip
width (``fused_ldiv(..., strip=)``), eager and by graph replay, in turns
forwards then backwards, holds every width bit for bit to the 16-column
one, and prints each launch's time over the schedule's critical path (the
time of one dependent task, ``fused_ldiv.TASK_US``; on a plan whose path
lies mostly in runs, the time of a run's step, ``fused_ldiv.RUN_TASK_US``)
beside the width the wrapper's rule picks.

``--tree NAME=PATH`` runs the same measurements on another checkout of
the repository (``PATH`` holds ``tpu_sparse_lu_torch/``), each in a
process of its own that imports and builds that checkout's package; the
trees run in the order given (a name may repeat, for turns), and without
``--tree`` only this checkout runs. A tree must keep its solver's device
state in one ``F._numeric`` (``solve.DeviceFactors``), as this one does.
Each tree's numbers also go to
``OUT/NAME_<i>.json`` (``--out``, by default
``tpu_sparse_lu_torch/_build/ldiv_sweep``).

``NAME=PATH.cu`` adds versions of ``csrc/ldiv_fused.cu``: each is built
alone into a side library under ``tpu_sparse_lu_torch/_build/sweep/``
(one ``nvcc -Xptxas -v`` each, all started together; registers, stack and
spills printed), held bit for bit against the 32-launch route, and timed
through the ``fused_ldiv`` wrapper pointed at it, in turns with the
shipped source, forwards then backwards. ``--clocks`` adds a copy of the
shipped source with ``%globaltimer`` stamps patched in at fixed places
(``CLOCK_PATCH``; the shipped kernel carries none) and prints, for one
float32 solve at R = 16, the mean of each ticket's wait, load, products,
reduction and publish times by task kind, a run's step split into its
ring wait, products, reduction and stores and publish, the critical
chain step by step, and the SMs' busy share, at the width the wrapper's
rule picks (and at every width of ``--strip``).
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tpu_sparse_lu_torch" / "_build" / "ldiv_sweep"
SIDE = ROOT / "tpu_sparse_lu_torch" / "_build" / "sweep"
SHIPPED = ROOT / "tpu_sparse_lu_torch" / "csrc" / "ldiv_fused.cu"
CONFIGS = (("float32", "float32"), ("float64", "float32"),
           ("float32", "bfloat16"))
SMS = 132
# --deployment: the matrix and SolverConfig of each of the benchmark's
# block-banded plans (h100_bench/configs); "headline" is chip_smoke's
DEPLOYMENTS = {
    "banded_120x30": (("block_banded", 120, 30),
                      dict(chunk_size=128, ordering="colamd")),
    "banded_1600x64": (("block_banded", 1600, 64),
                       dict(chunk_size=128, ordering="colamd")),
}


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path, so a tree's own
    package stays first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _solver(cs_mod, dtype, stream, deployment="headline"):
    """The deployment's solver, or None where the tree lacks the
    stream."""
    import numpy as np

    from tpu_sparse_lu_torch import ParallelSparseLU, SolverConfig, models

    if deployment == "headline":
        H = cs_mod.HEADLINE
        A = models.poisson_2d(H["nx"], H["ny"])
        kw = dict(chunk_size=H["chunk_size"], ordering=H["ordering"],
                  nd_cutoff=H["nd_cutoff"])
    else:
        (family, *shape), kw = DEPLOYMENTS[deployment]
        A = getattr(models, family)(np.random.default_rng(0), *shape)
        kw = dict(kw)
    kw["dtype"] = dtype
    if stream != "float32":
        kw["stream_dtype"] = stream
    try:
        cfg = SolverConfig(**kw)
    except (ValueError, NotImplementedError):
        return None
    return ParallelSparseLU(A, config=cfg, device="cuda")


def _fused(F, b, strip=None):
    """One ``ldiv_fused`` launch on F's schedule and tile stream at strip
    width ``strip`` (default: the rule's)."""
    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    N = F._numeric
    L, U = N.ldata, N.udata
    if L.tiles_bf16 is not None:
        return FL.fused_ldiv_bf16(b, N.sched, L.tiles_bf16, U.tiles_bf16,
                                  N.rs, strip=strip)
    return FL.fused_ldiv(b, N.sched, L.tiles_t, U.tiles_t, N.rs,
                         strip=strip)


def _chosen_strip(F, R):
    """The strip width the wrapper's rule picks for F's launch at R."""
    import torch

    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    if not hasattr(FL, "launch_strip"):  # an older tree: R alone
        return FL.strip_width(R)
    name = ("ldiv_fused_bf16" if F._numeric.ldata.tiles_bf16 is not None else
            f"ldiv_fused_{FL._KERNEL_DTYPES[F.dtype]}")
    return FL.launch_strip(name, F._numeric.sched, R,
                           torch.device("cuda", torch.cuda.current_device()))


def _stream_kw():
    from tpu_sparse_lu_torch.solve import blocked_tri_solve

    params = inspect.signature(blocked_tri_solve).parameters
    return {"stream": True} if "stream" in params else {}


def _waves(F, xw, kw):
    from tpu_sparse_lu_torch.solve import blocked_tri_solve

    blocked_tri_solve(F._numeric.ldata, xw, **kw)
    blocked_tri_solve(F._numeric.udata, xw, **kw)
    return xw


def _route32(F, b, kw):
    """perm_gather, the L and U waves, perm_gather: 2 + waves launches."""
    from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather

    R, N = b.shape[1], F._numeric
    xw = perm_gather(b, N.pidx, N.rs).view(F.plan.lplan.K + 1, F.plan.cs, R)
    return perm_gather(_waves(F, xw, kw).view(-1, R), N.qidx)


def _kernel_events(path):
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return sorted((e for e in ev if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])


def _short(name):
    m = re.search(r"(\w+_kernel)<([^>]*)>", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else name[:60]


def _profile(out_dir, fn, tag, n=3):
    """Device time of each launch of the last of ``n`` solves, eager and
    by graph replay, from ``torch.profiler``'s trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, stream=side):
        fn()
    for mode, call in (("eager", fn), ("graph", graph.replay)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        path = out_dir / f"trace_{tag}_{mode}.json"
        prof.export_chrome_trace(str(path))
        ev = _kernel_events(path)
        path.unlink()
        if not ev or len(ev) % n:
            out[mode] = {"seen": len(ev)}
            continue
        last = ev[-(len(ev) // n):]
        busy = sum(e["dur"] for e in last)
        span = last[-1]["ts"] + last[-1]["dur"] - last[0]["ts"]
        out[mode] = {
            "launches": len(last), "busy_us": busy, "span_us": span,
            "busy_share": busy / span if span else None,
            "per_launch_us": [[_short(e["name"]), e["dur"]] for e in last]}
    return out


def _critical_path(F, R):
    """Waves of each factor and each wave's blocks at R (strips of the
    width the wrapper's rule picks)."""
    strips = -(-R // _chosen_strip(F, R))
    return {f: [int(w.dst.shape[0]) * strips for w in d.waves]
            for f, d in (("L", F._numeric.ldata), ("U", F._numeric.udata))}


KINDS = ("perm-in", "L diagonal", "L off-diagonal", "U diagonal",
         "U off-diagonal", "perm-out")


def _kind(flags):
    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    k = flags & FL.KIND_MASK
    if k == FL.PERM_IN:
        return 0
    if k == FL.PERM_OUT:
        return 5
    return 1 + 2 * bool(flags & FL.BANK_U) + bool(flags & FL.ACCUMULATE)


# the clocks copy of ldiv_fused.cu: (anchor, what goes before it, what
# goes after it); each anchor must occur once. Per task and strip (its
# ready flag's index), thread 0 stamps the SM, then the %globaltimer ns at
# start, dependencies met, first operands staged, products done, results
# stored, flag published; a task inside a run at its step's start, its
# loads issued, ring waited (tile and strip in), products done, stored,
# and the end of the step (after the batch's flags where it ends one);
# ldiv_fused_clocks copies them out.
CLOCK_PATCH = (
    ("using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;\n",
     "", """
constexpr int kClockTickets = 1 << 16;
constexpr int kClockSlots = 7;
__device__ unsigned long long g_clocks[kClockTickets][kClockSlots];
__shared__ int s_clock_ticket;  // the block's current task and strip

__device__ __forceinline__ unsigned long long sm_id() {
  unsigned int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define CLOCK(slot, v)                                      \\
  if (threadIdx.x == 0 && s_clock_ticket < kClockTickets) \\
  g_clocks[s_clock_ticket][slot] = (v)
"""),
    ("    const int t_end = unit_ptr[unit + 1];\n", "",
     "    if (threadIdx.x == 0) s_clock_ticket = t * strips + strip;"
     "\n    CLOCK(0, sm_id());\n    CLOCK(1, global_ns());\n"),
    ("    // 3. the task\n", "    CLOCK(2, global_ns());\n", ""),
    ("    tile_product<T, TT, RB>(acc, ts, xs, cs);\n",
     "    if (e == e0) CLOCK(3, global_ns());\n", ""),
    ("  // deterministic cross-warp reduction", "  CLOCK(4, global_ns());\n",
     ""),
    ("      xd[(int64_t)i * R + j0 + j] = old[u] + warp_sum<T, RB>(ps, i, j, cs);"
     "\n  }\n", "", "  CLOCK(5, global_ns());\n"),
    ("      const bool in = kind == kPermIn;\n", "",
     "      CLOCK(3, global_ns());\n      CLOCK(4, global_ns());\n"),
    ("          y[row * R + j0 + j] = val;\n        }\n      }\n", "",
     "      CLOCK(5, global_ns());\n"),
    ("      flag_ref(done[t * strips + strip]).store(gen,\n"
     "                                               cuda::memory_order_release);"
     "\n", "", "    CLOCK(6, global_ns());\n"),
    ("    const int4 m = q[0];\n", "",
     "    if (threadIdx.x == 0)\n"
     "      s_clock_ticket = (t0 + i) * strips + strip;\n"
     "    CLOCK(0, sm_id());\n    CLOCK(1, global_ns());\n"),
    ("    wait_bar(smem_u32(ring + i % NB)", "    CLOCK(2, global_ns());\n",
     ""),
    ("    __syncthreads();  // the tile and the strip are in\n", "",
     "    CLOCK(3, global_ns());\n"),
    ("    tile_product<T, TT, RB>(acc, buf(i), xs, cs);\n", "",
     "    CLOCK(4, global_ns());\n"),
    ("    if (i + 1 == n || (i + 1) % kRunBatch == 0) {\n",
     "    CLOCK(5, global_ns());\n", ""),
    ("#pragma unroll\n    for (int k = 0; k < NB + 1; ++k) q[k] = q[k + 1];\n",
     "    CLOCK(6, global_ns());\n", ""),
    ("LDIV_FUSED_ENTRY(bf16, float, __nv_bfloat16, void)\n", "", """
int ldiv_fused_clocks(void* host, int n) {
  if (n > kClockTickets) n = kClockTickets;
  return (int)cudaMemcpyFromSymbol(
      host, g_clocks, (size_t)n * kClockSlots * sizeof(unsigned long long));
}
"""),
)


def _with_clocks(text: str) -> str:
    """``text`` (a version of ldiv_fused.cu) with the clock stamps."""
    for anchor, before, after in CLOCK_PATCH:
        if text.count(anchor) != 1:
            raise SystemExit(f"--clocks: {anchor.strip()[:50]!r} occurs "
                             f"{text.count(anchor)} times, not once")
        text = text.replace(anchor, before + anchor + after)
    return text


def _build_versions(versions):
    """Compile every version of ldiv_fused.cu alone, in parallel; returns
    {name: (so, ptxas output)}."""
    from tpu_sparse_lu_torch.ops import _build as B

    SIDE.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = B._nvcc(), {}
    for name, text, flags in versions:
        h = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:12]
        src, so = SIDE / f"{name}_{h}.cu", SIDE / f"{name}_{h}.so"
        src.write_text(text)
        cmd = [nvcc, *B._FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
               str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), cmd)
    built = {}
    for name, (so, proc, cmd) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{' '.join(cmd)}\n{out}")
        built[name] = (so, out)
    return built


def _ptxas_facts(name, ptxas):
    """Registers, stack and spills of each ldiv_fused_kernel instance."""
    cur = None
    for line in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?$", line.strip())
        if m:
            cur = m.group(1)
            continue
        if cur and "ldiv_fused_kernel" in cur and (
                "Used" in line or "stack frame" in line):
            m = re.search(r"ldiv_fused_kernelI(\w)(\w+?)Li(\d+)E", cur)
            tag = (f"<{m.group(1)},{m.group(2)},{m.group(3)}>" if m
                   else cur[:40])
            print(f"[ptxas] {name} ldiv_fused_kernel{tag}: {line.strip()}",
                  flush=True)


class _Side:
    """The kernel library with its ``ldiv_fused*`` entries taken from a
    side library."""

    def __init__(self, side):
        from tpu_sparse_lu_torch.ops import _build as B

        self.side, self.main = B.bind_fused_ldiv(side), B.load()

    def __getattr__(self, name):
        lib = self.side if name.startswith("ldiv_fused") else self.main
        return getattr(lib, name)


def _use(side):
    """Point the fused_ldiv wrappers at a side library."""
    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    FL._lib = lambda L=_Side(side): L
    FL._CAPACITY.clear()
    FL._TAKES_RUNS.clear()


def _clocks(cs_mod, F, lib, b, strip):
    """Per ticket of one solve at strip width ``strip``: wait, load and
    compute times from ``%globaltimer``, by task kind, the critical chain
    and the SMs' busy share."""
    import ctypes

    import numpy as np
    import torch

    lib.ldiv_fused_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ldiv_fused_clocks.restype = ctypes.c_int
    _use(lib)
    S = F._numeric.sched
    strips = -(-b.shape[1] // strip)
    n_t = S.n_tasks * strips
    if n_t > 1 << 16:
        print(f"[clocks] strip {strip}: {n_t} tickets, more than the 65,536 "
              f"the clocks copy records; skipped", flush=True)
        return
    for _ in range(3):
        _fused(F, b, strip)
    torch.cuda.synchronize()
    c = np.zeros((n_t, 7), dtype=np.uint64)
    if lib.ldiv_fused_clocks(c.ctypes.data, n_t) != 0:
        raise RuntimeError("ldiv_fused_clocks failed")
    c = c.astype(np.int64)
    sm, t1, t2, t3, t_prod, t_store, t4 = c.T
    t0 = t1.min()
    span = t4.max() - t0
    tick = np.diff(np.unique(np.concatenate([t1, t2, t3, t4])))
    kinds = np.array([_kind(int(S.task[t // strips, 0]))
                      for t in range(n_t)])
    print(f"[clocks] one solve at strip {strip} (critical path "
          f"{S.critical_path} tasks), {n_t} tickets on "
          f"{len(np.unique(sm))} SMs: "
          f"span {span / 1e3:.2f} us (globaltimer steps >= "
          f"{tick[tick > 0].min() if tick.size else 0} ns); mean us "
          f"(wait for dependencies, load after them, products (later "
          f"entries' tiles included), reduction and stores, publish):",
          flush=True)
    # a run's tasks after its first: step = start -> start of the next
    later = np.zeros(S.n_tasks, dtype=bool)
    for r0, r1 in getattr(S, "runs", ()):
        later[r0 + 1:r1 + 1] = True
    later = np.repeat(later, strips)
    for k, name in enumerate(KINDS):
        m = (kinds == k) & ~later
        if m.any():
            print(f"[clocks]   {name} x{int(m.sum())}: " + ", ".join(
                f"{(hi - lo)[m].mean() / 1e3:.2f}" for lo, hi in (
                    (t1, t2), (t2, t3), (t3, t_prod), (t_prod, t_store),
                    (t_store, t4))), flush=True)
    if later.any():
        step = t4 - t1
        print(f"[clocks]   inside runs x{int(later.sum())}, mean us a step "
              f"{step[later].mean() / 1e3:.3f} (median "
              f"{np.median(step[later]) / 1e3:.3f}): issues "
              f"{(t2 - t1)[later].mean() / 1e3:.3f}, ring wait and barrier "
              f"{(t3 - t2)[later].mean() / 1e3:.3f}, products "
              f"{(t_prod - t3)[later].mean() / 1e3:.3f}, reduction and "
              f"stores {(t_store - t_prod)[later].mean() / 1e3:.3f}, "
              f"publish {(t4 - t_store)[later].mean() / 1e3:.3f}", flush=True)
        for r0, r1 in S.runs:
            for col in range(min(strips, 2)):
                a, z = r0 * strips + col, r1 * strips + col
                print(f"[clocks]   run {r0}..{r1} strip {col}: "
                      f"{(t4[z] - t1[a]) / 1e3:.2f} us over {r1 - r0 + 1} "
                      f"tasks on SM {sm[a]}", flush=True)
    busy = (t4 - t2).sum()
    print(f"[clocks] SM busy share (load + compute over span x {SMS} SMs): "
          f"{busy / (span * SMS):.3f}; blocks resident "
          f"{len(np.unique(sm))} SMs", flush=True)
    # the critical chain: from the last ticket back through the dependency
    # whose flag came last
    chain, t = [], int(np.argmax(t4))
    while True:
        task, col = divmod(t, strips)
        deps = [d * strips + col
                for d in S.dep[S.dep_ptr[task]:S.dep_ptr[task + 1]]]
        prev = max(deps, key=lambda d: t4[d]) if deps else None
        lag = t2[t] - max(t1[t], t4[prev]) if prev is not None else 0
        chain.append((KINDS[kinds[t]], lag, t3[t] - t2[t], t4[t] - t3[t],
                      int(S.task[task, 3] - S.task[task, 2])))
        if prev is None:
            break
        t = prev
    chain.reverse()
    print(f"[clocks] critical chain, {len(chain)} steps (kind, entries: "
          f"flag lag after the producer's publish, load, compute us): "
          + "; ".join(f"{k[:6]} {e}: {lag / 1e3:.2f} {ld / 1e3:.2f} "
                      f"{cp / 1e3:.2f}" for k, lag, ld, cp, e in chain),
          flush=True)
    tot = np.array([[lag, ld, cp] for _, lag, ld, cp, _ in chain]).sum(0)
    print(f"[clocks] chain sums us: flag lag {tot[0] / 1e3:.2f}, load "
          f"{tot[1] / 1e3:.2f}, compute {tot[2] / 1e3:.2f} of the span "
          f"{span / 1e3:.2f}", flush=True)


def _versions_run(cs_mod, args, rng):
    """Versions of ldiv_fused.cu side by side: check, time, clocks."""
    import ctypes

    import torch

    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    versions = [("shipped", SHIPPED.read_text(), [])]
    for a in args.sources:
        name, _, path = a.partition("=")
        if not path:
            raise SystemExit(f"expected NAME=PATH.cu, got {a!r}")
        versions.append((name, Path(path).read_text(), []))
    if args.clocks:
        versions.append(("shipped_clocks", _with_clocks(versions[0][1]), []))
    built = _build_versions(versions)
    for name, (so, out) in built.items():
        _ptxas_facts(name, out)
    libs = {n: ctypes.CDLL(str(built[n][0])) for n in built}
    timed = [n for n in libs if n != "shipped_clocks"]
    own = FL._lib
    Rs = [int(r) for r in args.rs.split(",")]
    kw = _stream_kw()
    times = {}
    try:
        for dtype, stream in CONFIGS:
            F = _solver(cs_mod, dtype, stream, args.deployment)
            bs = {R: torch.as_tensor(rng.random((F.n, R)), dtype=F.dtype,
                                     device="cuda") for R in Rs}
            for name in timed:
                _use(libs[name])
                for R, b in bs.items():
                    ref = _route32(F, b, kw)
                    for grid in (1, 7, None):
                        if not torch.equal(cs_mod._fused(F, b, grid), ref):
                            raise AssertionError(
                                f"{name} {dtype}/{stream} R={R} grid={grid}"
                                f": differs from the 32-launch route")
            print(f"[versions] {dtype}/{stream}: every version bit for bit "
                  f"equal to the 32-launch route at R in {Rs}, grids 1, 7, "
                  f"default", flush=True)
            for turn in (timed, timed[::-1]):
                for name in turn:
                    _use(libs[name])
                    for R, b in bs.items():
                        t = times.setdefault((name, dtype, stream, R), [])
                        t.append((cs_mod._median_ms(
                            lambda _: F._numeric.tiles(b)),
                            cs_mod._graph_ms(lambda: F._numeric.tiles(b))))
            if args.clocks and dtype == "float32" and stream == "float32":
                b = bs[16] if 16 in bs else bs[max(bs)]
                for w in sorted({_chosen_strip(F, b.shape[1]),
                                 *_widths(args)}):
                    _clocks(cs_mod, F, libs["shipped_clocks"], b, w)
            del F
            torch.cuda.empty_cache()
    finally:
        FL._lib = own
        FL._CAPACITY.clear()
        FL._TAKES_RUNS.clear()
    print(f"[versions] ms per {args.deployment} solve on {_smi()}, eager / "
          f"graph replay, forwards and backwards:", flush=True)
    for (name, dtype, stream, R), t in times.items():
        print(f"[versions] {name} {dtype}/{stream} R={R}: "
              + ", ".join(f"{e:.4f} / {g:.4f}" for e, g in t), flush=True)


def _widths(args):
    return [int(w) for w in args.strip.split(",")] if args.strip else []


def _strips_run(cs_mod, args, rng):
    """--strip: one launch at each width on the deployment's schedule,
    held bit for bit to the 16-column width and timed in turns."""
    import torch

    from tpu_sparse_lu_torch.ops import fused_ldiv as FL

    widths = _widths(args)
    Rs = [int(r) for r in args.rs.split(",")]
    m, g = cs_mod._median_ms, cs_mod._graph_ms
    rows = []
    for dtype, stream in CONFIGS:
        F = _solver(cs_mod, dtype, stream, args.deployment)
        if F is None:
            continue
        S = F._numeric.sched
        for R in Rs:
            b = torch.as_tensor(rng.random((F.n, R)), dtype=F.dtype,
                                device="cuda")
            want = _fused(F, b, 16)
            times = {}
            for turn in (widths, widths[::-1]):
                for w in turn:
                    if not torch.equal(_fused(F, b, w), want):
                        raise AssertionError(
                            f"{dtype}/{stream} R={R} strip={w}: differs "
                            f"from the 16-column strip")
                    times.setdefault(w, []).append((
                        m(lambda _: _fused(F, b, w), reps=20),
                        g(lambda: _fused(F, b, w), reps=20)))
            chosen = _chosen_strip(F, R)
            # a run's step, on a path that lies mostly in runs: the path's
            # time less its other tasks at TASK_US
            run_path = getattr(S, "run_path", 0)
            if 2 * run_path < S.critical_path:
                run_path = 0
            units = getattr(S, "n_units", S.n_tasks)
            for w, t in times.items():
                graph = sorted(x for _, x in t)[len(t) // 2]
                run_us = ((graph * 1e3 - (S.critical_path - run_path)
                           * FL.TASK_US[w]) / run_path if run_path else None)
                rows.append(dict(deployment=args.deployment, dtype=dtype,
                                 stream=stream, R=R, strip=w,
                                 chosen=w == chosen, times=t,
                                 critical_path=S.critical_path,
                                 run_path=run_path, run_step_us=run_us,
                                 n_tasks=S.n_tasks))
                print(f"[strip] {args.deployment} {dtype}/{stream} R={R} "
                      f"strip {w}{' (chosen)' if w == chosen else ''}: "
                      f"{units * -(-R // w)} tickets; eager / graph ms "
                      + ", ".join(f"{e:.4f} / {x:.4f}" for e, x in t)
                      + f"; graph us a task on the critical path of "
                      f"{S.critical_path}: {graph * 1e3 / S.critical_path:.3f}"
                      + (f"; us a run step ({run_path} of the path's tasks "
                         f"in runs, the rest at TASK_US): {run_us:.3f}"
                         if run_path else ""), flush=True)
        del F
        torch.cuda.empty_cache()
    print(f"[strip] bit for bit at every width; card {_smi()}", flush=True)
    out = Path(args.out) / f"strips_{args.deployment}_{args.index}.json"
    out.write_text(json.dumps(rows, indent=1))


def _worker(args) -> int:
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs_mod = _chip_smoke()
    import numpy as np
    import torch

    from tpu_sparse_lu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _build.load()
    res = {"tree": args.worker, "root": str(root), "card": _smi(),
           "build_s": time.perf_counter() - t0, "cells": []}
    print(f"[{args.worker}] {root}: kernels built in {res['build_s']:.2f} s "
          f"on {res['card']}", flush=True)
    kw = _stream_kw()
    rng = np.random.default_rng(15)
    if args.strip:
        _strips_run(cs_mod, args, rng)
    if args.sources or args.clocks:
        _versions_run(cs_mod, args, rng)
    if args.strip or args.sources or args.clocks:
        return 0
    Rs = [int(r) for r in args.rs.split(",")]
    for dtype, stream in CONFIGS:
        F = _solver(cs_mod, dtype, stream, args.deployment)
        if F is None:
            print(f"[{args.worker}] {dtype}/{stream}: not in this tree",
                  flush=True)
            continue
        fused = F._numeric.sched is not None
        for R in Rs:
            b = torch.as_tensor(rng.random((F.n, R)), dtype=F.dtype,
                                device="cuda")
            x0 = _route32(F, b, kw)  # warm
            from tpu_sparse_lu_torch.ops.fused_ldiv import perm_gather

            xw0 = perm_gather(b, F._numeric.pidx, F._numeric.rs).view(
                F.plan.lplan.K + 1, F.plan.cs, R)
            work = xw0.clone()
            cell = {"dtype": dtype, "stream": stream, "R": R,
                    "fused": fused,
                    "critical_path": _critical_path(F, R)}
            m, g = cs_mod._median_ms, cs_mod._graph_ms
            cell["direct_eager_ms"] = m(lambda _: F._numeric.tiles(b))
            cell["route32_eager_ms"] = m(lambda _: _route32(F, b, kw))
            cell["waves_eager_ms"] = m(lambda x: _waves(F, x, kw),
                                       setup=xw0.clone)
            cell["direct_graph_ms"] = g(lambda: F._numeric.tiles(b))
            cell["route32_graph_ms"] = g(lambda: _route32(F, b, kw))
            cell["waves_graph_ms"] = g(lambda: _waves(F, work, kw),
                                       setup=lambda: work.copy_(xw0))
            if fused:
                same = torch.equal(F._numeric.tiles(b), x0)
                cell["fused_equals_route32"] = bool(same)
            if R == 16:
                tag = f"{args.worker}_{dtype}_{stream}"
                cell["profile_route32"] = _profile(
                    out_dir, lambda: _route32(F, b, kw), tag + "_r32")
                if fused:
                    cell["profile_direct"] = _profile(
                        out_dir, lambda: F._numeric.tiles(b), tag + "_direct")
            res["cells"].append(cell)
            print(f"[{args.worker}] {dtype}/{stream} R={R}: direct "
                  f"{cell['direct_eager_ms']:.4f} eager / "
                  f"{cell['direct_graph_ms']:.4f} graph ms; 32-launch route "
                  f"{cell['route32_eager_ms']:.4f} / "
                  f"{cell['route32_graph_ms']:.4f}; waves alone "
                  f"{cell['waves_eager_ms']:.4f} / "
                  f"{cell['waves_graph_ms']:.4f}"
                  + (f"; fused == 32-launch bit for bit: "
                     f"{cell['fused_equals_route32']}" if fused else ""),
                  flush=True)
            for key in ("profile_route32", "profile_direct"):
                for mode, p in cell.get(key, {}).items():
                    if "busy_us" not in p:
                        print(f"[{args.worker}]   {key} {mode}: profiler saw "
                              f"{p['seen']} kernels", flush=True)
                        continue
                    per = ", ".join(f"{d:.1f}" for _, d in
                                    p["per_launch_us"])
                    print(f"[{args.worker}]   {key} {mode}: "
                          f"{p['launches']} launches, device busy "
                          f"{p['busy_us']:.1f} us of a {p['span_us']:.1f} us "
                          f"span (busy share {p['busy_share']:.3f}); per "
                          f"launch us: {per}", flush=True)
            if R == Rs[0]:
                cp = cell["critical_path"]
                print(f"[{args.worker}]   critical path at R={R}: L "
                      f"{len(cp['L'])} waves, blocks {cp['L']}; U "
                      f"{len(cp['U'])} waves, blocks {cp['U']} "
                      f"({SMS} SMs)", flush=True)
        del F
        torch.cuda.empty_cache()
    with open(out_dir / f"{args.worker}_{args.index}.json", "w") as f:
        json.dump(res, f, indent=1)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of another checkout; repeatable, "
                             "run in order")
    parser.add_argument("--rs", default="1,16,64")
    parser.add_argument("--deployment", default="headline",
                        choices=["headline", *DEPLOYMENTS])
    parser.add_argument("--strip", default="",
                        help="comma-separated strip widths to time, e.g. "
                             "1,4,8,16")
    parser.add_argument("--out", default=str(OUT),
                        help="directory of the per-tree JSON files")
    parser.add_argument("--clocks", action="store_true",
                        help="add the shipped source with %%globaltimer "
                             "stamps and print per-ticket times of one "
                             "f32 solve at R = 16")
    parser.add_argument("sources", nargs="*", help="NAME=PATH.cu versions "
                        "of csrc/ldiv_fused.cu")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--index", default="0", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        return _worker(args)
    import torch

    if not torch.cuda.is_available():
        print("ldiv_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(_smi(), flush=True)
    trees = [("head", str(ROOT))]
    if args.tree:
        trees = []
        for t in args.tree:
            name, _, path = t.partition("=")
            if not path:
                raise SystemExit(f"expected NAME=PATH, got {t!r}")
            trees.append((name, path))
    for i, (name, path) in enumerate(trees):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               name, "--root", path, "--index", str(i), "--rs", args.rs,
               "--out", str(Path(args.out).resolve()),
               "--deployment", args.deployment, "--strip", args.strip,
               *(["--clocks"] if args.clocks else []), *args.sources]
        rc = subprocess.run(cmd, timeout=900).returncode
        if rc != 0:
            print(f"ldiv_sweep: tree {name} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
