#!/usr/bin/env python3
"""Time the device elimination (B3) on one CUDA card, tree by tree, and
read the one launch's per-task clocks.

    python3 tools/elim_sweep.py [--tree NAME=PATH ...] [--clocks] [--out F]

Needs one CUDA card and ``nvcc``. Cells, float32, on both deployments of
``chip_smoke.py`` (the headline: 2D Poisson 100x100, nd, chunk_size=128;
BASELINE config 2: ``block_banded(default_rng(0), 120, 30)``, colamd):
the elimination each tree's entry points run (``eliminate(store,
sched)``) and the ``refactor_numeric`` pipeline, by CUDA-graph replay
(``chip_smoke._graph_ms``: device time) and eager
(``chip_smoke._median_ms``: CUDA events, host included), and config 2's
fused refactor-solve step at R = 8 the same two ways.

``--tree NAME=PATH`` times another checkout (``PATH`` holds
``tpu_sparse_lu_torch/``, e.g. a ``git archive`` of an older commit
unpacked under the gitignored ``_trees/``), each in a process of its own
that imports and builds that checkout's package; trees run in the order
given (a name may repeat, for turns: parent, head, head, parent). Without
``--tree`` this checkout runs.

``--clocks`` builds this checkout's ``csrc/elim_fused.cu`` once more with
``-DELIM_FUSED_CLOCKS`` into a side library (``ptxas -v`` printed beside
the shipped build's), runs one launch on each deployment's real store
through the ``elim_fused`` wrapper pointed at it (the same bits as the
shipped build, checked), and prints per ticket kind the count, the SM
time it ran and waited, the launch's span and the SMs' busy share, and
the critical path: from the last ticket done, back through the
dependency each ticket waited for longest, the time of its LUs (and
their SM cycles), its products and the gaps between a dependency done
and its successor running; then the first LU's time in the same launch
run again at once and after a 64 MB write (more than L2 holds). Everything printed also goes to ``--out``
(default ``tpu_sparse_lu_torch/_build/sweep/elim_sweep.json``).
"""

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _sweep  # noqa: E402

SHIPPED = _sweep.ROOT / "tpu_sparse_lu_torch" / "csrc" / "elim_fused.cu"
OUT = _sweep.SIDE / "elim_sweep.json"
KINDS = ("lu", "rows", "cols", "schur")


def _deployments(cs):
    """[(name, F, A)] of both deployments, float32, device plans made."""
    A, F = cs._device_headline("float32")
    A2, F2 = cs._config2_solver("float32")
    F2.enable_device_refactor()
    return [("headline", F, A), ("config2", F2, A2)]


def _worker(args) -> int:
    sys.path.insert(0, args.root)
    cs = _sweep.chip_smoke()
    import numpy as np
    import torch

    from tpu_sparse_lu_torch.ops import _build
    from tpu_sparse_lu_torch.ops.elimination import eliminate
    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    res = {"tree": args.worker, "card": _sweep.smi(), "build_s": build_s,
           "cells": {}}
    rng = np.random.default_rng(9)
    for name, F, A in _deployments(cs):
        dev = F._refactor_dev
        store, _ = cs._real_store(F, A)
        work = store.clone()
        a = torch.as_tensor(A.tocsc().data, dtype=torch.float32,
                            device="cuda")
        cells = [
            ("elimination", lambda: eliminate(work, dev.elim),
             lambda: work.copy_(store)),
            ("refactor_numeric", lambda: refactor_pipeline(a, dev),
             lambda: None)]
        if name == "config2":
            step = F.make_refactor_solve_step()
            b = torch.as_tensor(rng.random((A.shape[0], 8)),
                                dtype=torch.float32, device="cuda")
            cells.append(("fused step R=8", lambda: step(a, b),
                          lambda: None))
        for label, fn, setup in cells:
            g = cs._graph_ms(fn, reps=30, setup=setup)
            e = cs._median_ms(lambda _: fn(), reps=30,
                              setup=lambda: setup())
            res["cells"][f"{name} {label}"] = {"graph_ms": g, "eager_ms": e}
            print(f"[{args.worker}] {name} {label}: graph replay {g:.4f} ms,"
                  f" eager {e:.4f} ms", flush=True)
    print(json.dumps(res))
    return 0


class _Side:
    """The kernel library with its ``elim_fused*`` entries taken from a
    side library."""

    def __init__(self, side):
        from tpu_sparse_lu_torch.ops import _build as B

        self.side, self.main = B.bind_elim_fused(side), B.load()

    def __getattr__(self, name):
        lib = self.side if name.startswith("elim_fused") else self.main
        return getattr(lib, name)


def _critical_path(tasks, c):
    """The chain of tickets that set the launch's end: from the last done,
    back through the dependency done last before each ran. Returns
    (tickets in run order, {kind: run ns on the path}, gap ns)."""
    import numpy as np

    from tpu_sparse_lu_torch.ops.elim_fused import KIND_MASK

    ready, done = c[:, 1], c[:, 2]
    t = int(np.argmax(done))
    path = [t]
    while True:
        task = int(tasks.ticket_task[t])
        deps = tasks.dep[tasks.dep_ptr[task]:tasks.dep_ptr[task + 1]]
        if len(deps) == 0:
            break
        t = int(deps[np.argmax(done[deps])])
        path.append(t)
    path.reverse()
    run = {k: 0 for k in KINDS}
    gap = 0
    for i, t in enumerate(path):
        kind = KINDS[tasks.task[tasks.ticket_task[t], 0] & KIND_MASK]
        run[kind] += int(done[t] - ready[t])
        if i:  # from the dependency done to this ticket running
            gap += int(ready[t] - done[path[i - 1]])
    return path, run, gap


def _clocks(res) -> None:
    import numpy as np
    import torch

    from tpu_sparse_lu_torch.ops import _build as B
    from tpu_sparse_lu_torch.ops import elim_fused as EF
    from tpu_sparse_lu_torch.ops.elimination import eliminate

    cs = _sweep.chip_smoke()
    inc = ["-I", str(SHIPPED.parent)]
    built = _sweep.build_side(
        [("shipped", SHIPPED.read_text()),
         ("clocks", "#define ELIM_FUSED_CLOCKS\n" + SHIPPED.read_text())],
        flags=inc)
    for name, (_, ptxas) in built.items():
        _sweep.print_ptxas(name, ptxas, "elim_fused")
    side = _Side(ctypes.CDLL(str(built["clocks"][0])))
    words = side.elim_fused_clock_words()
    out = {}
    for name, F, A in _deployments(cs):
        sched = F._refactor_dev.elim
        tasks = sched.tasks
        store, _ = cs._real_store(F, A)
        want = eliminate(store.clone(), sched)
        clocks = torch.zeros((tasks.n_tickets, words), dtype=torch.int64,
                             device="cuda")
        own, B._lib = B._lib, side
        try:
            EF._CAPACITY.clear()
            got = EF.elim_fused(store.clone(), tasks, clocks=clocks)
            torch.cuda.synchronize()
            # the same launch again at once, then after a 64 MB write
            # (more than L2): the first LU's time in each
            again = {}
            for label, flush in (("again", False), ("after a 64 MB write",
                                                    True)):
                if flush:
                    torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
                c2 = torch.zeros_like(clocks)
                EF.elim_fused(store.clone(), tasks, clocks=c2)
                torch.cuda.synchronize()
                again[label] = c2.cpu().numpy()
        finally:
            B._lib = own
            EF._CAPACITY.clear()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{name}: the clock build differs from the "
                             f"shipped one")
        c = clocks.cpu().numpy()
        grid = int(len(set(c[:, 5].tolist())))
        c0 = int(c[:, 0].min())
        span = int(c[:, 2].max() - c[:, 0].min())
        kinds = tasks.task[tasks.ticket_task, 0] & EF.KIND_MASK
        per = {}
        for k, label in enumerate(KINDS):
            sel = kinds == k
            per[label] = {
                "tickets": int(sel.sum()),
                "run_ns": int((c[sel, 2] - c[sel, 1]).sum()),
                "wait_ns": int((c[sel, 1] - c[sel, 0]).sum()),
                "run_cycles": int(c[sel, 4].sum()),
                "wait_cycles": int(c[sel, 3].sum())}
        busy = sum(p["run_ns"] for p in per.values()) / max(span * grid, 1)
        path, run, gap = _critical_path(tasks, c)
        lu_path = [int(c[t, 2] - c[t, 1]) for t in path
                   if kinds[t] == 0]
        lu_cycles = [int(c[t, 4]) for t in path if kinds[t] == 0]
        out[name] = {"span_ns": span, "sms": grid, "busy_share": busy,
                     "kinds": per, "path_tickets": len(path),
                     "path_run_ns": run, "path_gap_ns": gap,
                     "path_lu_ns": lu_path, "path_lu_cycles": lu_cycles,
                     "path": [[KINDS[kinds[t]], int(c[t, 0] - c0),
                               int(c[t, 1] - c0), int(c[t, 2] - c0),
                               int(c[t, 5])] for t in path]}
        print(f"[clocks] {name}: span {span / 1e3:.1f} us on {grid} SMs, "
              f"busy {100 * busy:.1f}%; " + "; ".join(
                  f"{k} {p['tickets']} tickets run {p['run_ns'] / 1e3:.1f} "
                  f"us wait {p['wait_ns'] / 1e3:.1f} us"
                  for k, p in per.items()), flush=True)
        print(f"[clocks] {name} critical path: {len(path)} tickets, "
              f"{len(lu_path)} LUs "
              f"{sum(lu_path) / 1e3:.1f} us (each "
              f"{min(lu_path) / 1e3:.1f}-{max(lu_path) / 1e3:.1f}), "
              + ", ".join(f"{k} {v / 1e3:.1f} us" for k, v in run.items()
                          if k != "lu")
              + f", gaps {gap / 1e3:.1f} us; the LUs in us (SM kcycles): "
              + ", ".join(f"{ns / 1e3:.1f} ({cy / 1e3:.0f})"
                          for ns, cy in zip(lu_path, lu_cycles)), flush=True)
        first = int(np.argmin(np.where(kinds == 0, c[:, 1], np.inf)))
        out[name]["first_lu_ns"] = {
            k: int(v[first, 2] - v[first, 1])
            for k, v in (("first", c), *again.items())}
        print(f"[clocks] {name} first LU of the launch: " + ", ".join(
            f"{k} {v / 1e3:.1f} us"
            for k, v in out[name]["first_lu_ns"].items()), flush=True)
    res["clocks"] = out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of another checkout; repeatable")
    parser.add_argument("--clocks", action="store_true",
                        help="per-ticket clocks of the one launch")
    parser.add_argument("--out", default=str(OUT),
                        help="the JSON file of everything printed")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        return _worker(args)
    import torch

    if not torch.cuda.is_available():
        print("elim_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = _sweep.smi()
    print(card, flush=True)
    trees = (_sweep.parse_pairs(args.tree) if args.tree
             else [("head", str(_sweep.ROOT))])
    res = {"card": card,
           "trees": _sweep.run_trees(Path(__file__).resolve(), trees, [])}
    if args.clocks:
        sys.path.insert(0, str(_sweep.ROOT))
        torch.backends.cuda.matmul.allow_tf32 = False
        _clocks(res)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
