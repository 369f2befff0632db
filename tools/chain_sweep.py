#!/usr/bin/env python3
"""Time the chain kernel (B5, ``bidiag_ldiv``) on one CUDA card, tree by
tree and version by version.

    python3 tools/chain_sweep.py [--tree NAME=PATH ...] [NAME=PATH.cu ...]

Needs one CUDA card and ``nvcc``. Cells: BASELINE config 1's ``ldiv``
(``chip_smoke._config1_solver``: ``laplacian_1d(20000)``, natural,
``pivot_threshold=0.0``, chunk_size=128, float32) at R = 1 and 16, and
``bidiag_ldiv`` on seeded random planes at n = 1,048,577, R = 1 and 16,
float32 and float64, both sweeps. Each cell is timed eager
(``chip_smoke._median_ms``: CUDA events around each call, host included)
and by CUDA-graph replay (``chip_smoke._graph_ms``: device time); eager
minus replay is the wrapper's host cost.

``--tree NAME=PATH`` times another checkout (``PATH`` holds
``tpu_sparse_lu_torch/``, e.g. a ``git archive`` of an older commit
unpacked under the gitignored ``_trees/``), each in a process of its own
that imports and builds that checkout's package; trees run in the order
given (a name may repeat, for turns). Without ``--tree`` this checkout
runs.

``NAME=PATH.cu`` adds versions of ``csrc/bidiag.cu`` with this
checkout's C interface: each is built alone into a side library (one
``nvcc -Xptxas -v`` each, all started together; registers, shared memory
and spills printed), held to the checks of ``chip_smoke.py`` phase 10
(``chip_smoke._bidiag_checks``: against the plain version, bit for bit at
grids 1, 7 and the default and under graph replays), and timed through
the ``bidiag_ldiv`` wrapper pointed at it, in turns with the shipped
source, forwards then backwards.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _sweep  # noqa: E402

SHIPPED = _sweep.ROOT / "tpu_sparse_lu_torch" / "csrc" / "bidiag.cu"
BIG_N = 1_048_577


def _cells(cs, rng):
    """[(label, fn)] of every timed cell, on this process's package."""
    import torch

    from tpu_sparse_lu_torch.ops.bidiag_ldiv import bidiag_ldiv

    _, F1 = cs._config1_solver()
    cells = []
    for R in (1, 16):
        b = torch.as_tensor(rng.random((F1.n, R)), dtype=torch.float32,
                            device="cuda")
        cells.append((f"config1 f32 R={R}",
                      lambda b=b: F1._chain_solve(b)))
    for dt in (torch.float32, torch.float64):
        lower, upper = cs._random_planes(rng, BIG_N, dt)
        for R in (1, 16):
            b = torch.as_tensor(rng.random((BIG_N, R)), dtype=dt,
                                device="cuda")
            cells.append((f"n={BIG_N} {str(dt)[6:]} R={R}",
                          lambda b=b, lo=lower, up=upper:
                          bidiag_ldiv(b, lower=lo, upper=up)))
    return cells


def _time(cs, fn):
    """(eager ms, graph-replay ms)."""
    return (cs._median_ms(lambda _: fn(), reps=30),
            cs._graph_ms(fn, reps=30))


def _worker(args) -> int:
    sys.path.insert(0, args.root)
    cs = _sweep.chip_smoke()
    import numpy as np

    from tpu_sparse_lu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    card = _sweep.smi()
    res = {"tree": args.worker, "card": card, "build_s": build_s, "cells": {}}
    for label, fn in _cells(cs, np.random.default_rng(16)):
        e, g = _time(cs, fn)
        res["cells"][label] = {"eager_ms": e, "graph_ms": g}
        print(f"[{args.worker}] {label}: eager {e:.4f} ms, graph replay "
              f"{g:.4f} ms, host {e - g:+.4f} ms", flush=True)
    print(json.dumps(res))
    return 0


class _Side:
    """The kernel library with its ``bidiag_ldiv*`` entries taken from a
    side library."""

    def __init__(self, side):
        from tpu_sparse_lu_torch.ops import _build as B

        self.side, self.main = B.bind_bidiag(side), B.load()

    def __getattr__(self, name):
        lib = self.side if name.startswith("bidiag_ldiv") else self.main
        return getattr(lib, name)


def _versions(sources) -> int:
    import ctypes

    import numpy as np

    from tpu_sparse_lu_torch.ops import bidiag_ldiv as BL

    cs = _sweep.chip_smoke()
    versions = [("shipped", SHIPPED.read_text())] + [
        (n, Path(p).read_text()) for n, p in _sweep.parse_pairs(sources)]
    built = _sweep.build_side(versions)
    for name, (_, ptxas) in built.items():
        _sweep.print_ptxas(name, ptxas, "bidiag")
    sides = {n: _Side(ctypes.CDLL(str(so))) for n, (so, _) in built.items()}
    own = BL._lib

    def use(name):
        BL._lib = lambda L=sides[name]: L
        BL._reset_cache()

    names = [n for n, _ in versions]
    times = {n: {} for n in names}
    try:
        for name in names:
            use(name)
            print(f"[versions] {name}: {cs._bidiag_checks(quick=True)}",
                  flush=True)
        cells = None
        for turn in (names, names[::-1]):
            for name in turn:
                use(name)
                if cells is None:
                    cells = _cells(cs, np.random.default_rng(16))
                for label, fn in cells:
                    times[name].setdefault(label, []).append(_time(cs, fn))
    finally:
        BL._lib = own
        BL._reset_cache()
    print(f"bidiag_ldiv versions on {_sweep.smi()}, ms eager / graph replay "
          f"(forwards, backwards):")
    for name in names:
        print(f"{name}: " + "; ".join(
            f"{label} " + ", ".join(f"{e:.4f} / {g:.4f}" for e, g in t)
            for label, t in times[name].items()), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of another checkout; repeatable")
    parser.add_argument("sources", nargs="*",
                        help="NAME=PATH.cu versions of csrc/bidiag.cu")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        return _worker(args)
    import torch

    if not torch.cuda.is_available():
        print("chain_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(_sweep.smi(), flush=True)
    trees = _sweep.parse_pairs(args.tree) if args.tree else (
        [] if args.sources else [("head", str(_sweep.ROOT))])
    _sweep.run_trees(Path(__file__).resolve(), trees, [])
    if args.sources:
        sys.path.insert(0, str(_sweep.ROOT))
        return _versions(args.sources)
    return 0


if __name__ == "__main__":
    sys.exit(main())
