#!/usr/bin/env python3
"""Split the device refactorization's time on one CUDA card: assembly
(B4), elimination, extraction; tree by tree and version by version.

    python3 tools/assemble_sweep.py [--tree NAME=PATH ...] [NAME=PATH.cu ...]

Needs one CUDA card and ``nvcc``. On the headline deployment
(``chip_smoke._device_headline``) and BASELINE config 2
(``chip_smoke._config2_solver``), float32, it times by CUDA-graph replay
(``chip_smoke._graph_ms``) and eager (``chip_smoke._median_ms``):

* ``assemble(...)`` alone, the solver's own route (and, where the tree
  has it, the yardstick route: ``span_gather`` plus the PyTorch ops);
* ``eliminate`` alone on the assembled store (put back before each
  replay);
* the whole ``refactor_pipeline``;

and prints the extraction as the pipeline less the elimination less the
assembly (graph replay).

``--tree NAME=PATH`` times another checkout (e.g. a ``git archive`` of an
older commit under the gitignored ``_trees/``), each in a process of its
own that imports that checkout's package. ``NAME=PATH.cu`` adds versions
of ``csrc/assemble.cu`` with this checkout's C interface: each built
alone into a side library (``ptxas -v`` printed), held bit for bit to the
yardstick route (``chip_smoke._assembly_checks``) and timed by replay in
turns with the shipped source, forwards then backwards.
"""

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _sweep  # noqa: E402

SHIPPED = _sweep.ROOT / "tpu_sparse_lu_torch" / "csrc" / "assemble.cu"


def _deployments(cs):
    A, F = cs._device_headline("float32")
    A2, F2 = cs._config2_solver()
    F2.enable_device_refactor()
    return (("headline", F, A), ("config2", F2, A2))


def _assembly_fn(F, A, **kw):
    import torch

    from tpu_sparse_lu_torch.assemble import assemble

    dev = F._refactor_dev
    a = torch.as_tensor(A.data, dtype=torch.float32, device="cuda")
    return lambda: assemble(a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF,
                            TF2=dev.TF2, **kw)


def _worker(args) -> int:
    sys.path.insert(0, args.root)
    cs = _sweep.chip_smoke()
    import torch

    from tpu_sparse_lu_torch.assemble import assemble
    from tpu_sparse_lu_torch.ops import _build
    from tpu_sparse_lu_torch.ops.elimination import eliminate
    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    t0 = time.perf_counter()
    _build.load()
    res = {"tree": args.worker, "card": _sweep.smi(),
           "build_s": time.perf_counter() - t0, "cells": {}}
    yard = "yardstick" in inspect.signature(assemble).parameters
    for name, F, A in _deployments(cs):
        dev = F._refactor_dev
        a = torch.as_tensor(A.data, dtype=torch.float32, device="cuda")
        c = {}
        routes = {"assembly": _assembly_fn(F, A)}
        if yard:
            routes["assembly_yardstick"] = _assembly_fn(F, A, yardstick=True)
        for key, fn in routes.items():
            c[key + "_graph_ms"] = cs._graph_ms(fn)
            c[key + "_eager_ms"] = cs._median_ms(lambda _: fn(), reps=30)
        store, _ = routes["assembly"]()
        work = store.clone()
        c["elimination_graph_ms"] = cs._graph_ms(
            lambda: eliminate(work, dev.elim),
            setup=lambda: work.copy_(store), reps=20)
        c["pipeline_graph_ms"] = cs._graph_ms(
            lambda: refactor_pipeline(a, dev), reps=20)
        c["pipeline_eager_ms"] = cs._median_ms(
            lambda _: refactor_pipeline(a, dev), reps=20, warmup=2)
        c["extraction_graph_ms"] = (c["pipeline_graph_ms"]
                                    - c["elimination_graph_ms"]
                                    - c["assembly_graph_ms"])
        res["cells"][name] = c
        print(f"[{args.worker}] {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in c.items()), flush=True)
    print(json.dumps(res))
    return 0


class _Side:
    """The kernel library with its ``assemble_*`` entries taken from a
    side library."""

    def __init__(self, side):
        from tpu_sparse_lu_torch.ops import _build as B

        self.side, self.main = B.bind_assembly(side), B.load()

    def __getattr__(self, name):
        lib = self.side if name.startswith("assemble_") else self.main
        return getattr(lib, name)


def _versions(sources) -> int:
    import ctypes

    from tpu_sparse_lu_torch.ops import assembly as AS

    cs = _sweep.chip_smoke()
    versions = [("shipped", SHIPPED.read_text())] + [
        (n, Path(p).read_text()) for n, p in _sweep.parse_pairs(sources)]
    built = _sweep.build_side(versions)
    for name, (_, ptxas) in built.items():
        _sweep.print_ptxas(name, ptxas, "assemble")
    sides = {n: _Side(ctypes.CDLL(str(so))) for n, (so, _) in built.items()}
    own = AS._lib
    names = [n for n, _ in versions]
    times = {n: {} for n in names}
    try:
        deps = None
        for name in names:
            AS._lib = lambda L=sides[name]: L
            AS._reset_cache()
            print(f"[versions] {name}: {cs._assembly_checks(quick=True)}",
                  flush=True)
        deps = _deployments(cs)
        for turn in (names, names[::-1]):
            for name in turn:
                AS._lib = lambda L=sides[name]: L
                AS._reset_cache()
                for label, F, A in deps:
                    times[name].setdefault(label, []).append(
                        cs._graph_ms(_assembly_fn(F, A)))
    finally:
        AS._lib = own
        AS._reset_cache()
    print(f"assembly versions on {_sweep.smi()}, ms by graph replay "
          f"(forwards, backwards):")
    for name in names:
        print(f"{name}: " + "; ".join(
            f"{label} " + ", ".join(f"{g:.4f}" for g in t)
            for label, t in times[name].items()), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of another checkout; repeatable")
    parser.add_argument("sources", nargs="*",
                        help="NAME=PATH.cu versions of csrc/assemble.cu")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        return _worker(args)
    import torch

    if not torch.cuda.is_available():
        print("assemble_sweep: CUDA is not available", file=sys.stderr)
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
