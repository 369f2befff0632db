#!/usr/bin/env python3
"""Time the solve banks' extraction of the device refactorization on one
CUDA card: the one launch (``ops/extract.py`` ``extract_banks``,
``csrc/extract.cu``) beside its bound and its plain twin, tree by tree.

    python3 tools/extract_sweep.py [--tree NAME=PATH ...] [--dtype D ...]

Needs one CUDA card and ``nvcc``. On the benchmark's two refactor
deployments, ``poisson2d_100`` (BASELINE config 4: 2D Poisson 100x100,
nd, ``chunk_size=128``, host factorization, ``chip_smoke._headline_solver``)
and ``banded_120x30`` (config 2, ``chip_smoke._config2_solver``), it
takes ``elim_fused``'s output on a seeded same-pattern change and times,
by CUDA-graph replay (``chip_smoke._graph_ms``: device time) and eager
(``chip_smoke._median_ms``: CUDA events around each call):

* ``extract_banks`` alone, and its plain twin ``extract_banks_plain``
  (the PyTorch ops ``refactor_pipeline`` ran before the kernel), each
  checked bit for bit against the other first;
* the wrapper's host time a call (``time.perf_counter`` over 200 calls
  queued without a synchronise);
* the whole ``refactor_pipeline``, less the elimination and the assembly
  (each by replay): the extraction as the pipeline runs it.

The bound is bytes over 3.35 TB/s: every tile the extraction reads (K
diagonal, TL + TU off-diagonal, 2K inverse) and writes (2(K+1) diagonal,
2K + TL + TU + 4 bank) once. ``ptxas -v`` of ``csrc/extract.cu`` is
printed first (registers, stack, spills).

``--tree NAME=PATH`` times another checkout (e.g. a ``git archive`` of an
older commit under the gitignored ``_trees/``), each in a process of its
own that imports that checkout's package; a tree without
``ops/extract.py`` reports the pipeline's extraction only. Without
``--tree`` this checkout runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _sweep  # noqa: E402

SHIPPED = _sweep.ROOT / "tpu_sparse_lu_torch" / "csrc" / "extract.cu"


def _deployments(cs, dt):
    out = []
    for name, make in (("poisson2d_100", cs._headline_solver),
                       ("banded_120x30", cs._config2_solver)):
        A, F = make(dt)
        F.enable_device_refactor()
        out.append((name, F, A))
    return out


def _bound_us(cs, dev, F):
    K = dev.diag_src.numel()
    TL, TU = dev.l_off_src.numel(), dev.u_off_src.numel()
    tile = dev.cs * dev.cs * F.dtype.itemsize
    tiles = (K + TL + TU + 2 * K) + (2 * (K + 1) + 2 * K + TL + TU + 4)
    return tiles * tile / cs.HBM_BYTES_PER_S * 1e6, tiles * tile


def _worker(args) -> int:
    sys.path.insert(0, args.root)
    cs = _sweep.chip_smoke()
    import numpy as np
    import torch

    from tpu_sparse_lu_torch.assemble import assemble
    from tpu_sparse_lu_torch.ops import _build
    from tpu_sparse_lu_torch.ops.elimination import eliminate
    from tpu_sparse_lu_torch.refactor import refactor_pipeline

    try:
        from tpu_sparse_lu_torch.ops import extract as X
    except ImportError:
        X = None
    _build.load()
    res = {"tree": args.worker, "card": _sweep.smi(), "cells": {}}
    for dt in args.dtype:
        for name, F, A in _deployments(cs, dt):
            dev = F._refactor_dev
            A2 = cs._same_pattern(np.random.default_rng(23), A)
            a = torch.as_tensor(A2.tocsc().data, dtype=F.dtype,
                                device="cuda")
            store, _ = cs._real_store(F, A2)
            work = store.clone()
            elim = eliminate(work, dev.elim)
            c = {}
            if X is not None:
                maps = (dev.diag_src, dev.l_off_src, dev.u_off_src,
                        dev.diag_lvlslot)
                args_ = (elim[0], elim[2], elim[3], *maps)
                got = X.extract_banks(*args_)
                want = X.extract_banks_plain(*args_)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got[:4],
                                                             want[:4]))
                same &= bool(torch.equal(got[4], want[4])
                             or (got[4].isnan() & want[4].isnan()))
                if not same:
                    raise SystemExit(f"{name} {dt}: extract_banks differs "
                                     f"from its plain twin")
                for key, fn in (("kernel", X.extract_banks),
                                ("plain", X.extract_banks_plain)):
                    c[f"{key}_graph_ms"] = cs._graph_ms(lambda: fn(*args_))
                    c[f"{key}_eager_ms"] = cs._median_ms(
                        lambda _: fn(*args_), reps=50)
                    for _ in range(5):
                        fn(*args_)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(200):
                        fn(*args_)
                    c[f"{key}_host_us"] = (time.perf_counter() - t0) / 200 \
                        * 1e6
                    torch.cuda.synchronize()
                c["bound_us"], c["bytes"] = _bound_us(cs, dev, F)
                c["kernel_share_of_bound"] = (c["bound_us"] / 1e3
                                              / c["kernel_graph_ms"])
            asm = cs._graph_ms(lambda: assemble(
                a, dev.asm, n=dev.n, cs=dev.cs, TF=dev.TF, TF2=dev.TF2))
            el = cs._graph_ms(lambda: eliminate(work, dev.elim),
                              setup=lambda: work.copy_(store), reps=20)
            pipe = cs._graph_ms(lambda: refactor_pipeline(a, dev), reps=20)
            c.update(assembly_graph_ms=asm, elimination_graph_ms=el,
                     pipeline_graph_ms=pipe,
                     extraction_in_pipeline_ms=pipe - el - asm)
            res["cells"][f"{name}.{dt}"] = c
            print(f"[{args.worker}] {name} {dt}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in c.items()), flush=True)
    print(json.dumps(res))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of another checkout; repeatable")
    parser.add_argument("--dtype", action="append", default=None,
                        choices=("float32", "float64"),
                        help="float32 (default) and/or float64")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    args.dtype = args.dtype or ["float32"]
    if args.worker is not None:
        return _worker(args)
    import torch

    if not torch.cuda.is_available():
        print("extract_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(_sweep.smi(), flush=True)
    sys.path.insert(0, str(_sweep.ROOT))
    built = _sweep.build_side([("shipped", SHIPPED.read_text())])
    for name, (_, ptxas) in built.items():
        _sweep.print_ptxas(name, ptxas, "extract_banks")
    trees = _sweep.parse_pairs(args.tree) or [("head", str(_sweep.ROOT))]
    extra = [a for d in args.dtype for a in ("--dtype", d)]
    _sweep.run_trees(Path(__file__).resolve(), trees, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
