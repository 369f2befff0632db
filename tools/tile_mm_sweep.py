#!/usr/bin/env python3
"""Time each tile-product launch of one elimination at every sub-tile shape.

    python3 tools/tile_mm_sweep.py

Needs one CUDA card. For the headline deployment (2D Poisson 100x100, nd,
chunk_size 128) and BASELINE config 2 (``block_banded(rng, 120, 30)``),
float32, every ``tile_mm`` launch of one elimination is timed alone by
CUDA-graph replay (``chip_smoke._graph_ms``): the kernel at the
wrapper's own pick (``pick_tile``), the kernel at every sub-tile shape
its in-place rule allows, and ``torch.bmm`` on the same products
(operands gathered outside the graph; TF32 off). Prints one line per
headline launch, one per launch kind of config 2, and the sums; before
them, each deployment's device time by kernel (``torch.profiler``) for
all its launches, kernel and ``bmm``, beside their graph replay.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _launches(dev, store, linv, uinv):
    """(level, kind, groups, a bank, b bank, side, subtract) per launch."""
    for l, lvl in enumerate(dev.elim.levels):
        for kind, g, a, b, side, sub in (
                ("rows", lvl.rows, store, uinv, "row", False),
                ("cols", lvl.cols, linv, store, "col", False),
                ("schur", lvl.schur, store, store, "row", True)):
            if g is not None:
                yield l, kind, g, a, b, side, sub


def _sweep(name, A, F):
    import torch

    from tpu_sparse_lu_torch.ops import elimination as E

    dev = F._refactor_dev
    cs = dev.cs
    store, _ = chip_smoke._real_store(F, A, plain=True)
    _, _, linv, uinv = E.eliminate(store.clone(), dev.elim)
    linv, uinv = (x.reshape(-1, cs, cs) for x in (linv, uinv))
    work = store.clone()
    pick, n_sm = E.pick_tile, E._sm_count(0)
    rows = []
    for l, kind, g, a, b, side, sub in _launches(dev, work, linv, uinv):
        owner = None if kind == "schur" else kind
        xa, yb = a[g.a_idx.long()], b[g.b_idx.long()]
        prod = torch.empty_like(xa)
        t_bmm = chip_smoke._graph_ms(lambda: torch.bmm(xa, yb, out=prod))
        times = {}
        try:
            for shape in E.TILE_SHAPES[owner]:
                E.pick_tile = lambda *_, s=shape: s
                times[shape] = chip_smoke._graph_ms(
                    lambda: E.tile_mm(work, a, b, g, side=side,
                                      subtract=sub),
                    setup=lambda: work.copy_(store))
        finally:
            E.pick_tile = pick
        auto = pick(g.dst.shape[0], cs, owner, n_sm)
        rows.append((l, kind, g.dst.shape[0], xa.shape[0], auto, times,
                     t_bmm))
    fmt = "{}x{}".format
    if name == "headline":
        for l, kind, n, p, auto, times, t_bmm in rows:
            print(f"{name} L{l} {kind} groups={n} products={p} pick="
                  f"{fmt(*auto)} {times[auto]:.4f} ms; "
                  + " ".join(f"{fmt(*s)} {t:.4f}" for s, t in times.items())
                  + f"; bmm {t_bmm:.4f} ms")
    else:
        for kind in ("rows", "cols", "schur"):
            mine = [r for r in rows if r[1] == kind]
            print(f"{name} {kind}: {len(mine)} launches, pick "
                  f"{sum(r[5][r[4]] for r in mine):.4f} ms, best shape each "
                  f"{sum(min(r[5].values()) for r in mine):.4f} ms, bmm "
                  f"{sum(r[6] for r in mine):.4f} ms")
    print(f"{name} sum over {len(rows)} launches (each alone): pick "
          f"{sum(r[5][r[4]] for r in rows):.4f} ms, best shape each "
          f"{sum(min(r[5].values()) for r in rows):.4f} ms, bmm "
          f"{sum(r[6] for r in rows):.4f} ms")


def _profile(name, A, F):
    """Device time by kernel (``torch.profiler``) of every tile product of
    one elimination, eager, through the kernel and through ``torch.bmm``,
    beside the CUDA-graph replay of the same launches: the difference is
    the device's idle time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_sparse_lu_torch.ops import elimination as E

    dev = F._refactor_dev
    cs = dev.cs
    store, _ = chip_smoke._real_store(F, A, plain=True)
    _, _, linv, uinv = E.eliminate(store.clone(), dev.elim)
    linv, uinv = (x.reshape(-1, cs, cs) for x in (linv, uinv))
    work = store.clone()
    ops = [(a[g.a_idx.long()], b[g.b_idx.long()])
           for _, _, g, a, b, _, _ in _launches(dev, work, linv, uinv)]
    prods = [torch.empty_like(x) for x, _ in ops]

    def kernel():
        chip_smoke._elim_products(work, linv, uinv, dev.elim, E.tile_mm)

    def bmm():
        for (x, y), p in zip(ops, prods):
            torch.bmm(x, y, out=p)

    reps = 5
    for what, fn in (("tile_mm", kernel), ("bmm", bmm)):
        graph_ms = chip_smoke._graph_ms(fn)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count // reps, e.device_time_total / reps / 1e3)
                for e in prof.key_averages() if e.device_time_total > 0]
        busy = sum(t for _, _, t in rows)
        print(f"{name} {what}: graph replay {graph_ms:.4f} ms, kernels "
              f"busy {busy:.4f} ms (idle share {1 - busy / graph_ms:.2f}); "
              + "; ".join(f"{k[:60]} x{c} {t:.4f} ms ({t / c * 1e3:.1f} "
                          f"us each)" for k, c, t in rows))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_mm_sweep: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    A, F = chip_smoke._device_headline("float32")
    _profile("headline", A, F)
    _sweep("headline", A, F)
    A, F = chip_smoke._config2_solver()
    F.enable_device_refactor()
    _profile("config2", A, F)
    _sweep("config2", A, F)
    return 0


if __name__ == "__main__":
    sys.exit(main())
