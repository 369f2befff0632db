#!/usr/bin/env python3
"""Build versions of the tile LU kernel (B2) side by side and time them.

    python3 tools/lu_tile_sweep.py [--clocks] [NAME=PATH ...]

Needs one CUDA card and ``nvcc``. Each version is a copy of
``lu_tile.cu`` with the ``*.cuh`` headers it includes pasted in (the
kernel's body is ``lu_tile.cuh``): the shipped ``csrc/`` as ``shipped``,
and each ``NAME=PATH`` given, where ``PATH`` is a directory that holds
that version's ``lu_tile.cu`` and headers (a ``csrc/``, or a checkout
whose ``tpu_sparse_lu_torch/csrc/`` does, e.g. a ``git archive`` of an
older commit unpacked under the gitignored ``_trees/``) or a ``.cu`` file,
which takes the shipped headers. Every
version is built alone into a side library under
``tpu_sparse_lu_torch/_build/sweep/`` (one ``nvcc -Xptxas -v`` each, all
started together); the script prints the registers, stack and spills of
its ``lu_tile_kernel`` instantiations and their SASS instruction counts
(``cuobjdump -sass``). Then, through the ``lu_tile`` wrapper pointed at
each library in turn, it holds each version against ``lu_tile_plain``
(``chip_smoke.LU_TOL``, seeded tiles at ``chip_smoke.LU_SIZES``, float32
and float64, with and without the inverses) and holds its factor, pivots,
L^-1 and U^-1 bit for bit to the first version's (one line a version) on
those tiles, on ``chip_smoke._special_tiles`` (mostly zero columns with
-0.0 entries, zero and NaN pivots) at the same sizes, and on the shapes
timed below, each with and without the inverses; the script exits 1 if
any differ. It times each version by CUDA-graph
replay (``chip_smoke._lu_tile_ms``) on the headline's 23 level-0 tiles
and on config 2's one-tile level 0, float32 and float64, with both
inverses and the LU alone. The versions are timed in turns, forwards then
backwards, and both readings are printed. ``--clocks`` adds each version
built with ``-DLU_TILE_CLOCKS`` and prints, for block 0 of one launch with
both inverses at each of those shapes, the SM cycles of each phase of the
kernel (load, diagonal blocks, panel solves, trailing updates,
write-back and pivot, the inverses' diagonal blocks, their off-diagonal
fill and write-out; a version with another count of phases is printed by
phase number).
"""

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHIPPED = ROOT / "tpu_sparse_lu_torch" / "csrc" / "lu_tile.cu"
OUT = ROOT / "tpu_sparse_lu_torch" / "_build" / "sweep"
# the initializer of the clock build's per-phase sums: one 0 a phase
_CLOCK_SUMS = re.compile(r"clk_\[\w+\] = \{([^}]*)\}")


CLOCK_PHASES = ("load", "diagonal blocks", "panel solves", "trailing updates",
                "write-back and pivot", "inverse diagonal blocks",
                "inverse off-diagonal fill and write-out")


def _phase_labels(text):
    """The clock build's phase labels of a version's source."""
    n = len(_CLOCK_SUMS.search(text).group(1).split(","))
    return (CLOCK_PHASES if n == len(CLOCK_PHASES)
            else tuple(f"phase {p}" for p in range(n)))


_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"$', re.M)


def _inlined(src):
    """The source ``src`` with the ``*.cuh`` headers it includes pasted
    in, so that a copy builds alone: a ``lu_tile.cu`` takes the headers
    beside it, any other ``.cu`` file the shipped ones."""
    hdrs = src.parent if src.name == SHIPPED.name else SHIPPED.parent
    return _INCLUDE.sub(
        lambda m: (hdrs / m.group(1)).read_text()
        .replace("#pragma once\n", ""), src.read_text())


def _source(path):
    """A version's ``lu_tile.cu``: ``path`` itself, or in the directory
    ``path`` or its ``tpu_sparse_lu_torch/csrc/``."""
    path = Path(path)
    if path.is_dir():
        for d in (path, path / "tpu_sparse_lu_torch" / "csrc"):
            if (d / SHIPPED.name).is_file():
                return d / SHIPPED.name
        raise SystemExit(f"no {SHIPPED.name} in {path} or its "
                         f"tpu_sparse_lu_torch/csrc/")
    return path


def _versions(args):
    """[(name, source text, extra nvcc flags)], the shipped source
    first."""
    srcs = [("shipped", _inlined(SHIPPED), [])]
    for a in args.sources:
        name, _, path = a.partition("=")
        if not path:
            raise SystemExit(f"expected NAME=PATH, got {a!r}")
        srcs.append((name, _inlined(_source(path)), []))
    if args.clocks:
        srcs += [(f"{name}_clocks", text, ["-DLU_TILE_CLOCKS"])
                 for name, text, _ in srcs]
    return srcs


def _build(versions):
    """Compile every version in parallel; returns {name: (so, ptxas)}."""
    from tpu_sparse_lu_torch.ops import _build as B

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = B._nvcc()
    jobs = {}
    for name, text, flags in versions:
        h = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:12]
        src = OUT / f"{name}_{h}.cu"
        so = OUT / f"{name}_{h}.so"
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


def _static_facts(name, so, ptxas):
    """Print registers, stack and spills (``ptxas -v``) and the SASS
    instruction count (``cuobjdump -sass``) of each lu_tile_kernel."""
    from tpu_sparse_lu_torch.ops import _build as B

    facts, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and "lu_tile_kernel" in cur:
            kind = "f32" if "IfE" in cur else "f64"
            if "stack frame" in line or "Used" in line:
                facts.setdefault(kind, []).append(line.strip())
    cuobjdump = Path(B._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    count, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "lu_tile_kernel" in fn and re.match(
                r"\s+/\*[0-9a-f]{4,}\*/", line):
            kind = "f32" if "IfE" in fn else "f64"
            count[kind] = count.get(kind, 0) + 1
    for kind in ("f32", "f64"):
        print(f"{name} lu_tile_kernel<{kind}>: "
              + " | ".join(facts.get(kind, ["no ptxas line"]))
              + f" | SASS instructions {count.get(kind, 0)}")


def _bind(so):
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        f = getattr(lib, f"lu_tile_{dt}")
        f.argtypes = [P, P, I, P, P, P, I, P]
        f.restype = I
    lib.max_chunk = 128
    return lib


def _outputs(name, cases):
    """Every output of ``lu_tile`` through the wrapper's current library,
    by label: seeded tiles (each held against ``lu_tile_plain``), the
    special tiles, and ``cases``' shapes, each with both inverses and the
    LU alone. The seeds are the same for every version."""
    import numpy as np
    import torch

    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile

    def run(tiles, ids, inverses):
        t = tiles.clone()
        nb, cs = ids.shape[0], t.shape[1]
        inv = ({k: torch.zeros((nb, cs, cs), dtype=t.dtype, device="cuda")
                for k in ("linv", "uinv")} if inverses else {})
        p = lu_tile(t, ids, **inv)
        return [t[ids.long()], p, *inv.values()]

    rng = np.random.default_rng(14)
    outs, worst = {}, {}
    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        for cs in chip_smoke.LU_SIZES:
            got = []
            for g, ref in chip_smoke._lu_tile_pairs(rng, tdt, cs):
                r = chip_smoke._rel(g, ref)
                if not r <= chip_smoke.LU_TOL[dt]:
                    raise AssertionError(f"{name}: lu_tile differs from "
                                         f"plain {r:.3e} ({dt}, cs={cs})")
                worst[dt] = max(worst.get(dt, 0.0), r)
                got.append(g)
            outs[f"{dt} cs={cs} dominant"] = got
            for kind, tiles in chip_smoke._special_tiles(rng, tdt,
                                                         cs).items():
                ids = torch.arange(tiles.shape[0], dtype=torch.int32,
                                   device="cuda")
                for inverses in (True, False):
                    outs[f"{dt} cs={cs} {kind} inverses={inverses}"] = run(
                        tiles, ids, inverses)
    for label, store, diag, inverses in cases:
        outs[label] = run(store, diag, inverses)
    torch.cuda.synchronize()
    print(f"{name} vs lu_tile_plain: max rel diff f32 {worst['float32']:.3e}"
          f" f64 {worst['float64']:.3e} (bounds "
          f"{chip_smoke.LU_TOL['float32']:g}/{chip_smoke.LU_TOL['float64']:g}"
          f"; cs in {list(chip_smoke.LU_SIZES)}, with and without inverses)")
    return outs


def _same_bits(name, outs, first, first_outs):
    """Print whether ``outs`` equal ``first_outs`` bit for bit; returns
    True if they do."""
    import torch

    what = ("factor", "pivots", "L^-1", "U^-1")
    bad = []
    for label, ts in outs.items():
        for w, a, b in zip(what, ts, first_outs[label]):
            ia = a.view(torch.int32 if a.element_size() == 4 else torch.int64)
            ib = b.view(ia.dtype)
            n = int((ia != ib).sum())
            if n:
                both_nan = bool((a.isnan() & b.isnan())[ia != ib].all())
                bad.append(f"{label} {w}: {n} elements"
                           + (" (NaN payloads only)" if both_nan else ""))
    n_out = sum(len(ts) for ts in outs.values())
    if bad:
        print(f"{name}: DIFFERS from {first} bit for bit in "
              f"{len(bad)} of {n_out} outputs: " + "; ".join(bad[:12]))
    else:
        print(f"{name}: factor, pivots, L^-1 and U^-1 bit for bit equal to "
              f"{first}'s in all {n_out} outputs ({len(outs)} launches: "
              f"cs in {list(chip_smoke.LU_SIZES)} dominant and "
              f"{'/'.join(chip_smoke.SPECIAL_TILES)}, the timed shapes; "
              f"float32 and float64; with and without inverses)")
    return not bad


def _clocks(name, labels, cases):
    """Cycles of each phase of block 0, one launch with both inverses at
    each shape, through the wrapper's current library."""
    import torch

    from tpu_sparse_lu_torch.ops.lu_tile import lu_tile

    clock = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for label, store, diag, inverses in cases:
        if not inverses:
            continue
        nb, cs = diag.shape[0], store.shape[1]
        inv = {k: torch.empty((nb, cs, cs), dtype=store.dtype, device="cuda")
               for k in ("linv", "uinv")}
        for _ in range(3):  # the last of three launches
            lu_tile(store.clone(), diag, **inv)
        torch.cuda.synchronize()
        cyc = inv["uinv"][0].flatten()[:len(labels)].tolist()
        print(f"{name} {label}, block 0, SM cycles (clocks.sm, "
              f"clocks.max.sm: {clock}): " + ", ".join(
                  f"{p} {int(c)}" for p, c in zip(labels, cyc))
              + f"; sum {int(sum(cyc))}")


def main() -> int:
    import argparse

    import torch

    from tpu_sparse_lu_torch.ops import lu_tile as LT

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--clocks", action="store_true",
                        help="add each version built with -DLU_TILE_CLOCKS "
                             "and print its phase cycles")
    parser.add_argument("sources", nargs="*",
                        help="NAME=PATH: a directory with lu_tile.cu and "
                             "its headers, or a .cu file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("lu_tile_sweep: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    versions = _versions(args)
    built = _build(versions)
    for name, *_ in versions:
        _static_facts(name, *built[name])
    libs = {name: _bind(built[name][0]) for name, *_ in versions}
    clocked = [(name, _phase_labels(text)) for name, text, flags in versions
               if flags]
    timed = [name for name, _, flags in versions if not flags]

    # the shapes: the headline's level 0 (23 tiles), config 2's (1 tile)
    cases = []
    for dt in ("float32", "float64"):
        A, F = chip_smoke._device_headline(dt)
        A2, F2 = chip_smoke._config2_solver(dt)
        F2.enable_device_refactor()
        for tag, Fx, Ax in (("headline", F, A), ("config2", F2, A2)):
            store, _ = chip_smoke._real_store(Fx, Ax, plain=True)
            diag = Fx._refactor_dev.elim.levels[0].diag
            for inverses in (True, False):
                cases.append((f"{tag} {dt} {diag.shape[0]} tiles "
                              + ("LU + inverses" if inverses
                                 else "LU alone"), store, diag, inverses))
    own = LT.lib
    times = {name: {c[0]: [] for c in cases} for name in timed}
    same = True
    try:
        first = None
        for name in timed:
            LT.lib = lambda L=libs[name]: L
            outs = _outputs(name, cases)
            if first is None:
                first, first_outs = name, outs
            else:
                same &= _same_bits(name, outs, first, first_outs)
            del outs
        for name, labels in clocked:
            LT.lib = lambda L=libs[name]: L
            _clocks(name, labels, cases)
        for turn in (timed, timed[::-1]):
            for name in turn:
                LT.lib = lambda L=libs[name]: L
                for label, store, diag, inverses in cases:
                    times[name][label].append(
                        chip_smoke._lu_tile_ms(store, diag, inverses))
    finally:
        LT.lib = own
    print(f"lu_tile device time by CUDA-graph replay on {smi}, ms "
          f"(forwards, backwards):")
    for name in timed:
        print(f"{name}: " + "; ".join(
            f"{label} {t[0]:.4f}, {t[1]:.4f}"
            for label, t in times[name].items()))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
