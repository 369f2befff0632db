"""Plumbing shared by ``tools/chain_sweep.py``,
``tools/assemble_sweep.py`` and ``tools/elim_sweep.py``: this checkout's
``chip_smoke.py`` loaded by path, the card's name, side libraries built
from versions of one source (with ``ptxas -v``), and the runs of other
checkouts, each in a process of its own.
"""

import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIDE = ROOT / "tpu_sparse_lu_torch" / "_build" / "sweep"


def chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path, so that a tree's
    own package stays first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def parse_pairs(items, what="NAME=PATH"):
    out = []
    for a in items:
        name, _, path = a.partition("=")
        if not path:
            raise SystemExit(f"expected {what}, got {a!r}")
        out.append((name, path))
    return out


def build_side(versions, flags=()):
    """Compile each ``(name, source text)`` alone into a side library, all
    ``nvcc -Xptxas -v`` started together (with ``flags`` added, e.g. the
    ``-I`` of the headers a source includes); returns {name: (so,
    ptxas)}."""
    from tpu_sparse_lu_torch.ops import _build as B

    SIDE.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = B._nvcc(), {}
    for name, text in versions:
        h = hashlib.sha256(text.encode()).hexdigest()[:12]
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


def print_ptxas(name, ptxas, kernel):
    """Registers, shared memory, stack and spills of each instance of the
    kernels whose mangled names hold ``kernel``."""
    cur = None
    for line in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?$", line.strip())
        if m:
            cur = m.group(1)
            continue
        if cur and kernel in cur and ("Used" in line or "stack frame" in line):
            print(f"[ptxas] {name} {cur}: {line.strip()}", flush=True)


def run_trees(script, trees, extra, timeout=900):
    """Run ``script --worker NAME --root PATH *extra`` for each tree in
    order; returns the JSON each printed on its last line."""
    results = []
    for name, path in trees:
        cmd = [sys.executable, str(script), "--worker", name, "--root",
               str(Path(path).resolve()), *extra]
        proc = subprocess.run(cmd, timeout=timeout, capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            raise SystemExit(f"{Path(script).name}: tree {name} failed "
                             f"({proc.returncode})")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return results
