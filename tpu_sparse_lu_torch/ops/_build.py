"""Build and load the CUDA kernels of ``tpu_sparse_lu_torch/csrc``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``tpu_sparse_lu_torch/_build/``, under a name keyed by
a hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. Nothing is built or imported when this
module is imported: CPU-only installs never call :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpu_sparse_lu_torch are built from source at first use"
    )


def _sources():
    srcs = sorted(_SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_SRC_DIR}")
    return srcs


def _headers():
    """The device bodies several sources include (``*.cuh``)."""
    return sorted(_SRC_DIR.glob("*.cuh"))


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, cmd) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def _compile(srcs, out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build beside the target and rename: a concurrent build never sees
    # a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, jobs = [], []
        try:
            for src in srcs:
                obj = str(Path(tmp) / (src.stem + ".o"))
                cmd = [nvcc, *_FLAGS, "-c", "-o", obj, str(src)]
                objs.append(obj)
                jobs.append((_run(cmd), cmd))
            for proc, cmd in jobs:
                _wait(proc, cmd)
        finally:
            for proc, _ in jobs:  # after a failure, stop the others
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        so = str(Path(tmp) / out.name)
        cmd = [nvcc, *_FLAGS, "-shared", "-o", so, *objs]
        _wait(_run(cmd), cmd)
        os.replace(so, out)


def bind_fused_ldiv(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/ldiv_fused.cu``'s entries (also bound
    on the side libraries of ``tools/ldiv_sweep.py``)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dt in ("f32", "f64", "bf16"):
        f = getattr(lib, f"ldiv_fused_{dt}")
        f.argtypes = [P] * 14 + [I, L, I, I, I, P]
        f.restype = I
        f = getattr(lib, f"ldiv_fused_{dt}_capacity")
        f.argtypes = [I, I]
        f.restype = I
    return lib


def bind_elim_fused(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/elim_fused.cu``'s entries (also bound
    on the side libraries of ``tools/elim_sweep.py``)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        f = getattr(lib, f"elim_fused_{dt}")
        f.argtypes = [P] * 13 + [I, I, I, P]
        f.restype = I
        f = getattr(lib, f"elim_fused_{dt}_capacity")
        f.argtypes = [I]
        f.restype = I
    lib.elim_fused_clock_words.argtypes = []
    lib.elim_fused_clock_words.restype = I
    return lib


def bind_bidiag(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/bidiag.cu``'s entries (also bound on
    the side libraries of ``tools/chain_sweep.py``)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dt in ("f32", "f64"):
        f = getattr(lib, f"bidiag_ldiv_{dt}")
        f.argtypes = [P] * 8 + [L, I, L, I, P]
        f.restype = I
        f = getattr(lib, f"bidiag_ldiv_{dt}_capacity")
        f.argtypes = []
        f.restype = I
    return lib


def bind_assembly(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/assemble.cu``'s entries (also bound on
    the side libraries of ``tools/assemble_sweep.py``)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dt in ("f32", "f64"):
        f = getattr(lib, f"assemble_tiles_{dt}")
        f.argtypes = [P] * 12 + [L, I, I, P]
        f.restype = I
        f = getattr(lib, f"assemble_closure_{dt}")
        f.argtypes = [P] * 8 + [I, I, I, P]
        f.restype = I
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dt in ("f32", "f64"):
        f = getattr(lib, f"ldiv_perm_gather_{dt}")
        f.argtypes = [P, P, P, P, L, L, I, P]
        f.restype = I
        f = getattr(lib, f"ldiv_wave_apply_{dt}")
        f.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
        f.restype = I
        f = getattr(lib, f"span_gather_{dt}")
        f.argtypes = [P, P, P, P, P, L, L, I, P]
        f.restype = I
        f = getattr(lib, f"lu_tile_{dt}")
        f.argtypes = [P, P, I, P, P, P, I, P]
        f.restype = I
        f = getattr(lib, f"tile_mm_{dt}")
        f.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        f.restype = I
    lib.ldiv_wave_apply_bf16.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    lib.ldiv_wave_apply_bf16.restype = I
    bind_fused_ldiv(lib)
    bind_elim_fused(lib)
    bind_bidiag(lib)
    bind_assembly(lib)
    lib.ldiv_error_string.argtypes = [I]
    lib.ldiv_error_string.restype = ctypes.c_char_p
    lib.ldiv_max_chunk.argtypes = []
    lib.ldiv_max_chunk.restype = I
    # largest chunk_size the kernels take (every kernel holds a tile of up
    # to 128 rows in shared memory or registers)
    lib.max_chunk = lib.ldiv_max_chunk()
    return lib


def load() -> ctypes.CDLL:
    """Build (when missing) and load the kernel library; raises on a failed
    build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            h = hashlib.sha256(" ".join(_FLAGS).encode())
            for s in srcs + _headers():
                h.update(s.name.encode())
                h.update(s.read_bytes())
            so = _BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"
            if not so.exists():
                _compile(srcs, so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
