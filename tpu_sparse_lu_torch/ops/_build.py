"""Build and load the CUDA kernels of ``tpu_sparse_lu_torch/csrc``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``tpu_sparse_lu_torch/_build/``, under a name keyed by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built or imported when this
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
          "-shared", "-Xcompiler", "-fPIC"]

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


def _compile(srcs, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dt in ("f32", "f64"):
        f = getattr(lib, f"ldiv_perm_gather_{dt}")
        f.argtypes = [P, P, P, P, L, L, I, P]
        f.restype = I
        f = getattr(lib, f"ldiv_wave_apply_{dt}")
        f.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
        f.restype = I
    lib.ldiv_error_string.argtypes = [I]
    lib.ldiv_error_string.restype = ctypes.c_char_p
    lib.ldiv_max_chunk.argtypes = []
    lib.ldiv_max_chunk.restype = I
    lib.max_chunk = lib.ldiv_max_chunk()  # largest chunk_size it takes
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
            for s in srcs:
                h.update(s.name.encode())
                h.update(s.read_bytes())
            so = _BUILD_DIR / f"libldiv_{h.hexdigest()[:16]}.so"
            if not so.exists():
                _compile(srcs, so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
