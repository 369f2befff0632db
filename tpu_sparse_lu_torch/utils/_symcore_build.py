"""Build and load the native planner core (``utils/_symcore.cpp``).

The counterpart of ``tpu_sparse_lu/utils/_symcore_build.py``, in the
port's own convention: the source has a plain C interface and is loaded
with ``ctypes`` (no ``Python.h``, no NumPy headers). The first call of
:func:`native` compiles it with ``g++ -O3 -std=c++17`` (``$CXX`` if set)
into ``tpu_sparse_lu_torch/_build/``, under a name keyed by a hash of the
source and flags, as ``ops/_build.py`` keys the CUDA build: an edited
source is rebuilt, an unchanged one loaded as it is, and no binary is
committed. Nothing is built when this module is imported.

A failed build is not silent: it warns once (``RuntimeWarning`` on
stderr, with the cause), :func:`native` returns ``None``, and the NumPy
planner in ``symbolic.py`` / ``refactor.py`` serves. The NumPy planner is
the plain version the native core is held against: the plans are the
same arrays, bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["SymCore", "load", "native"]

_SRC = Path(__file__).resolve().with_name("_symcore.cpp")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_native: Optional["SymCore"] = None
_tried = False


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class SymCore:
    """The three entries of the native core on NumPy arrays; each returns
    what its NumPy counterpart returns (int64 arrays)."""

    def __init__(self, lib: ctypes.CDLL):
        P, L, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.symcore_level_schedule.argtypes = [P, P, L, L, I, P]
        lib.symcore_level_schedule.restype = I
        lib.symcore_blocked_fill.argtypes = [P, P, L, L, P]
        lib.symcore_blocked_fill.restype = P
        lib.symcore_take_pairs.argtypes = [P, P, P]
        lib.symcore_take_pairs.restype = None
        lib.symcore_plan_keys.argtypes = [P, P, I, L, L, L, I, P, L, P, P]
        lib.symcore_plan_keys.restype = P
        lib.symcore_plan_fill.argtypes = [P, P, P, I, L, L, L, P, P, P]
        lib.symcore_plan_fill.restype = None
        lib.symcore_free.argtypes = [P, I]
        lib.symcore_free.restype = None
        self._lib = lib

    def level_schedule(self, ub, uc, K: int, lower: bool) -> np.ndarray:
        """Longest-path level of each chunk; ``ub`` sorted ascending."""
        ub, uc = _i64(ub), _i64(uc)
        if ub.shape != uc.shape:
            raise ValueError("brow/bcol size mismatch")
        level = np.empty(K, dtype=np.int64)
        self._lib.symcore_level_schedule(_ptr(ub), _ptr(uc), ub.size, K,
                                         int(lower), _ptr(level))
        return level

    def blocked_fill(self, br, bc, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """Closure of the tiles ``(br, bc)``: sorted-unique rows, cols."""
        br, bc = _i64(br), _i64(bc)
        if br.shape != bc.shape:
            raise ValueError("brow/bcol size mismatch")
        count = ctypes.c_int64()
        h = self._lib.symcore_blocked_fill(_ptr(br), _ptr(bc), br.size, K,
                                           ctypes.byref(count))
        try:
            r = np.empty(count.value, dtype=np.int64)
            c = np.empty(count.value, dtype=np.int64)
        except BaseException:
            self._lib.symcore_free(h, 0)
            raise
        self._lib.symcore_take_pairs(h, _ptr(r), _ptr(c))
        return r, c

    def plan_maps(self, indptr, indices, cs: int, K: int, lower: bool,
                  extra_keys) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted unique off-diagonal tile keys (``extra_keys`` merged in)
        and the per-nonzero pack destinations ``diag_dest``,
        ``offdiag_dest`` of a CSC factor; ``ValueError`` on entries on the
        wrong side of the diagonal. int32 and int64 index arrays are read
        in place."""
        indptr, indices = np.asarray(indptr), np.asarray(indices)
        if (indptr.dtype != indices.dtype
                or indptr.dtype not in (np.int32, np.int64)):
            indptr, indices = _i64(indptr), _i64(indices)
        indptr = np.ascontiguousarray(indptr)
        indices = np.ascontiguousarray(indices)
        if indptr.size == 0:
            raise ValueError("empty indptr")
        idx64 = int(indptr.dtype == np.int64)
        n, nnz = indptr.size - 1, indices.size
        extra = _i64(extra_keys)
        T, bad = ctypes.c_int64(), ctypes.c_int64()
        lib = self._lib
        h = lib.symcore_plan_keys(_ptr(indptr), _ptr(indices), idx64, n, cs,
                                  K, int(lower), _ptr(extra), extra.size,
                                  ctypes.byref(T), ctypes.byref(bad))
        if bad.value:
            raise ValueError(
                f"{bad.value} entries on the wrong side of the diagonal for "
                f"{'lower' if lower else 'upper'} factor")
        try:
            keys = np.empty(T.value, dtype=np.int64)
            dd = np.empty(nnz, dtype=np.int64)
            od = np.empty(nnz, dtype=np.int64)
        except BaseException:
            lib.symcore_free(h, 1)
            raise
        lib.symcore_plan_fill(h, _ptr(indptr), _ptr(indices), idx64, n, cs,
                              K, _ptr(keys), _ptr(dd), _ptr(od))
        return keys, dd, od


def _compile(src: Path, out: Path, cxx: str) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent build never sees a
    # half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = Path(tmp) / out.name
        subprocess.run([cxx, *_FLAGS, str(src), "-o", str(so)], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(so, out)


def load(src: Path = _SRC, build_dir: Path = _BUILD_DIR,
         cxx: Optional[str] = None) -> Optional[SymCore]:
    """Build ``src`` (when its keyed library is missing) into
    ``build_dir`` and load it; on any failure warn with the cause and
    return ``None``."""
    cxx = cxx or os.environ.get("CXX") or "g++"
    try:
        body = Path(src).read_bytes()
        h = hashlib.sha256(" ".join([cxx, *_FLAGS]).encode() + body)
        so = Path(build_dir) / f"libsymcore_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _compile(Path(src), so, cxx)
        return SymCore(ctypes.CDLL(str(so)))
    except (OSError, AttributeError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or ""
        warnings.warn(
            f"tpu_sparse_lu_torch: the native planner core did not build "
            f"({type(e).__name__}: {e}{'; ' + detail[-500:] if detail else ''}"
            f"); the NumPy planner serves", RuntimeWarning, stacklevel=2)
        return None


def native() -> Optional[SymCore]:
    """The package's native core, built at the first call; ``None`` (after
    one warning) when it cannot be built."""
    global _native, _tried
    if not _tried:
        with _lock:
            if not _tried:
                _native = load()
                _tried = True
    return _native
