"""ctypes bindings for the native C++ host-side engine (csrc/gpo_native.cpp).

Compiled on demand with g++ into a cache directory; every entry point has a pure
numpy fallback in bo/designs.py, so the library works (slower) without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _src_path() -> Path:
    return Path(__file__).resolve().parent.parent.parent / "csrc" / "gpo_native.cpp"


def _lib_path() -> Path:
    cache = Path(__file__).resolve().parent.parent.parent / ".native_cache"
    cache.mkdir(exist_ok=True)
    return cache / "libgpo_native.so"


def _build() -> Path | None:
    src = _src_path()
    if not src.exists():
        return None
    lib = _lib_path()
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(src), "-o", str(lib)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return lib
    except Exception:
        return None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GPO_NO_NATIVE"):
        return None
    lib_path = _build()
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.min_pairwise_dist.restype = ctypes.c_double
    lib.min_pairwise_dist.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
    ]
    lib.maximin_lhs.restype = None
    lib.maximin_lhs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.discrete_lhs.restype = ctypes.c_int
    lib.discrete_lhs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_double, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.sobol_points.restype = ctypes.c_int
    lib.sobol_points.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native engine unavailable (no compiler or GPO_NO_NATIVE set); "
            "check utils.native.available() and use the numpy fallbacks in "
            "bo/designs.py")
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def maximin_lhs(n, d, iterations, seed) -> np.ndarray:
    lib = _require_lib()
    out = np.empty((n, d), dtype=np.float64)
    lib.maximin_lhs(n, d, iterations, int(seed) & 0xFFFFFFFFFFFFFFFF, _dptr(out))
    return out


def discrete_lhs(n, levels, iterations, retries, frac, seed):
    """Returns (unit_starts (n, d), representation_ok)."""
    lib = _require_lib()
    levels = np.asarray(levels, dtype=np.int32)
    d = len(levels)
    out = np.empty((n, d), dtype=np.float64)
    ok = lib.discrete_lhs(
        n, d, iterations, retries,
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        float(frac), int(seed) & 0xFFFFFFFFFFFFFFFF, _dptr(out),
    )
    return out, bool(ok)


def sobol_points(n, d) -> np.ndarray | None:
    lib = _require_lib()
    out = np.empty((n, d), dtype=np.float64)
    if not lib.sobol_points(n, d, _dptr(out)):
        return None
    return out


def min_pairwise_dist(X) -> float:
    lib = _require_lib()
    X = np.ascontiguousarray(X, dtype=np.float64)
    return float(lib.min_pairwise_dist(_dptr(X), X.shape[0], X.shape[1]))
