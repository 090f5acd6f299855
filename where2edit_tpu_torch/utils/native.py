"""ctypes bindings for the native host k-means (``native/libw2e_native.so``,
plain C++; the port's own loader for the library the JAX package also
uses). The library is built with ``make -C native`` at first use; without a
compiler every entry point returns None and the caller falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libw2e_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.w2e_kmeans_fit.restype = ctypes.c_int
    lib.w2e_kmeans_fit.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.w2e_kmeans_assign.restype = None
    lib.w2e_kmeans_assign.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def kmeans_fit_native(data: np.ndarray, k: int, *, max_iters: int = 100,
                      seed: int = 42):
    """Multithreaded k-means (k-means++ seeding, then Lloyd). Returns
    (centers (k, d), n_iters), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    centers = np.empty((k, d), np.float32)
    iters = lib.w2e_kmeans_fit(_fptr(data), n, d, k, max_iters, seed,
                               _fptr(centers), None)
    if iters < 0:
        return None
    return centers, iters


def kmeans_assign_native(data: np.ndarray, centers: np.ndarray):
    """Nearest-centre ids (n,) int32, or None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    n, d = data.shape
    ids = np.empty((n,), np.int32)
    lib.w2e_kmeans_assign(_fptr(data), n, d, _fptr(centers), centers.shape[0],
                          ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return ids
