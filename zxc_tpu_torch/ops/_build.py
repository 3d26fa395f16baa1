"""Builds ``csrc/*.cu`` with nvcc for sm_90a and loads it through ctypes.

The kernels have a plain C interface (pointers, ints, the stream), so the
build needs no PyTorch headers and takes seconds. It runs at first use,
never at import; without nvcc, or when the build or load fails, it raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..buildlib import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc / ptxas output of the build this process ran


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def kernels() -> ctypes.CDLL:
    """The copy-engine kernel library, built on first use."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, build_log = build_shared(os.path.join(_CSRC, "copy_engine.cu"),
                                       "copy_engine",
                                       [_nvcc()] + NVCC_FLAGS)
        try:
            L = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (L.zxc_copy_engine_v19, L.zxc_copy_engine_v26):
            fn.restype = ci
            fn.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        L.zxc_copy_engine_v27.restype = ci
        L.zxc_copy_engine_v27.argtypes = ([vp] * 7 + [ci] * 6
                                          + [ctypes.c_int64, vp])
        L.zxc_copy_engine_v13.restype = ci
        L.zxc_copy_engine_v13.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        _lib = L
        return _lib
