"""Builds ``csrc/*.cu`` with nvcc for sm_90a and loads it through ctypes.

The kernels have a plain C interface (pointers, ints, the stream), so the
build needs no PyTorch headers and takes seconds. Each source is its own
library, built at first use (never at import) under its own lock, so the
sources can build in parallel; without nvcc, or when the build or load fails,
it raises.
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

_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc / ptxas output per source, as built


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library(stem: str, bind) -> ctypes.CDLL:
    """``csrc/<stem>.cu`` built on first use and loaded, with ``bind``
    setting its entries' ctypes signatures; one lock per source."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _guard:
        lock = _locks.setdefault(stem, threading.Lock())
    with lock:
        if stem in _libs:
            return _libs[stem]
        path, build_logs[stem] = build_shared(
            os.path.join(_CSRC, f"{stem}.cu"), stem, [_nvcc()] + NVCC_FLAGS)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        bind(lib, ctypes.c_void_p, ctypes.c_int)
        _libs[stem] = lib
        return lib


def _bind_copy_engine(L, vp, ci) -> None:
    # the tile routine's entries end with the cluster size before stream
    L.zxc_copy_engine_v19.restype = ci
    L.zxc_copy_engine_v19.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    # v25/v26/v27 take the call's scratch (ticket and ready flags) after out
    for fn in (L.zxc_copy_engine_v25, L.zxc_copy_engine_v26):
        fn.restype = ci
        fn.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    L.zxc_copy_engine_v27.restype = ci
    L.zxc_copy_engine_v27.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_int64,
                                                            vp]
    L.zxc_copy_engine_v13.restype = ci
    L.zxc_copy_engine_v13.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    L.zxc_copy_engine_quad.restype = ci
    L.zxc_copy_engine_quad.argtypes = [vp] * 6 + [ci] * 8 + [vp]
    L.zxc_copy_engine_quad_ablate.restype = ci
    L.zxc_copy_engine_quad_ablate.argtypes = [vp] * 6 + [ci] * 7 + [vp]


def _bind_encode(L, vp, ci) -> None:
    i64 = ctypes.c_longlong
    L.zxc_lcp.restype = ci
    L.zxc_lcp.argtypes = [vp] * 3 + [ci, i64, ci, i64, ci, vp]
    L.zxc_parse_walk.restype = ci
    L.zxc_parse_walk.argtypes = [vp] * 5 + [ci] * 7 + [vp]


def _bind_attic(L, vp, ci) -> None:
    L.zxc_piece_serial.restype = ci
    L.zxc_piece_serial.argtypes = [vp] * 3 + [ci, vp, ctypes.c_longlong, vp,
                                              ci, ci, ci, vp]
    L.zxc_window_merge.restype = ci
    L.zxc_window_merge.argtypes = [vp, vp, ci, vp, ci, vp, ci, ci, ci, vp]
    L.zxc_lane_sum.restype = ci
    L.zxc_lane_sum.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, ci, ci, ci,
                               ci, vp]
    L.zxc_lane_sum_probe.restype = ci
    L.zxc_lane_sum_probe.argtypes = [vp, vp, ci, vp, ci, vp, ci, ci, ci, vp]


def _bind_gather(L, vp, ci) -> None:
    i64 = ctypes.c_longlong
    L.zxc_gather_grid.restype = ci
    L.zxc_gather_grid.argtypes = ([vp] * 3 + [ci, ci, i64] + [ci] * 5
                                  + [i64] + [ci] * 3 + [vp])
    L.zxc_gather_rows.restype = ci
    L.zxc_gather_rows.argtypes = [vp, ci, ci, vp, ci, vp] + [ci] * 7 + [vp]


def kernels() -> ctypes.CDLL:
    """The copy-engine kernel library, built on first use."""
    return _library("copy_engine", _bind_copy_engine)


def encode_kernels() -> ctypes.CDLL:
    """The device encoder's kernel library (LCP, parse walk), built on
    first use."""
    return _library("encode", _bind_encode)


def attic_kernels() -> ctypes.CDLL:
    """The attic's kernel library (piece-serial, window merge, lane sum
    and its probe modes), built on first use."""
    return _library("attic", _bind_attic)


def gather_kernels() -> ctypes.CDLL:
    """The gather probes' kernel library (row-wise gather, row gather),
    built on first use."""
    return _library("gather", _bind_gather)
