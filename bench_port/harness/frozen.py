"""The frozen native encoder: ``frozen/zxc_host.cpp``, an unchanged copy of
the port's host runtime source, built with g++ into ``bench_port/build/``
and called through ctypes. The archives that the decode cells decode are
made by it, so a later change to the port's encoder does not change them.
Its multi-threaded decoder with checksum verification is a second witness
in the check of the compress cell.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "frozen", "zxc_host.cpp")
BUILD_DIR = os.path.join(HERE, "build")
CMD = ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _cpu_identity() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join([ln for ln in lines
                       if ln.startswith((b"model name", b"flags"))][:2])


def _build() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(CMD).encode()
                                + _cpu_identity()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"frozen_zxc-{digest}.so")
    with open(os.path.join(BUILD_DIR, "frozen_zxc.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.part"
            r = subprocess.run(CMD + ["-o", tmp, SRC], capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"building the frozen encoder failed:\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(_build())
            vp, u64, i64, ci = (ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_int64, ctypes.c_int)
            L.zxch_simple_compress_mt.restype = i64
            L.zxch_simple_compress_mt.argtypes = [vp, u64, ci, u64, ci, ci,
                                                  vp, u64, ci]
            L.zxch_simple_decompress_mt.restype = i64
            L.zxch_simple_decompress_mt.argtypes = [vp, u64, vp, u64, vp,
                                                    u64, vp, ci, ci]
            L.zxch_simple_decompress_bound.restype = i64
            L.zxch_simple_decompress_bound.argtypes = [vp, u64]
            L.zxch_compress_bound.restype = i64
            L.zxch_compress_bound.argtypes = [u64, u64]
            _lib = L
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def compress(data: bytes, level: int, block_size: int, checksum: bool,
             threads: int) -> bytes:
    """One archive of ``data``; the bytes are the same at every thread
    count."""
    L = lib()
    src = np.frombuffer(data, np.uint8)
    cap = int(L.zxch_compress_bound(len(src), block_size))
    out = np.empty(cap, np.uint8)
    w = L.zxch_simple_compress_mt(_ptr(src), len(src), level, block_size,
                                  int(checksum), 0, _ptr(out), cap, threads)
    if w < 0:
        raise RuntimeError(f"frozen encoder failed ({w})")
    return out[:w].tobytes()


def decompress(archive: bytes, size: int, threads: int) -> bytes | None:
    """The plaintext of ``archive`` with every checksum verified, or None
    where the frozen decoder rejects it."""
    L = lib()
    src = np.frombuffer(archive, np.uint8)
    cap = int(L.zxch_simple_decompress_bound(_ptr(src), len(src)))
    if cap < 0:
        return None
    out = np.empty(max(cap, 1), np.uint8)
    w = L.zxch_simple_decompress_mt(_ptr(src), len(src), _ptr(out), cap,
                                    None, 0, None, 1, threads)
    if w != size:
        return None
    return out[:w].tobytes()
