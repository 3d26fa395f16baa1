"""Native host runtime of the port: ctypes bindings to ``zxc_host.cpp``.

``zxc_host.cpp`` is a verbatim copy of ``zxc_tpu/runtime/zxc_host.cpp``
(standard headers and ``immintrin.h`` only). This module binds the symbols
the device decode path calls: the frame walk and batched payload checksum,
the fused per-block prep of the copy engine's control
(``zxch_v19_prep_block`` / ``zxch_v26_prep_block``), the piece resolver
and lane-op splitter that the prep fuses (exposed for parity tests), and
the native frame encoder.

Unlike ``zxc_tpu.runtime`` there is no pure-Python fallback: the port's
decode path has no Python prep, so a library that cannot be built or
loaded raises RuntimeError.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..buildlib import build_shared
from ..errors import ZxcError, ERROR_BAD_OFFSET

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zxc_host.cpp")

_lock = threading.Lock()
_lib = None
KOUT = (1 << 30) + 1   # self-referential piece kind (set from the native
# library on the first resolve_pieces(self_ref=True) call)
_resolve_tl = threading.local()  # resolve_pieces per-thread scratch


def _isa_flags() -> list[str]:
    """-march=native by default; ZXCH_PORTABLE=1 selects the AVX2 tier
    (the same switch as the JAX package's runtime)."""
    if os.environ.get("ZXCH_PORTABLE"):
        return ["-mavx2", "-mbmi", "-mbmi2", "-mlzcnt"]
    return ["-march=native"]


def _bind(L: ctypes.CDLL) -> None:
    # argtypes are mandatory: stack-passed uint64_t gets garbage upper
    # bits under the default c_int marshalling
    vp, u64, i64, u32 = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                         ctypes.c_uint32)
    ci = ctypes.c_int
    L.zxch_isa_supported.restype = ci
    L.zxch_isa_supported.argtypes = []
    L.zxch_rapidhash32_batch.restype = None
    L.zxch_rapidhash32_batch.argtypes = [vp, vp, vp, vp, ctypes.c_size_t]
    L.zxch_walk_frame.restype = i64
    L.zxch_walk_frame.argtypes = [vp, u64, ci, u64, u64, vp, vp, vp, u64, vp]
    L.zxch_resolve_pieces.restype = i64
    L.zxch_resolve_pieces.argtypes = [vp, vp, vp, u64, vp, u64, u64, u64,
                                      vp, vp, vp, vp, u64, vp, ci, ci]
    L.zxch_resolve_pieces_sr.restype = i64
    L.zxch_resolve_pieces_sr.argtypes = (L.zxch_resolve_pieces.argtypes
                                         + [vp])
    L.zxch_lane_ops.restype = i64
    L.zxch_lane_ops.argtypes = [vp] * 4 + [u64, i64] + [vp] * 5 + [u64]
    L.zxch_compress_frame.restype = i64
    L.zxch_compress_frame.argtypes = [vp, u64, ci, ci, ci, ci, ci, ci, ci,
                                      ci, u64, ci, ci, ci, vp, u64, vp, u32,
                                      vp, u64]
    L.zxch_compress_frame_mt.restype = i64
    L.zxch_compress_frame_mt.argtypes = L.zxch_compress_frame.argtypes + [ci]
    L.zxch_v19_prep_block.restype = i64
    L.zxch_v19_prep_block.argtypes = [vp, u64, ci, u64, vp, u64, vp, ci, ci,
                                      vp, vp, vp, vp, vp, i64, i64, i64, vp,
                                      vp, vp]
    L.zxch_v26_prep_block.restype = i64
    L.zxch_v26_prep_block.argtypes = L.zxch_v19_prep_block.argtypes


def lib() -> ctypes.CDLL:
    """The native library, built on first use. Raises RuntimeError when it
    cannot be built, loaded, or run on this CPU."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build_shared(_SRC, "libzxchost",
                               ["g++", "-O3"] + _isa_flags()
                               + ["-pthread", "-shared", "-fPIC"])
        try:
            L = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        _bind(L)
        if not L.zxch_isa_supported():
            raise RuntimeError(f"{path} was built for another CPU")
        # publish only once every binding is in place: a worker thread
        # must never call through a half-bound function pointer
        _lib = L
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _as_dict_args(dict_buf, dict_cl):
    d8 = (np.ascontiguousarray(dict_buf, np.uint8) if dict_buf is not None
          else np.zeros(0, np.uint8))
    cl8 = (np.ascontiguousarray(dict_cl, np.uint8) if dict_cl is not None
           else None)
    return d8, cl8, (None if cl8 is None else _ptr(cl8))


def resolve_pieces(ll: np.ndarray, ml: np.ndarray, off: np.ndarray,
                   literals: np.ndarray, dict_buf: np.ndarray | None = None,
                   max_pieces: int | None = None,
                   synth_cap: int | None = None, device_pure: bool = False,
                   max_frag: int = 0, self_ref: bool = False):
    """Resolve LZ chains into the flat piecewise-literal mapping
    ``out[p] = lit_full[c + (p - s) % k]`` (lit_full = dict ++ literals ++
    bytes the resolver materialized).

    ``self_ref`` (requires device_pure): matches whose source completes
    before the destination's 16 KiB supertile emit ONE piece with
    k == KOUT and c/s in OUTPUT coordinates; KOUT is exported as
    ``runtime.KOUT`` after the first such call.

    Returns (out_start, c, s, k, lit_full), or None when the piece budget
    is exceeded. Raises ZxcError on bad offsets."""
    L = lib()
    n_seq = len(ll)
    if max_pieces is None:
        max_pieces = 8 * n_seq + 64
    dict_len = 0 if dict_buf is None else len(dict_buf)
    base = np.ascontiguousarray(literals, np.uint8)
    total_out = int(np.asarray(ll).sum() + np.asarray(ml).sum()) + \
        (len(base) - int(np.asarray(ll).sum()))
    if synth_cap is None:
        synth_cap = max(total_out, 1 << 16)
        if device_pure:
            synth_cap += total_out + (1 << 20)  # pattern buffers (2KB each)
    lit_len = dict_len + len(base)
    # reused per-thread scratch: a fresh np.empty per call costs more in
    # first-touch page faults than the resolver's own compute
    tl = _resolve_tl
    if getattr(tl, "lit", None) is None or len(tl.lit) < lit_len + synth_cap:
        tl.lit = np.empty(max(lit_len + synth_cap, 4 << 20), np.uint8)
    if getattr(tl, "po", None) is None or len(tl.po) < max_pieces:
        cap = max(max_pieces, 1 << 18)
        tl.po, tl.pc = np.empty(cap, np.int32), np.empty(cap, np.int32)
        tl.ps, tl.pk = np.empty(cap, np.int32), np.empty(cap, np.int32)
    lit_full = tl.lit
    if dict_len:
        lit_full[:dict_len] = dict_buf
    lit_full[dict_len:lit_len] = base
    ll32 = np.ascontiguousarray(ll, np.int32)
    ml32 = np.ascontiguousarray(ml, np.int32)
    off32 = np.ascontiguousarray(off, np.int32)
    po, pc, ps, pk = tl.po, tl.pc, tl.ps, tl.pk
    lit_out = ctypes.c_uint64(0)
    args = (_ptr(ll32), _ptr(ml32), _ptr(off32), n_seq, _ptr(lit_full),
            lit_len, len(lit_full), dict_len, _ptr(po), _ptr(pc), _ptr(ps),
            _ptr(pk), max_pieces, ctypes.byref(lit_out),
            1 if device_pure else 0, max_frag)
    if self_ref:
        kout = ctypes.c_int32(0)
        n = L.zxch_resolve_pieces_sr(*args, ctypes.byref(kout))
        global KOUT
        KOUT = int(kout.value)
    else:
        n = L.zxch_resolve_pieces(*args)
    if n == -9:
        raise ZxcError(ERROR_BAD_OFFSET, "piece resolution")
    if n < 0:
        return None  # piece budget exceeded
    # copies, not views: the scratch is reused by the next call
    return (po[:n].copy(), pc[:n].copy(), ps[:n].copy(), pk[:n].copy(),
            lit_full[:lit_out.value].copy())


def lane_ops(po, pc, ps, pk, total: int):
    """Split device_pure pieces into (32,128)-tile lane-op batches. Returns
    (rows, roll, s, e) int32 arrays of shape (n_batches, 32) plus
    tile_start (n_tiles+1,), or None when the batch budget is exceeded."""
    L = lib()
    n = len(po)
    n_rows = (total + 127) // 128
    n_tiles = (n_rows + 31) // 32
    max_batches = 2 * n + 8 * n_tiles + 64   # every op its own layer
    rows = np.empty((max_batches, 32), np.int32)
    roll = np.empty((max_batches, 32), np.int32)
    s = np.empty((max_batches, 32), np.int32)
    e = np.empty((max_batches, 32), np.int32)
    tile_start = np.empty(n_tiles + 1, np.int32)
    p32 = [np.ascontiguousarray(a, np.int32) for a in (po, pc, ps, pk)]
    nb = L.zxch_lane_ops(*(_ptr(a) for a in p32), n, total, _ptr(rows),
                         _ptr(roll), _ptr(s), _ptr(e), _ptr(tile_start),
                         max_batches)
    if nb < 0:
        return None
    nb = int(nb)
    return rows[:nb], roll[:nb], s[:nb], e[:nb], tile_start


def compress_frame(data: np.ndarray, level: int, max_probes: int,
                   lazy: bool, sufficient_len: int, step_base: int,
                   step_shift: int, cover_base: int, block_size: int,
                   block_size_code: int, checksum: bool, seekable: bool,
                   min_emit: int = 5, dict_buf: np.ndarray | None = None,
                   dict_cl: np.ndarray | None = None, dict_id: int = 0,
                   threads: int = 1) -> bytes:
    """Whole-frame one-shot encode; archive bytes are identical at every
    thread count (threads > 1 uses zxch_compress_frame_mt). Raises
    ZxcError with the native error code on failure."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    n = len(d8)
    db, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    n_blocks = (n + block_size - 1) // block_size
    cap = (16 + 12 + n + n_blocks * (8 + 4 + 64) + n // 4 + 4 * n_blocks
           + 8 + 4096)
    out = np.empty(cap, np.uint8)
    args = (_ptr(d8), n, level, max_probes, 1 if lazy else 0,
            sufficient_len, step_base, step_shift, cover_base, min_emit,
            block_size, block_size_code, 1 if checksum else 0,
            1 if seekable else 0, _ptr(db), len(db), cl_ptr,
            ctypes.c_uint32(dict_id), _ptr(out), cap)
    if threads > 1:
        w = L.zxch_compress_frame_mt(*args, int(threads))
    else:
        w = L.zxch_compress_frame(*args)
    if w < 0:
        raise ZxcError(int(w), "native frame encode")
    return out[:w].tobytes()


def v19_prep_block(payload: np.ndarray, block_type: int, block_size: int,
                   qs_row: np.ndarray, qbase_row: np.ndarray,
                   pctrl_row: np.ndarray, tq_row: np.ndarray,
                   lit8_row: np.ndarray, MAXQ: int, NG32: int, RLP: int,
                   K: int = 2, quad_align: int = 2,
                   dict_buf: np.ndarray | None = None,
                   dict_cl: np.ndarray | None = None,
                   self_ref: bool = False):
    """Fused device-dispatch prep: one native call takes a block payload to
    the copy engine's control slices (section parse + entropy literals +
    piece resolution + lane-op packing, in the layout of the JAX package's
    ``pack_blocks_v19`` / ``pack_blocks_v26``). ``self_ref`` selects the
    v26 contract (KOUT sources read the kernel's own decoded rows at
    window row RLP + out_row).

    The *_row arrays are this block's C-contiguous slices of the dispatch
    group arrays. Returns (total, nq, maxrow, litrows); total < 0 is a ZXC
    error code, with -10 also meaning "MAXQ/RLP too small" (nq / maxrow /
    litrows then hold the needed lower bounds)."""
    L = lib()
    pl = np.ascontiguousarray(payload, np.uint8)
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    nq = ctypes.c_int64(0)
    maxrow = ctypes.c_int64(0)
    litrows = ctypes.c_int64(0)
    fn = L.zxch_v26_prep_block if self_ref else L.zxch_v19_prep_block
    total = fn(_ptr(pl), len(pl), block_type, block_size, _ptr(d8), len(d8),
               cl_ptr, K, quad_align, _ptr(qs_row), _ptr(qbase_row),
               _ptr(pctrl_row), _ptr(tq_row), _ptr(lit8_row), MAXQ, NG32,
               RLP, ctypes.byref(nq), ctypes.byref(maxrow),
               ctypes.byref(litrows))
    return int(total), int(nq.value), int(maxrow.value), int(litrows.value)
