"""Native host runtime of the port: ctypes bindings to ``zxc_host.cpp``.

``zxc_host.cpp`` is a verbatim copy of ``zxc_tpu/runtime/zxc_host.cpp``
(standard headers and ``immintrin.h`` only). This module binds the symbols
the device decode paths call: the frame walk and batched payload checksum,
the fused per-block prep of the copy engine's control
(``zxch_v19_prep_block`` / ``zxch_v26_prep_block``) and its hint-writing
form (``*_prep_block_plan``), the hint replay of the literal window
(``zxch_v19_lit8_load[_batch]``), the section parsers of ``plan_frame``
(RLE literals, varint extras, PivCo entropy), the piece resolver and
the lane-op and window-op splitters, the host block decoder
(``Seekable``), the host frame decoder (the hint body is itself a
frame), rapidhash64, the native frame encoder, and the section emitters
of the device encoder's host half (PivCo encode, RLE literals and
package-merge code lengths).

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
from ..errors import ZxcError, ERROR_BAD_OFFSET, ERROR_CORRUPT_DATA

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
    for fn in (L.zxch_window_ops, L.zxch_window_ops2):
        fn.restype = i64
        fn.argtypes = [vp] * 4 + [u64, i64, vp, vp, u64]
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
    L.zxch_v19_prep_block_plan.restype = i64
    L.zxch_v19_prep_block_plan.argtypes = (L.zxch_v19_prep_block.argtypes
                                           + [vp, i64, vp, vp])
    L.zxch_v26_prep_block_plan.restype = i64
    L.zxch_v26_prep_block_plan.argtypes = L.zxch_v19_prep_block_plan.argtypes
    L.zxch_v19_lit8_load.restype = i64
    L.zxch_v19_lit8_load.argtypes = [vp, u64, ci, u64, vp, u64, vp, vp, i64,
                                     i64, vp, i64]
    L.zxch_v19_lit8_load_batch.restype = i64
    L.zxch_v19_lit8_load_batch.argtypes = [vp, vp, vp, vp, i64, i64, i64, u64,
                                           vp, u64, vp, vp, vp, vp, vp, vp,
                                           i64, vp]
    L.zxch_decode_block.restype = i64
    L.zxch_decode_block.argtypes = [ci, vp, u64, vp, u64, vp, u64, vp]
    L.zxch_decompress_frame.restype = i64
    L.zxch_decompress_frame.argtypes = [vp, u64, u64, ci, ci, vp, u64, vp, vp,
                                        u64]
    L.zxch_decompress_frame_mt.restype = i64
    L.zxch_decompress_frame_mt.argtypes = (L.zxch_decompress_frame.argtypes
                                           + [ci])
    L.zxch_rapidhash64.restype = u64
    L.zxch_rapidhash64.argtypes = [vp, ctypes.c_size_t, u64]
    L.zxch_rle_decode.restype = ci
    L.zxch_rle_decode.argtypes = [vp, u64, vp, u64]
    L.zxch_varint_chain.restype = i64
    L.zxch_varint_chain.argtypes = [vp, u64, u64, vp]
    L.zxch_pivco_decode.restype = ci
    L.zxch_pivco_decode.argtypes = [vp, u64, vp, u64, vp]
    L.zxch_pivco_encode.restype = i64
    L.zxch_pivco_encode.argtypes = [vp, u64, vp, vp, u64]
    L.zxch_rle_encode_lit.restype = i64
    L.zxch_rle_encode_lit.argtypes = [vp, u64, vp, u64]
    L.zxch_code_lengths.restype = ci
    L.zxch_code_lengths.argtypes = [vp, ci, vp]


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


def window_ops(po, pc, ps, pk, total: int, split_src: bool = False):
    """Split device_pure pieces into 1024-byte-window merge ops, four
    int32 fields each (source row, net roll, ``dlo | dhi << 16``, fill
    byte + 1 or 0), also cut at source 1024-byte granules when
    ``split_src`` (``zxch_window_ops2``). Returns (ops int32 flat, wstart
    int32 (n_windows + 1,)), or None when the op budget is exceeded."""
    L = lib()
    n = len(po)
    n_windows = (total + 1023) // 1024
    max_ops = (3 if split_src else 2) * n + n_windows + 64
    ops = np.empty(max_ops * 4, np.int32)
    wstart = np.empty(n_windows + 1, np.int32)
    p32 = [np.ascontiguousarray(a, np.int32) for a in (po, pc, ps, pk)]
    fn = L.zxch_window_ops2 if split_src else L.zxch_window_ops
    r = fn(*(_ptr(a) for a in p32), n, total, _ptr(ops), _ptr(wstart),
           max_ops)
    if r < 0:
        return None
    return ops[:r * 4], wstart


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


def v19_prep_block_plan(payload: np.ndarray, block_type: int,
                        block_size: int, qs_row: np.ndarray,
                        qbase_row: np.ndarray, pctrl_row: np.ndarray,
                        tq_row: np.ndarray, lit8_row: np.ndarray,
                        MAXQ: int, NG32: int, RLP: int, plan: np.ndarray,
                        K: int = 2, quad_align: int = 2,
                        dict_buf: np.ndarray | None = None,
                        dict_cl: np.ndarray | None = None,
                        self_ref: bool = False):
    """``v19_prep_block`` plus the lit8 replay plan of a hint: ``plan`` is
    an (N, 4) int32 array that receives {kind, dst, src_or_byte, len}
    records. Returns (total, nq, maxrow, litrows, n_plan, lit_len); total
    == -16 means the plan array is too small."""
    L = lib()
    pl = np.ascontiguousarray(payload, np.uint8)
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    outs = [ctypes.c_int64(0) for _ in range(5)]
    nq, maxrow, litrows, n_plan, litlen = outs
    fn = (L.zxch_v26_prep_block_plan if self_ref
          else L.zxch_v19_prep_block_plan)
    total = fn(_ptr(pl), len(pl), block_type, block_size, _ptr(d8), len(d8),
               cl_ptr, K, quad_align, _ptr(qs_row), _ptr(qbase_row),
               _ptr(pctrl_row), _ptr(tq_row), _ptr(lit8_row), MAXQ, NG32,
               RLP, ctypes.byref(nq), ctypes.byref(maxrow),
               ctypes.byref(litrows), _ptr(plan), len(plan),
               ctypes.byref(n_plan), ctypes.byref(litlen))
    return (int(total),) + tuple(int(o.value) for o in outs)


def v19_lit8_load(payload: np.ndarray, block_type: int, block_size: int,
                  plan: np.ndarray, n_plan: int, lit_len: int,
                  lit8_row: np.ndarray, RLP: int,
                  dict_buf: np.ndarray | None = None,
                  dict_cl: np.ndarray | None = None) -> int:
    """Hint replay of one block's literal window: the archive's literal
    section decode plus the plan replay, written into ``lit8_row`` (RLP
    rows of capacity). Returns litrows >= 0 or a negative ZXC error."""
    L = lib()
    pl = np.ascontiguousarray(payload, np.uint8)
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    plan = np.ascontiguousarray(plan, np.int32)
    return int(L.zxch_v19_lit8_load(
        _ptr(pl), len(pl), block_type, block_size, _ptr(d8), len(d8), cl_ptr,
        _ptr(plan), n_plan, lit_len, _ptr(lit8_row), RLP))


def v19_lit8_load_batch(src: np.ndarray, pos: np.ndarray, comp: np.ndarray,
                        typ: np.ndarray, i0: int, i1: int, stride: int,
                        block_size: int, plans: np.ndarray,
                        plan_off: np.ndarray, litlen: np.ndarray,
                        lit8_base: np.ndarray, loff: np.ndarray, RLP: int,
                        zrows: np.ndarray | None = None,
                        dict_buf: np.ndarray | None = None,
                        dict_cl: np.ndarray | None = None) -> int:
    """Hint replay over a worker stripe (blocks i0, i0+stride, ... < i1)
    in one native call: block b's rows land at row ``loff[b]`` of
    ``lit8_base``, and rows [litrows, zrows[b]) are zeroed when ``zrows``
    is given. The arrays are indexed by block, ``loff`` and ``zrows``
    int32, ``plan_off`` and ``litlen`` int64, ``pos``/``comp`` uint64.
    Returns 0 or the first failing block's negative ZXC error."""
    L = lib()
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    want = ((src, np.uint8), (pos, np.uint64), (comp, np.uint64),
            (typ, np.uint8), (plans, np.int32), (plan_off, np.int64),
            (litlen, np.int64), (lit8_base, np.uint8), (loff, np.int32))
    for a, dt in want + (((zrows, np.int32),) if zrows is not None else ()):
        if a.dtype != dt or not a.flags["C_CONTIGUOUS"]:
            raise TypeError(f"lit8_load_batch needs contiguous {np.dtype(dt)}")
    return int(L.zxch_v19_lit8_load_batch(
        _ptr(src), _ptr(pos), _ptr(comp), _ptr(typ), i0, i1, stride,
        block_size, _ptr(d8), len(d8), cl_ptr, _ptr(plans), _ptr(plan_off),
        _ptr(litlen), _ptr(lit8_base), _ptr(loff), RLP,
        None if zrows is None else _ptr(zrows)))


def decompress_frame(src: np.ndarray, block_size: int, has_checksum: bool,
                     verify: bool, out: np.ndarray,
                     dict_buf: np.ndarray | None = None,
                     dict_cl: np.ndarray | None = None,
                     threads: int = 1) -> int:
    """Whole-frame host decode into ``out`` (a writable 1-D uint8 array of
    the footer's size; the native loop never writes past it). Returns the
    byte count; raises ZxcError with the native code on malformed input."""
    L = lib()
    src = np.ascontiguousarray(src, np.uint8)
    if not (out.dtype == np.uint8 and out.ndim == 1
            and out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]):
        raise TypeError("out must be a contiguous writable 1-D uint8 array")
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    args = (_ptr(src), len(src), block_size, 1 if has_checksum else 0,
            1 if verify else 0, _ptr(d8), len(d8), cl_ptr, _ptr(out),
            out.nbytes)
    if threads > 1:
        w = L.zxch_decompress_frame_mt(*args, int(threads))
    else:
        w = L.zxch_decompress_frame(*args)
    if w < 0:
        raise ZxcError(int(w), "native frame decode")
    return int(w)


def rapidhash64(data, seed: int = 0) -> int:
    """rapidhash v3 of ``data`` (bytes or a uint8 array), native."""
    a = np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
        data, np.uint8)
    return int(lib().zxch_rapidhash64(_ptr(a), len(a), seed))


def rapidhash32(data) -> int:
    """The per-block payload checksum: rapidhash64 folded to 32 bits."""
    h = rapidhash64(data)
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def decode_block(block_type: int, payload: np.ndarray, block_size: int,
                 dict_buf: np.ndarray | None = None,
                 dict_cl: np.ndarray | None = None) -> np.ndarray:
    """One block's payload decoded natively (section parse, entropy
    literals and expansion in one call, ``zxch_decode_block``). Raises
    ZxcError with the native code on malformed input."""
    L = lib()
    pl = np.ascontiguousarray(payload, np.uint8)
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    dst = np.empty(block_size + 64, np.uint8)
    n = L.zxch_decode_block(block_type, _ptr(pl), len(pl), _ptr(dst),
                            block_size, _ptr(d8), len(d8), cl_ptr)
    if n < 0:
        raise ZxcError(int(n), "native block decode")
    return dst[:n]


def rle_decode(stream: np.ndarray, out_size: int) -> np.ndarray:
    """RLE literal section (enc_lit=1) -> ``out_size`` bytes; raises
    ZxcError(CORRUPT_DATA) on a malformed stream."""
    L = lib()
    src = np.ascontiguousarray(stream, np.uint8)
    dst = np.empty(out_size, np.uint8)
    if L.zxch_rle_decode(_ptr(src), len(src), _ptr(dst), out_size) != 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "RLE stream (native)")
    return dst


def varint_chain(extras: np.ndarray, count: int) -> tuple[np.ndarray, bool]:
    """``count`` consecutive varints of the extras stream: (uint32 values,
    ok); ok is False when the chain runs out or hits a bad prefix."""
    L = lib()
    src = np.ascontiguousarray(extras, np.uint8)
    out = np.zeros(count, np.uint32)
    rc = L.zxch_varint_chain(_ptr(src), len(src), count, _ptr(out))
    return out, rc >= 0


def pivco_encode(data: np.ndarray, code_len: np.ndarray) -> bytes | None:
    """PivCo payload encode (no lengths header), native; None when the
    native encoder refuses the code (the caller then encodes in numpy,
    ``codec.huffman.encode_payload``)."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    cl = np.ascontiguousarray(code_len, np.uint8)
    cap = 2 * len(d8) + 4096
    out = np.empty(cap, np.uint8)
    n = L.zxch_pivco_encode(_ptr(d8), len(d8), _ptr(cl), _ptr(out), cap)
    return None if n < 0 else out[:n].tobytes()


def rle_encode_lit(lit: np.ndarray) -> bytes | None:
    """RLE literal-section emitter (enc_lit=1), native; None when the
    output would not fit its buffer."""
    L = lib()
    d8 = np.ascontiguousarray(lit, np.uint8)
    cap = 2 * len(d8) + 8
    out = np.empty(cap, np.uint8)
    n = L.zxch_rle_encode_lit(_ptr(d8), len(d8), _ptr(out), cap)
    return None if n < 0 else out[:n].tobytes()


def code_lengths(freq: np.ndarray, max_len: int) -> np.ndarray | None:
    """Package-merge code lengths (uint8[256], 0 = absent) for a 256-bin
    histogram, native; None for a histogram of another length or a cap
    the native package-merge refuses (above 15, or too small for the
    alphabet)."""
    L = lib()
    f = np.ascontiguousarray(freq, np.uint64)
    if len(f) != 256:
        return None
    cl = np.zeros(256, np.uint8)
    if L.zxch_code_lengths(_ptr(f), max_len, _ptr(cl)) < 0:
        return None
    return cl


def pivco_decode(payload: np.ndarray, n: int,
                 code_len: np.ndarray) -> np.ndarray:
    """PivCo section payload (no lengths header) -> ``n`` symbols; raises
    ZxcError(CORRUPT_DATA) on malformed input."""
    L = lib()
    src = np.ascontiguousarray(payload, np.uint8)
    cl = np.ascontiguousarray(code_len, np.uint8)
    out = np.empty(n, np.uint8)
    if L.zxch_pivco_decode(_ptr(src), len(src), _ptr(cl), n, _ptr(out)) != 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "PivCo section (native)")
    return out
