"""Native host runtime of the port: ctypes bindings to ``zxc_host.cpp``.

``zxc_host.cpp`` is a verbatim copy of ``zxc_tpu/runtime/zxc_host.cpp``
(standard headers and ``immintrin.h`` only) followed by the port's own
entries, after a banner at its end. This module binds the symbols
the device decode paths call: the frame walk and batched payload checksum,
the fused per-block prep of the copy engine's control
(``zxch_v19_prep_block`` / ``zxch_v26_prep_block``) and its hint-writing
form (``*_prep_block_plan``), the hint replay of the literal window
(``zxch_v19_lit8_load[_batch]``), the section parsers of ``plan_frame``
(RLE literals, varint extras, PivCo entropy), the piece resolver and
the lane-op and window-op splitters, the host block decoder
(``Seekable``), the host frame decoder (the hint body is itself a
frame, also in place), rapidhash64, the native frame encoder, the
section emitters of the device encoder's host half (PivCo encode, RLE
literals and package-merge code lengths) and its block emitter from
given sequences (``zxch_emit_block``) and its level-7 blocks from
per-position candidates (``zxch_opt_group``), the host block encoder's
matcher, parsers and fused GHI/GLO emitters, and the dictionary trainer.

Unlike ``zxc_tpu.runtime`` there is no pure-Python fallback: the port's
decode path has no Python prep, so a library that cannot be built or
loaded raises RuntimeError.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import constants as C
from ..buildlib import build_shared
from ..errors import (ZxcError, ERROR_BAD_OFFSET, ERROR_CORRUPT_DATA,
                      ERROR_NULL_INPUT, ERROR_OVERFLOW)

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
    L.zxch_dict_train.restype = i64
    L.zxch_dict_train.argtypes = [vp, vp, ci, u64, vp, u64]
    # the host block encoder's matcher, parsers and fused emitters
    L.zxch_find_matches.restype = ci
    L.zxch_find_matches.argtypes = [vp, u64, u64, ci, vp, vp]
    L.zxch_lazy_parse.restype = i64
    L.zxch_lazy_parse.argtypes = [vp, vp, u64, ci, ci, vp, vp, vp, u64]
    L.zxch_optimal_parse.restype = i64
    L.zxch_optimal_parse.argtypes = [vp, vp, u64, vp, vp, ci, ci, vp, vp,
                                     vp, vp, u64]
    L.zxch_find_parse.restype = i64
    L.zxch_find_parse.argtypes = [vp, u64, u64, ci, ci, ci, ci, ci, ci, ci,
                                  vp, vp, vp, u64]
    L.zxch_encode_ghi.restype = i64
    L.zxch_encode_ghi.argtypes = [vp, u64, u64, ci, ci, ci, ci, ci, ci, ci,
                                  vp, u64]
    L.zxch_encode_glo.restype = i64
    L.zxch_encode_glo.argtypes = [vp, u64, u64, ci, ci, ci, ci, ci, ci, ci,
                                  vp, vp, u64]
    # the device encoder's block emitter (the port's own entry)
    L.zxch_emit_block.restype = i64
    L.zxch_emit_block.argtypes = [vp, u64, ci, ci, vp, vp, vp, u64, i64, vp,
                                  u64, vp]
    # level 7 from per-position candidates (the port's own entry)
    L.zxch_opt_group.restype = i64
    L.zxch_opt_group.argtypes = [vp, u64, u64, ci, vp, ctypes.c_int32, vp, u64,
                                 vp, vp, vp, ci]


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


def walk_frame(src: np.ndarray, has_checksum: bool, block_size: int):
    """The frame's data blocks, walked by their headers from the file
    header to EOF (``zxch_walk_frame``): (pos, typ, comp), the offset of
    each block header (uint64), its type (uint8) and its payload size
    (uint64). Raises ZxcError with the walk's code on a malformed frame."""
    L = lib()
    max_blocks = len(src) // 8 + 2
    pos = np.empty(max_blocks, np.uint64)
    typ = np.empty(max_blocks, np.uint8)
    comp = np.empty(max_blocks, np.uint64)
    eof = ctypes.c_uint64(0)
    nb = L.zxch_walk_frame(_ptr(src), len(src), 1 if has_checksum else 0,
                           C.compress_block_bound(block_size),
                           C.FILE_HEADER_SIZE, _ptr(pos), _ptr(typ),
                           _ptr(comp), max_blocks, ctypes.byref(eof))
    if nb < 0:
        raise ZxcError(int(nb), "frame walk")
    nb = int(nb)
    return pos[:nb], typ[:nb], comp[:nb]


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


def dict_train(samples: list[bytes], target_size: int = 16384) -> bytes:
    """Native one-shot dictionary trainer (``zxch_dict_train``): the
    serialized ``.zxd`` (header, content, 128-byte shared table). Raises
    ZxcError with the trainer's code, or NULL_INPUT without samples."""
    if not samples:
        raise ZxcError(ERROR_NULL_INPUT, "no samples")
    L = lib()
    flat = b"".join(samples)
    sizes = np.array([len(s) for s in samples], np.uint64)
    cap = 16 + 65536 + 128
    out = ctypes.create_string_buffer(cap)
    rc = L.zxch_dict_train(ctypes.c_char_p(flat), _ptr(sizes), len(samples),
                           target_size, ctypes.cast(out, ctypes.c_void_p),
                           cap)
    if rc < 0:
        raise ZxcError(int(rc), "native dict train")
    return out.raw[:int(rc)]


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


def _parse_out(P: int):
    max_seq = P // 5 + 8
    return (max_seq, np.empty(max_seq, np.int32), np.empty(max_seq, np.int32),
            np.empty(max_seq, np.int32))


def _parsed(n: int, op, ol, oo, what: str):
    if n < 0:
        raise ZxcError(ERROR_OVERFLOW, f"native {what}: sequence buffer")
    return op[:n], ol[:n], oo[:n]


def _emitted(n: int, out: np.ndarray, what: str) -> bytes:
    if n < 0:
        raise ZxcError(ERROR_OVERFLOW, f"native {what}: output buffer")
    return out[:n].tobytes()


def find_matches(data: np.ndarray, start: int, max_probes: int):
    """Native hash-chain match finder (``zxch_find_matches``): the best
    (lens, offs) int32 candidate of every position of data[start:]."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    P = len(d8) - start
    lens = np.empty(max(P, 1), np.int32)
    offs = np.empty(max(P, 1), np.int32)
    L.zxch_find_matches(_ptr(d8), len(d8), start, max_probes, _ptr(lens),
                        _ptr(offs))
    return lens[:P], offs[:P]


def lazy_parse(lens: np.ndarray, offs: np.ndarray, lazy: bool,
               min_emit: int = 5):
    """Native greedy/lazy parse of per-position candidates: (pos, len, off)
    int32 arrays."""
    L = lib()
    lens32 = np.ascontiguousarray(lens, np.int32)
    offs32 = np.ascontiguousarray(offs, np.int32)
    max_seq, op, ol, oo = _parse_out(len(lens32))
    n = L.zxch_lazy_parse(_ptr(lens32), _ptr(offs32), len(lens32),
                          1 if lazy else 0, min_emit, _ptr(op), _ptr(ol),
                          _ptr(oo), max_seq)
    return _parsed(n, op, ol, oo, "lazy parse")


def optimal_parse(lens: np.ndarray, offs: np.ndarray, data: np.ndarray,
                  lit_cost_bits: np.ndarray, token_bits: int = 8,
                  only8: bool = False, tok_cost16=None):
    """DP optimal parse of levels 6-7 (``zxch_optimal_parse``): (pos, len,
    off) int32 arrays. ``tok_cost16`` prices a token by its match-length
    nibble (16 uint16 costs); ``only8`` keeps offsets within 256."""
    L = lib()
    lens32 = np.ascontiguousarray(lens, np.int32)
    offs32 = np.ascontiguousarray(offs, np.int32)
    d8 = np.ascontiguousarray(data, np.uint8)
    lc = np.ascontiguousarray(lit_cost_bits, np.uint16)
    tc = (None if tok_cost16 is None
          else np.ascontiguousarray(tok_cost16, np.uint16))
    max_seq, op, ol, oo = _parse_out(len(d8))
    n = L.zxch_optimal_parse(_ptr(lens32), _ptr(offs32), len(d8), _ptr(d8),
                             _ptr(lc), token_bits, 1 if only8 else 0,
                             None if tc is None else _ptr(tc), _ptr(op),
                             _ptr(ol), _ptr(oo), max_seq)
    return _parsed(n, op, ol, oo, "optimal parse")


def find_parse(data: np.ndarray, start: int, max_probes: int, lazy: bool,
               sufficient_len: int = 0, step_base: int = 1,
               step_shift: int = 0, cover_base: int = 1,
               min_emit: int = 5):
    """Combined native find + parse of levels 1-5 (``zxch_find_parse``):
    (pos, len, off) int32 arrays relative to ``start``."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    max_seq, op, ol, oo = _parse_out(len(d8) - start)
    n = L.zxch_find_parse(_ptr(d8), len(d8), start, max_probes,
                          1 if lazy else 0, sufficient_len, step_base,
                          step_shift, cover_base, min_emit, _ptr(op),
                          _ptr(ol), _ptr(oo), max_seq)
    return _parsed(n, op, ol, oo, "find parse")


def encode_ghi(data: np.ndarray, start: int, max_probes: int, lazy: bool,
               sufficient_len: int = 0, step_base: int = 1,
               step_shift: int = 0, cover_base: int = 1,
               min_emit: int = 5) -> bytes:
    """Fully native GHI payload (find, parse and emit in one call,
    ``zxch_encode_ghi``)."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    P = len(d8) - start
    cap = 16 + 24 + P + 4 * (P // 5 + 8) + 8
    out = np.empty(cap, np.uint8)
    n = L.zxch_encode_ghi(_ptr(d8), len(d8), start, max_probes,
                          1 if lazy else 0, sufficient_len, step_base,
                          step_shift, cover_base, min_emit, _ptr(out), cap)
    return _emitted(n, out, "GHI encode")


def encode_glo(data: np.ndarray, start: int, max_probes: int, lazy: bool,
               sufficient_len: int = 0, step_base: int = 1,
               step_shift: int = 0, cover_base: int = 1,
               min_emit: int = 5, dict_cl: np.ndarray | None = None
               ) -> bytes:
    """Fully native GLO payload of levels 1-5 (``zxch_encode_glo``: RAW,
    RLE and inline-Huffman literal pricing, and the shared table when
    ``dict_cl`` is given, ``data[:start]`` being the dictionary window)."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    P = len(d8) - start
    cap = 16 + 32 + 2 * P + 6 * (P // 5 + 8) + 64
    out = np.empty(cap, np.uint8)
    cl8 = None if dict_cl is None else np.ascontiguousarray(dict_cl,
                                                            np.uint8)
    n = L.zxch_encode_glo(_ptr(d8), len(d8), start, max_probes,
                          1 if lazy else 0, sufficient_len, step_base,
                          step_shift, cover_base, min_emit,
                          None if cl8 is None else _ptr(cl8), _ptr(out), cap)
    return _emitted(n, out, "GLO encode")


def emit_block(data: np.ndarray, level: int, checksum: bool, pos, lens,
               offs, cap_len: int = 0) -> tuple[bytes, np.ndarray]:
    """One dictionary-free block from given sequences in one native call
    (``zxch_emit_block``): block header, payload and, with ``checksum``,
    the payload's checksum, the bytes of
    ``codec.block_encode.encode_chunk_plain`` on the same sequences.
    Sequences of length ``cap_len`` and over (0: none) are extended first
    (``ops.encode._extend_capped_host``). Returns the block and the
    seconds of its four stages (cap extension, streams, literal auction,
    all-literal candidate). Raises ZxcError with the native code on
    sequences out of order, out of the block or with offsets out of
    range."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8)
    p, ln, o = (np.ascontiguousarray(a, np.int64) for a in (pos, lens, offs))
    if not len(p) == len(ln) == len(o):
        raise ValueError("pos, lens and offs differ in length")
    cap = len(d8) + 64
    out = np.empty(cap, np.uint8)
    stages = np.zeros(4, np.float64)
    # raw addresses rather than ``_ptr``: the call runs once a block
    n = L.zxch_emit_block(d8.ctypes.data, len(d8), level,
                          1 if checksum else 0, p.ctypes.data,
                          ln.ctypes.data, o.ctypes.data, len(p), cap_len,
                          out.ctypes.data, cap, stages.ctypes.data)
    if n < 0:
        raise ZxcError(int(n), "native block emit")
    return out[:n].tobytes(), stages


def opt_group(data: np.ndarray, block_size: int, checksum: bool,
              packed: np.ndarray, cap_len: int, threads: int):
    """The dictionary-free level-7 blocks of a dispatch group from every
    position's best candidate, in one native call on ``threads`` threads
    of its own (``zxch_opt_group``): ``data`` cut into blocks of
    ``block_size`` (the last may be shorter); ``packed`` one int32 a byte
    of data, ``len << 16 | (off - 1)``, ``len`` below 5 no match. Lengths
    of ``cap_len`` and over (0: none) are made exact first, then the
    level-7 pipeline of ``codec.block_encode`` runs from its lazy first
    pass on (the DP passes and the payload auction), and each block gets
    its header, payload and, with ``checksum``, the payload's checksum.
    Returns the blocks, each block's six stage clocks (B, 6: the
    candidates' check and cap extension, streams, literal auctions,
    all-literal candidate, first pass and cost table, DP passes) and two
    counts (B, 2: parses emitted, positions extended past the cap). The
    call holds no Python lock. Raises ZxcError with the native code of
    the first block that failed: a length past its block (-8), an offset
    out of range (-9)."""
    L = lib()
    d8 = np.ascontiguousarray(data, np.uint8).reshape(-1)
    pk = np.ascontiguousarray(packed, np.int32).reshape(-1)
    if len(pk) != len(d8) or block_size < 1:
        raise ValueError("packed needs one entry a byte of data")
    nb = -(-len(d8) // block_size)
    stride = block_size + 64
    out = np.empty((nb, stride), np.uint8)
    sizes = np.zeros(nb, np.int64)
    stages = np.zeros((nb, 6), np.float64)
    counts = np.zeros((nb, 2), np.int64)
    r = L.zxch_opt_group(d8.ctypes.data, len(d8), block_size,
                         1 if checksum else 0, pk.ctypes.data, cap_len,
                         out.ctypes.data, stride, sizes.ctypes.data,
                         stages.ctypes.data, counts.ctypes.data, threads)
    if r < 0:
        raise ZxcError(int(r), "native level-7 group")
    return ([out[j, :sizes[j]].tobytes() for j in range(nb)], stages,
            counts)


def decompress_frame_into(buffer: bytearray, comp_size: int,
                          block_size: int, has_checksum: bool, verify: bool,
                          dict_buf: np.ndarray | None = None,
                          dict_cl: np.ndarray | None = None) -> int:
    """True single-buffer in-place decode: the archive sits flush-right in
    ``buffer`` (a bytearray) and its decoded bytes land at
    ``buffer[0:dsize]``. The caller has checked the in-place margin
    (``codec.frame.decompress_inplace``), which keeps the write cursor at
    least 32 bytes behind the archive's read cursor, past the decoder's
    wild-copy overshoot. Returns dsize; raises ZxcError with the native
    code on malformed input."""
    L = lib()
    n = len(buffer)
    # buf_t holds the bytearray's export through the call, so a resize
    # from another thread raises BufferError instead of freeing the memory
    # the decoder writes
    buf_t = (ctypes.c_uint8 * n).from_buffer(buffer)
    base = ctypes.addressof(buf_t)
    d8, cl8, cl_ptr = _as_dict_args(dict_buf, dict_cl)
    w = L.zxch_decompress_frame(base + n - comp_size, comp_size, block_size,
                                1 if has_checksum else 0, 1 if verify else 0,
                                _ptr(d8), len(d8), cl_ptr, base, n)
    if w < 0:
        raise ZxcError(int(w), "native in-place decode")
    return int(w)
