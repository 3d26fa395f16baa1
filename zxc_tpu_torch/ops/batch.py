"""Frame decode through the serial copy-engine route, the port of
``zxc_tpu.ops.batch`` (``FramePlan``, ``plan_frame`` and
``decompress(use_serial=True)``).

The host parses every block's sections (``plan_frame``: headers,
checksums, literal decode, varint extras), the native resolver flattens
each block's matches into pure pieces, ``ops.serial`` packs them into the
copy engine's control and the card runs one kernel per dispatch group:
v19 for blocks of 16 KiB and up, v13 below that.

Routes the JAX package has and the port does not yet raise
``NotImplementedError`` naming their ROADMAP item: the expansion kernels
(``use_serial=False``, or a block whose pieces exceed the resolver's
budget; queue 1 item 3), device entropy decode (queue 1 item 5) and the
attic kernels (queue 1 item 1).
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_CORRUPT_DATA, ERROR_OVERFLOW,
                      ERROR_BAD_HEADER, ERROR_SRC_TOO_SMALL,
                      ERROR_BAD_CHECKSUM, ERROR_DICT_REQUIRED,
                      ERROR_DICT_MISMATCH)
from ..format import headers
from ..format.hashes import global_hash_update
from ..format.dictionary import dict_id as compute_dict_id
from ..codec import block_decode, huffman
from ..codec.frame import DecodeOpts
from .. import runtime
from . import serial
from .device_pipeline import _device


@dataclass
class FramePlan:
    """Host-side section parse of a whole frame."""
    block_size: int
    ll: list = field(default_factory=list)       # per-block int32 (n_seq,)
    ml: list = field(default_factory=list)
    off: list = field(default_factory=list)
    lit: list = field(default_factory=list)      # per-block uint8 (lit_len,)
    totals: list = field(default_factory=list)   # decoded size per block
    dict_buf: np.ndarray | None = None
    decompressed_size: int = 0

    @property
    def n_blocks(self) -> int:
        return len(self.totals)


def _rapidhash32(data: np.ndarray) -> int:
    h = runtime.rapidhash64(data)
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def plan_frame(archive: bytes, opts: DecodeOpts | None = None) -> FramePlan:
    """Walk the frame and parse every block's sections on the host (the
    JAX package's ``plan_frame`` without ``defer_entropy``; the same
    fields and the same error codes)."""
    if len(archive) < C.FILE_HEADER_SIZE + C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL)
    fh = headers.read_file_header(archive)
    verify = bool(opts and opts.checksum) and fh.has_checksum

    dict_buf = dict_tree = None
    provided_id = 0
    if opts is not None and opts.dict_content:
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_tree = huffman.build_tree_packed(bytes(opts.dict_huf))
        provided_id = compute_dict_id(opts.dict_content, opts.dict_huf)
    if fh.dict_id != 0:
        if dict_buf is None:
            raise ZxcError(ERROR_DICT_REQUIRED)
        if provided_id != fh.dict_id:
            raise ZxcError(ERROR_DICT_MISMATCH)

    buf = np.frombuffer(archive, np.uint8)
    plan = FramePlan(block_size=fh.block_size, dict_buf=dict_buf)
    # pass 1: walk headers, collect payload spans, verify checksums
    spans: list[tuple[int, int, int]] = []   # (block_type, off, size)
    global_hash = 0
    pos = C.FILE_HEADER_SIZE
    saw_eof = False
    while pos + C.BLOCK_HEADER_SIZE <= len(archive):
        bh = headers.read_block_header(archive, pos)
        if bh.block_type == C.BLOCK_EOF:
            if bh.comp_size != 0:
                raise ZxcError(ERROR_BAD_HEADER, "EOF with non-zero comp_size")
            saw_eof = True
            break
        payload_off = pos + C.BLOCK_HEADER_SIZE
        tail = C.BLOCK_CHECKSUM_SIZE if fh.has_checksum else 0
        if payload_off + bh.comp_size + tail > len(archive):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block payload truncated")
        if bh.comp_size > C.compress_block_bound(fh.block_size):
            raise ZxcError(ERROR_CORRUPT_DATA, "comp_size exceeds block bound")
        if fh.has_checksum:
            end = payload_off + bh.comp_size
            stored = int(buf[end:end + 4].view("<u4")[0])
            if verify:
                if _rapidhash32(buf[payload_off:end]) != stored:
                    raise ZxcError(ERROR_BAD_CHECKSUM, "block payload checksum")
                global_hash = global_hash_update(global_hash, stored)
        spans.append((bh.block_type, payload_off, bh.comp_size))
        pos = payload_off + bh.comp_size + tail
    if not saw_eof:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "missing EOF block")

    # pass 2: parse block sections (native parsing releases the GIL)
    def parse_one(span):
        btype, p_off, p_size = span
        ll, ml, off, lit = block_decode.parse_block(
            btype, buf[p_off:p_off + p_size], fh.block_size, dict_tree)
        lit_used = int(ll.sum())
        if lit_used > len(lit):
            raise ZxcError(ERROR_OVERFLOW, "literal stream exhausted")
        total = int((ll + ml).sum()) + len(lit) - lit_used
        if total > fh.block_size:
            raise ZxcError(ERROR_OVERFLOW, "decoded size exceeds capacity")
        return (ll.astype(np.int32), ml.astype(np.int32),
                off.astype(np.int32), np.ascontiguousarray(lit), total)

    if len(spans) > 3:
        with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as ex:
            parsed = list(ex.map(parse_one, spans))
    else:
        parsed = [parse_one(s) for s in spans]
    for ll, ml, off, lit, total in parsed:
        plan.ll.append(ll)
        plan.ml.append(ml)
        plan.off.append(off)
        plan.lit.append(lit)
        plan.totals.append(total)
        plan.decompressed_size += total

    stored_size, stored_hash = headers.read_file_footer(archive)
    if stored_size != plan.decompressed_size:
        raise ZxcError(ERROR_CORRUPT_DATA, "footer size mismatch")
    if verify and stored_hash != global_hash:
        raise ZxcError(ERROR_BAD_CHECKSUM, "global hash mismatch")
    return plan


def resolve_serial(plan: FramePlan, workers: int | None = None):
    """Every block's pure pieces and literal buffer for the copy engine
    (``max_frag=1``: the kernels pay per piece, so every multi-piece
    source is materialized). Raises NotImplementedError when a block
    exceeds the resolver's piece budget: the JAX package decodes such a
    frame with its expansion kernels, which the port has not yet."""
    def one(i):
        return runtime.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                                      plan.lit[i], plan.dict_buf,
                                      device_pure=True, max_frag=1)

    with ThreadPoolExecutor(workers or min(os.cpu_count() or 1, 8)) as ex:
        res = list(ex.map(one, range(plan.n_blocks)))
    if any(r is None for r in res):
        raise NotImplementedError(
            "a block exceeds the piece budget: its decode needs the "
            "expansion kernels (ops/expand.py), ROADMAP queue 1 item 3")
    return [r[:4] for r in res], [r[4] for r in res]


def decompress(archive: bytes, opts: DecodeOpts | None = None, *,
               device=None, use_serial: bool = True, variant: int = 19,
               dispatch: int = 16, device_entropy: bool = False,
               _phases: dict | None = None) -> bytes:
    """One-shot frame decode through the serial copy-engine route.

    ``device``: None means ``cuda`` (raises when CUDA is absent); ``"cpu"``
    runs the kernels' plain versions. ``variant``: 19 (v13 still serves
    blocks under 16 KiB) or 13. ``_phases``, when given, receives wall
    seconds: ``plan`` (section parse), ``resolve`` (pieces), ``pack``
    (lane ops and packers), ``device`` (H2D, kernels, readback) and
    ``total``."""
    if not use_serial:
        raise NotImplementedError(
            "use_serial=False runs the expansion kernels (ops/expand.py), "
            "ROADMAP queue 1 item 3")
    if device_entropy:
        raise NotImplementedError(
            "device_entropy=True runs the device entropy decode "
            "(ops/pivco_device.py), ROADMAP queue 1 item 5")
    if variant not in (13, 19):
        raise NotImplementedError(
            f"serial variant {variant} is an attic kernel "
            "(tools/kernel_attic.py), ROADMAP queue 1 item 1")
    dev = _device(device)
    t0 = time.perf_counter()
    plan = plan_frame(archive, opts)
    t1 = time.perf_counter()
    pieces, lits = resolve_serial(plan)
    t2 = time.perf_counter()
    v13 = variant == 13 or plan.block_size < 16384
    groups = serial.pack_groups(pieces, lits, plan.totals, plan.block_size,
                                v13, dispatch) if pieces else []
    t3 = time.perf_counter()
    res = serial.decode_groups(groups, plan.totals, plan.block_size, v13,
                               dev) if groups else []
    t4 = time.perf_counter()
    if _phases is not None:
        _phases.update(plan=t1 - t0, resolve=t2 - t1, pack=t3 - t2,
                       device=t4 - t3, total=t4 - t0)
    return b"".join(res)
