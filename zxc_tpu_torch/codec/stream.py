"""Multi-threaded FILE streaming pipeline, the port of
``zxc_tpu.codec.stream``.

The reference's zxc_driver.c runs a reader thread, N worker threads with
thread-local contexts, and an ordering writer over a ring buffer
(:639-1035). Here the same pipeline is a bounded pipelined map: the reader
slices blocks, a thread pool encodes or decodes them (the native encoder,
decoder and checksum release the GIL), and results are written strictly
in order: ``ThreadPoolExecutor.map`` over a bounded window is the ring
buffer. The archive bytes are the same at every thread count.
"""
from __future__ import annotations

import io
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_SRC_TOO_SMALL, ERROR_BAD_HEADER,
                      ERROR_CORRUPT_DATA, ERROR_BAD_CHECKSUM,
                      ERROR_DICT_REQUIRED, ERROR_DICT_MISMATCH)
from ..format import headers
from .. import runtime
from ..format.hashes import global_hash_update
from ..format.dictionary import dict_id as compute_dict_id
from . import block_encode, block_decode, huffman
from .frame import EncodeOpts, DecodeOpts, block_size_code

MAX_THREADS = 512  # parity with ZXC_MAX_THREADS (zxc_constants.h:94)


def _n_workers(n_threads: int) -> int:
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    return max(1, min(n_threads, MAX_THREADS))


def _ordered_map(ex: ThreadPoolExecutor, fn, items, window: int):
    """``fn`` over ``items`` on the pool, results in input order, with at
    most ``window`` calls in flight: the ring buffer. (``Executor.map``
    submits its whole input before it yields, so it reads the whole
    source first.)"""
    pending: deque = deque()
    for item in items:
        pending.append(ex.submit(fn, item))
        if len(pending) >= window:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def stream_compress(src, dst, opts: EncodeOpts | None = None,
                    n_threads: int = 0, progress=None,
                    total_bytes: int = 0) -> int:
    """Compress file-like ``src`` into file-like ``dst``; returns bytes
    written (zxc_stream_compress equivalent).

    ``progress(bytes_processed, bytes_total)`` mirrors
    zxc_progress_callback_t (include/zxc_opts.h:34-47): invoked from the
    writer side after each block, with input-side byte counts;
    ``bytes_total`` is ``total_bytes`` (0 = unknown, e.g. a pipe)."""
    opts = opts or EncodeOpts()
    block_size = opts.block_size or C.BLOCK_SIZE_DEFAULT
    block_size_code(block_size)
    level = max(C.LEVEL_MIN, min(C.LEVEL_MAX, opts.level or C.LEVEL_DEFAULT))
    dict_state = None
    did = 0
    if opts.dict_content:
        dict_state = block_encode.DictState(
            np.frombuffer(opts.dict_content, np.uint8), opts.dict_huf)
        did = compute_dict_id(opts.dict_content, opts.dict_huf)

    written = 0

    def w(b: bytes):
        nonlocal written
        dst.write(b)
        written += len(b)

    w(headers.write_file_header(block_size, opts.checksum, did))

    def read_blocks():
        while True:
            chunk = src.read(block_size)
            if not chunk:
                return
            yield chunk

    def encode_one(chunk: bytes) -> bytes:
        return block_encode.encode_chunk(np.frombuffer(chunk, np.uint8),
                                         level, dict_state, opts.checksum)

    global_hash = 0
    seek_sizes: list[int] = []
    total_in = 0
    workers = _n_workers(n_threads)
    with ThreadPoolExecutor(workers) as ex:
        blocks_in: list[int] = []

        def sized(gen):
            for chunk in gen:
                blocks_in.append(len(chunk))
                yield chunk

        n_done = 0
        done_in = 0
        for blk in _ordered_map(ex, encode_one, sized(read_blocks()),
                                2 * workers):
            if opts.checksum:
                stored = int.from_bytes(blk[-4:], "little")
                global_hash = global_hash_update(global_hash, stored)
            seek_sizes.append(len(blk))
            w(blk)
            done_in += blocks_in[n_done]
            n_done += 1
            if progress is not None:
                progress(done_in, total_bytes)
        total_in = sum(blocks_in)

    w(headers.write_block_header(C.BLOCK_EOF, 0))
    if opts.seekable and seek_sizes:
        w(headers.write_seek_table(seek_sizes))
    w(headers.write_file_footer(total_in, global_hash, opts.checksum))
    return written


def stream_decompress(src, dst, opts: DecodeOpts | None = None,
                      n_threads: int = 0, progress=None,
                      total_bytes: int = 0) -> int:
    """Decompress file-like ``src`` into ``dst``; returns bytes written.

    ``progress(bytes_processed, bytes_total)`` is called after each block
    is written with decompressed-output byte counts (writer side, cf.
    zxc_progress_callback_t)."""
    opts = opts or DecodeOpts()
    head = src.read(C.FILE_HEADER_SIZE)
    fh = headers.read_file_header(head)
    verify = opts.checksum and fh.has_checksum
    dict_buf = dict_tree = None
    if opts.dict_content:
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_tree = huffman.build_tree(huffman.unpack_lengths(opts.dict_huf))
    if fh.dict_id != 0:
        if dict_buf is None:
            raise ZxcError(ERROR_DICT_REQUIRED)
        if compute_dict_id(opts.dict_content, opts.dict_huf) != fh.dict_id:
            raise ZxcError(ERROR_DICT_MISMATCH)

    tail = C.BLOCK_CHECKSUM_SIZE if fh.has_checksum else 0
    global_hash = 0
    produced = 0

    def read_payloads():
        nonlocal global_hash
        while True:
            hdr = src.read(C.BLOCK_HEADER_SIZE)
            if len(hdr) < C.BLOCK_HEADER_SIZE:
                raise ZxcError(ERROR_SRC_TOO_SMALL, "missing EOF block")
            bh = headers.read_block_header(hdr)
            if bh.block_type == C.BLOCK_EOF:
                if bh.comp_size != 0:
                    raise ZxcError(ERROR_BAD_HEADER, "EOF with payload")
                return
            if bh.comp_size > C.compress_block_bound(fh.block_size):
                raise ZxcError(ERROR_CORRUPT_DATA, "comp_size exceeds bound")
            payload = src.read(bh.comp_size + tail)
            if len(payload) < bh.comp_size + tail:
                raise ZxcError(ERROR_SRC_TOO_SMALL, "block payload truncated")
            stored = None
            if tail:
                stored = int.from_bytes(payload[bh.comp_size:], "little")
                if verify:
                    global_hash = global_hash_update(global_hash, stored)
            yield bh.block_type, payload[:bh.comp_size], stored

    def decode_one(item):
        btype, payload, stored = item
        arr = np.frombuffer(payload, np.uint8)
        if verify and stored is not None:
            if runtime.rapidhash32(payload) != stored:
                raise ZxcError(ERROR_BAD_CHECKSUM, "block payload checksum")
        # written via the buffer protocol — no tobytes() copy per block
        return block_decode.decode_block(btype, arr, fh.block_size,
                                         dict_buf, dict_tree)

    workers = _n_workers(n_threads)
    with ThreadPoolExecutor(workers) as ex:
        for out in _ordered_map(ex, decode_one, read_payloads(), 2 * workers):
            dst.write(out)
            produced += len(out)
            if progress is not None:
                progress(produced, total_bytes)

    # trailing: optional SEK then footer
    rest = src.read()
    if len(rest) >= C.BLOCK_HEADER_SIZE:
        try:
            bh = headers.read_block_header(rest)
            if bh.block_type == C.BLOCK_SEK:
                rest = rest[C.BLOCK_HEADER_SIZE + bh.comp_size:]
        except ZxcError:
            pass
    if len(rest) < C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "footer truncated")
    size, ghash = headers.read_file_footer(rest)
    if size != produced:
        raise ZxcError(ERROR_CORRUPT_DATA, "footer size mismatch")
    if verify and ghash != global_hash:
        raise ZxcError(ERROR_BAD_CHECKSUM, "global hash mismatch")
    return produced


def stream_get_decompressed_size(src) -> int:
    """Footer-derived size from a seekable file object
    (zxc_stream_get_decompressed_size equivalent)."""
    pos = src.tell()
    try:
        src.seek(0, io.SEEK_END)
        end = src.tell()
        if end < C.FILE_HEADER_SIZE + C.FILE_FOOTER_SIZE:
            raise ZxcError(ERROR_SRC_TOO_SMALL)
        src.seek(end - C.FILE_FOOTER_SIZE)
        size, _ = headers.read_file_footer(src.read(C.FILE_FOOTER_SIZE))
        return size
    finally:
        src.seek(pos)


def compress_file(src_path: str, dst_path: str,
                  opts: EncodeOpts | None = None, n_threads: int = 0) -> int:
    with open(src_path, "rb") as s, open(dst_path, "wb") as d:
        return stream_compress(s, d, opts, n_threads)


def decompress_file(src_path: str, dst_path: str,
                    opts: DecodeOpts | None = None, n_threads: int = 0) -> int:
    with open(src_path, "rb") as s, open(dst_path, "wb") as d:
        return stream_decompress(s, d, opts, n_threads)
