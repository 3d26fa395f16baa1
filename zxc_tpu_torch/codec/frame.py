"""Frame options, the native one-shot encoder and the native host decoder.

``DecodeOpts`` / ``EncodeOpts`` and the level table are the port's copies
of ``zxc_tpu.codec.frame`` and ``zxc_tpu.codec.block_encode.level_params``
(``DecodeOpts`` without ``threads``: ``decompress`` takes it as an
argument). ``compress`` is the native frame encoder only
(``zxch_compress_frame``, byte-identical to ``zxc_tpu.codec.frame.compress``)
and ``decompress`` the native frame decoder only (``zxch_decompress_frame``);
without the native library both raise — the port has no Python codec.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_BAD_BLOCK_SIZE, ERROR_DICT_TOO_LARGE,
                      ERROR_SRC_TOO_SMALL, ERROR_DICT_REQUIRED,
                      ERROR_DICT_MISMATCH, ERROR_DST_TOO_SMALL,
                      ERROR_CORRUPT_DATA)
from ..format import headers
from ..format.dictionary import dict_id as compute_dict_id
from .. import runtime
from . import huffman


@dataclass
class DecodeOpts:
    checksum: bool = False         # verify per-block + global checksums
    dict_content: bytes | None = None
    dict_huf: bytes | None = None  # 128-byte packed shared table


@dataclass
class EncodeOpts:
    level: int = C.LEVEL_DEFAULT
    block_size: int = C.BLOCK_SIZE_DEFAULT
    checksum: bool = False
    seekable: bool = False
    dict_content: bytes | None = None
    dict_huf: bytes | None = None
    threads: int = 1               # >1: native MT per-block fan-out


@dataclass
class LevelParams:
    n_candidates: int
    lazy: bool
    max_code_len: int  # Huffman cap (8 below ULTRA, 11 at ULTRA)
    sufficient_len: int = 0  # chain-walk early exit (0 = unbounded)
    step_base: int = 1      # miss-path skip: step_base + (run >> step_shift)
    step_shift: int = 0     # 0 = no acceleration
    cover_base: int = 1     # chain-insert stride inside emitted matches
    min_emit: int = 5       # shortest match the parse will emit


_LEVELS = {
    1: LevelParams(2, False, 8, 12, 1, 4, 6),
    2: LevelParams(2, False, 8, 12, 1, 4, 6),
    3: LevelParams(5, False, 8, 32, 1, 5, 4),
    4: LevelParams(8, False, 8, 64, cover_base=2),
    5: LevelParams(12, True, 8, 96, cover_base=2),
    6: LevelParams(64, True, 8),
    7: LevelParams(128, True, 11),
}


def level_params(level: int) -> LevelParams:
    """Search depth / lazy / early-exit per level (reference table:
    zxc_internal.h:951 zxc_get_lz77_params, retuned in the JAX package's
    encoder; the values must match it so both encoders emit equal bytes)."""
    return _LEVELS[max(C.LEVEL_MIN, min(C.LEVEL_MAX, level))]


def compress(data: bytes, opts: EncodeOpts | None = None) -> bytes:
    """One-shot frame encode (zxc_compress equivalent) through the native
    library. Raises ZxcError on bad options or an encoder error, and
    RuntimeError when the native library cannot be built or loaded."""
    opts = opts or EncodeOpts()
    level = max(C.LEVEL_MIN, min(C.LEVEL_MAX, opts.level or C.LEVEL_DEFAULT))
    block_size = opts.block_size or C.BLOCK_SIZE_DEFAULT
    try:
        code = C.block_size_code(block_size)
    except ValueError:
        raise ZxcError(ERROR_BAD_BLOCK_SIZE) from None
    dict_buf = dict_cl = None
    did = 0
    if opts.dict_content:
        if len(opts.dict_content) > C.DICT_SIZE_MAX:
            raise ZxcError(ERROR_DICT_TOO_LARGE)
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_cl = huffman.unpack_lengths(bytes(opts.dict_huf))
        did = compute_dict_id(opts.dict_content, opts.dict_huf)
    p = level_params(level)
    return runtime.compress_frame(
        np.frombuffer(data, np.uint8), level, p.n_candidates, p.lazy,
        p.sufficient_len, p.step_base, p.step_shift, p.cover_base,
        block_size, code, opts.checksum, opts.seekable, p.min_emit,
        dict_buf=dict_buf, dict_cl=dict_cl, dict_id=did,
        threads=opts.threads)


def get_decompressed_size(archive: bytes) -> int:
    """Footer-derived size, after the file header's checks
    (zxc_get_decompressed_size)."""
    headers.read_file_header(archive)
    return headers.read_file_footer(archive)[0]


def decompress(archive: bytes, opts: DecodeOpts | None = None, *,
               threads: int = 1, out: np.ndarray | None = None):
    """One-shot host frame decode through the native library
    (``zxch_decompress_frame``; ``threads`` > 1 uses its worker pool, with
    identical output). Returns ``bytes``, or the byte count when the
    decoded bytes land in ``out`` (a writable 1-D uint8 array). Raises
    ZxcError with the native code on malformed input."""
    if len(archive) < C.FILE_HEADER_SIZE + C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL)
    fh = headers.read_file_header(archive)
    verify = bool(opts and opts.checksum) and fh.has_checksum
    dict_buf = dict_cl = None
    provided_id = 0
    if opts is not None and opts.dict_content:
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_cl = huffman.build_tree_packed(bytes(opts.dict_huf)).code_len
        provided_id = compute_dict_id(opts.dict_content, opts.dict_huf)
    if fh.dict_id != 0:
        if dict_buf is None:
            raise ZxcError(ERROR_DICT_REQUIRED)
        if provided_id != fh.dict_id:
            raise ZxcError(ERROR_DICT_MISMATCH)
    src = np.frombuffer(archive, np.uint8)
    dsize = headers.read_file_footer(archive)[0]
    # every block header takes 8 bytes, so a footer claiming more than
    # that many blocks' worth of output lies (and must not size a buffer)
    if dsize > len(src) // C.BLOCK_HEADER_SIZE * fh.block_size:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "footer size exceeds the frame")
    dst = np.empty(dsize, np.uint8) if out is None else out
    if dst.nbytes < dsize:
        raise ZxcError(ERROR_DST_TOO_SMALL,
                       f"out holds {dst.nbytes} bytes, need {dsize}")
    w = runtime.decompress_frame(src, fh.block_size, fh.has_checksum,
                                 verify, dst[:dsize], dict_buf, dict_cl,
                                 threads)
    if w != dsize:
        raise ZxcError(ERROR_CORRUPT_DATA, "footer size mismatch")
    return w if out is not None else dst.tobytes()
