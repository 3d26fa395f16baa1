"""Frame options and the native one-shot encoder.

``DecodeOpts`` / ``EncodeOpts`` and the level table are the port's copies
of ``zxc_tpu.codec.frame`` and ``zxc_tpu.codec.block_encode.level_params``
(``DecodeOpts`` without ``threads``: the port has no host decode yet).
``compress`` is the native frame encoder only (``zxch_compress_frame``,
byte-identical to ``zxc_tpu.codec.frame.compress``); without the native
library it raises — the port has no Python encoder.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..errors import ZxcError, ERROR_BAD_BLOCK_SIZE, ERROR_DICT_TOO_LARGE
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
