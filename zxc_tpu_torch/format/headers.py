"""File header and footer (FORMAT.md sections 3 and 8), the port's copy of
the readers in ``zxc_tpu.format.headers`` (reference parser:
zxc_common.c:546-720). Block headers are walked natively
(``zxch_walk_frame``)."""
from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import constants as C
from ..errors import (ZxcError, ERROR_SRC_TOO_SMALL, ERROR_BAD_MAGIC,
                      ERROR_BAD_VERSION, ERROR_BAD_HEADER,
                      ERROR_BAD_BLOCK_SIZE)
from .hashes import hash16


@dataclass
class FileHeader:
    block_size: int
    has_checksum: bool
    dict_id: int  # 0 when no dictionary


def read_file_header(src: bytes) -> FileHeader:
    if len(src) < C.FILE_HEADER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "file header truncated")
    magic, = struct.unpack_from("<I", src, 0)
    if magic != C.MAGIC_WORD:
        raise ZxcError(ERROR_BAD_MAGIC)
    if src[4] != C.FORMAT_VERSION:
        raise ZxcError(ERROR_BAD_VERSION, f"version {src[4]}")
    tmp = bytearray(src[:C.FILE_HEADER_SIZE])
    tmp[14] = tmp[15] = 0
    stored, = struct.unpack_from("<H", src, 14)
    if stored != hash16(bytes(tmp)) or (src[6] & 0x0F) != C.CHECKSUM_RAPIDHASH:
        raise ZxcError(ERROR_BAD_HEADER, "file header CRC16 / checksum id")
    code = src[5]
    if not (C.BLOCK_SIZE_MIN_LOG2 <= code <= C.BLOCK_SIZE_MAX_LOG2):
        raise ZxcError(ERROR_BAD_BLOCK_SIZE, f"chunk size code {code}")
    has_checksum = bool(src[6] & C.FLAG_HAS_CHECKSUM)
    dict_id = (struct.unpack_from("<I", src, 7)[0]
               if (src[6] & C.FLAG_HAS_DICTIONARY) else 0)
    return FileHeader(1 << code, has_checksum, dict_id)


def read_file_footer(src: bytes) -> tuple[int, int]:
    """Returns (original_source_size, global_hash) from the last 12 bytes."""
    if len(src) < C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "footer truncated")
    return struct.unpack_from("<QI", src, len(src) - C.FILE_FOOTER_SIZE)
