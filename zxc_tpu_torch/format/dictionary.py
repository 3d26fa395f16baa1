"""Pre-trained dictionaries: the dictionary id and the ``.zxd`` container
(FORMAT.md section 12; reference: zxc_dict.c), the port's copy of
``zxc_tpu.format.dictionary``."""
from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_BAD_MAGIC, ERROR_BAD_VERSION,
                      ERROR_BAD_HEADER, ERROR_SRC_TOO_SMALL,
                      ERROR_DICT_TOO_LARGE)
from .hashes import rapidhash32, rapidhash64, hash16


@lru_cache(maxsize=64)
def dict_id(content: bytes, huf_lengths: bytes | None = None) -> int:
    """32-bit id binding the (content, table) pair: the content checksum
    seeds the table checksum (zxc_dict.c:36-45). Memoized: callers hash
    the same dictionary once per process, not once per frame."""
    if not content:
        return 0
    base = rapidhash32(content)
    if huf_lengths is None:
        return base
    h = rapidhash64(huf_lengths[:C.HUF_TABLE_SIZE], base)
    return (h ^ (h >> 32)) & 0xFFFFFFFF


@dataclass
class Dictionary:
    content: bytes
    huf_lengths: bytes  # 128-byte packed code lengths (always in a .zxd)

    @property
    def id(self) -> int:
        return dict_id(self.content, self.huf_lengths)

    @property
    def content_array(self) -> np.ndarray:
        return np.frombuffer(self.content, np.uint8)

    def save(self) -> bytes:
        """The ``.zxd`` bytes: 16-byte header, content, shared table."""
        if len(self.content) > C.DICT_SIZE_MAX:
            raise ZxcError(ERROR_DICT_TOO_LARGE)
        if len(self.huf_lengths) != C.HUF_TABLE_SIZE:
            raise ValueError(f"huf_lengths holds {len(self.huf_lengths)} "
                             f"bytes, not {C.HUF_TABLE_SIZE}")
        hdr = bytearray(C.DICT_HEADER_SIZE)
        struct.pack_into("<I", hdr, 0, C.DICT_MAGIC)
        hdr[4] = C.DICT_FORMAT_VERSION
        hdr[5] = C.CHECKSUM_RAPIDHASH
        struct.pack_into("<H", hdr, 6, len(self.content))
        struct.pack_into("<I", hdr, 8, self.id)
        # CRC16 computed with bytes 0x0C..0x0F zeroed, stored at 0x0E
        struct.pack_into("<H", hdr, 14, hash16(bytes(hdr)))
        return bytes(hdr) + self.content + self.huf_lengths

    @classmethod
    def load(cls, buf: bytes) -> "Dictionary":
        """Parse and check a ``.zxd``; raises ZxcError with the JAX
        package's codes."""
        if len(buf) < C.DICT_HEADER_SIZE:
            raise ZxcError(ERROR_SRC_TOO_SMALL, ".zxd truncated")
        magic, = struct.unpack_from("<I", buf, 0)
        if magic != C.DICT_MAGIC:
            raise ZxcError(ERROR_BAD_MAGIC, "not a .zxd file")
        if buf[4] != C.DICT_FORMAT_VERSION:
            raise ZxcError(ERROR_BAD_VERSION, f"dict version {buf[4]}")
        if (buf[5] & 0x0F) != C.CHECKSUM_RAPIDHASH:
            raise ZxcError(ERROR_BAD_HEADER, "dict checksum id")
        size, = struct.unpack_from("<H", buf, 6)
        stored_id, = struct.unpack_from("<I", buf, 8)
        tmp = bytearray(buf[:C.DICT_HEADER_SIZE])
        tmp[12:16] = b"\x00" * 4
        if struct.unpack_from("<H", buf, 14)[0] != hash16(bytes(tmp)):
            raise ZxcError(ERROR_BAD_HEADER, "dict header CRC16")
        end = C.DICT_HEADER_SIZE + size
        if len(buf) < end + C.HUF_TABLE_SIZE:
            raise ZxcError(ERROR_SRC_TOO_SMALL, ".zxd content truncated")
        d = cls(bytes(buf[C.DICT_HEADER_SIZE:end]),
                bytes(buf[end:end + C.HUF_TABLE_SIZE]))
        if d.id != stored_id:
            raise ZxcError(ERROR_BAD_HEADER, "dict id mismatch with content")
        return d
