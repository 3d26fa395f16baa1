"""File header, block header, GLO/GHI sub-header, seek table and footer
(FORMAT.md sections 3-5, 5.5 and 8), the port's copy of the readers and
writers in ``zxc_tpu.format.headers`` (reference writers and parsers:
zxc_common.c:546-720, zxc_seekable.c:172-411)."""
from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import constants as C
from ..errors import (ZxcError, ERROR_SRC_TOO_SMALL, ERROR_BAD_MAGIC,
                      ERROR_BAD_VERSION, ERROR_BAD_HEADER,
                      ERROR_BAD_BLOCK_SIZE)
from .hashes import hash8, hash16


def write_file_header(block_size: int, has_checksum: bool,
                      dict_id: int = 0) -> bytes:
    buf = bytearray(C.FILE_HEADER_SIZE)
    struct.pack_into("<I", buf, 0, C.MAGIC_WORD)
    buf[4] = C.FORMAT_VERSION
    buf[5] = C.block_size_code(block_size)
    flags = (C.FLAG_HAS_CHECKSUM | C.CHECKSUM_RAPIDHASH) if has_checksum else 0
    if dict_id != 0:
        flags |= C.FLAG_HAS_DICTIONARY
        struct.pack_into("<I", buf, 7, dict_id)
    buf[6] = flags
    struct.pack_into("<H", buf, 14, hash16(bytes(buf)))
    return bytes(buf)


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


def write_file_footer(src_size: int, global_hash: int,
                      checksum_enabled: bool) -> bytes:
    return struct.pack("<QI", src_size,
                       global_hash if checksum_enabled else 0)


def read_file_footer(src: bytes) -> tuple[int, int]:
    """Returns (original_source_size, global_hash) from the last 12 bytes."""
    if len(src) < C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "footer truncated")
    return struct.unpack_from("<QI", src, len(src) - C.FILE_FOOTER_SIZE)


def write_block_header(block_type: int, comp_size: int) -> bytes:
    buf = bytearray(C.BLOCK_HEADER_SIZE)
    buf[0] = block_type
    struct.pack_into("<I", buf, 3, comp_size)
    buf[7] = hash8(bytes(buf))
    return bytes(buf)


@dataclass
class BlockHeader:
    block_type: int
    comp_size: int


def read_block_header(src: bytes, pos: int = 0) -> BlockHeader:
    if len(src) - pos < C.BLOCK_HEADER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "block header truncated")
    hdr = bytes(src[pos:pos + C.BLOCK_HEADER_SIZE])
    tmp = bytearray(hdr)
    tmp[7] = 0
    if hdr[7] != hash8(bytes(tmp)):
        raise ZxcError(ERROR_BAD_HEADER, "block header CRC8")
    return BlockHeader(hdr[0], struct.unpack_from("<I", hdr, 3)[0])


@dataclass
class GnrHeader:
    n_sequences: int
    n_literals: int
    enc_lit: int
    enc_litlen: int
    enc_mlen: int
    enc_off: int


def write_gnr_header(gh: GnrHeader, descs: list[tuple[int, int]]) -> bytes:
    """Sub-header and descriptors; each desc is (comp_size, raw_size)."""
    out = bytearray(struct.pack("<II4B4x", gh.n_sequences, gh.n_literals,
                                gh.enc_lit, gh.enc_litlen, gh.enc_mlen,
                                gh.enc_off))
    for comp, raw in descs:
        out += struct.pack("<Q", (raw << 32) | comp)
    return bytes(out)


def read_gnr_header(payload: bytes, n_sections: int
                    ) -> tuple[GnrHeader, list[tuple[int, int]]]:
    """GLO/GHI sub-header and its section descriptors, each (comp_size,
    raw_size)."""
    need = C.GNR_HEADER_SIZE + n_sections * C.SECTION_DESC_SIZE
    if len(payload) < need:
        raise ZxcError(ERROR_BAD_HEADER, "GLO/GHI sub-header truncated")
    gh = GnrHeader(*struct.unpack_from("<II4B", payload, 0))
    descs = []
    for k in range(n_sections):
        packed, = struct.unpack_from("<Q", payload, C.GNR_HEADER_SIZE + 8 * k)
        descs.append((packed & 0xFFFFFFFF, packed >> 32))
    return gh, descs


def write_seek_table(comp_sizes: list[int]) -> bytes:
    """The SEK block: a block header and one uint32 compressed size a
    block."""
    body = struct.pack(f"<{len(comp_sizes)}I", *comp_sizes)
    return write_block_header(C.BLOCK_SEK, len(body)) + body


def parse_seek_table(archive: bytes) -> list[int] | None:
    """Backward SEK detection per FORMAT.md section 5.5; None when the
    archive has no seek table."""
    hdr = read_file_header(archive)
    dsize, _ = read_file_footer(archive)
    n = (dsize + hdr.block_size - 1) // hdr.block_size
    if n == 0:
        return None
    sek_size = C.BLOCK_HEADER_SIZE + n * C.SEEK_ENTRY_SIZE
    start = len(archive) - C.FILE_FOOTER_SIZE - sek_size
    if start < C.FILE_HEADER_SIZE:
        return None
    try:
        bh = read_block_header(archive, start)
    except ZxcError:
        return None
    if bh.block_type != C.BLOCK_SEK or bh.comp_size != n * C.SEEK_ENTRY_SIZE:
        return None
    off = start + C.BLOCK_HEADER_SIZE
    return list(struct.unpack_from(f"<{n}I", archive, off))
