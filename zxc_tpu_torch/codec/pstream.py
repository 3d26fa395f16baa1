"""Push streaming: caller-driven, reentrant state machines, the port of
``zxc_tpu.codec.pstream``.

Mirrors the reference pstream subsystem (zxc_pstream.c): compress
CS_INIT -> DRAIN_HEADER -> ACCUMULATE -> DRAIN_BLOCK -> ... -> DRAIN_FOOTER
-> DONE/ERRORED (:69-78), sticky errors (:147-160), drain/resume with
caller-sized output windows, decompress header -> block-header -> payload ->
EOF -> optional-SEK-skip -> footer (:1053+). Dictionary options are
rejected, matching zxc_pstream.h:123-137 (the push path has no dict_id
handshake).

Callers may push one byte at a time and drain into one-byte windows;
state is kept across calls. Blocks are encoded by the host block encoder
(``block_encode.encode_chunk``) and decoded by the native block decoder;
payload checksums are the native rapidhash32. Without the native library
these raise.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_BAD_HEADER, ERROR_CORRUPT_DATA,
                      ERROR_SRC_TOO_SMALL, ERROR_BAD_CHECKSUM,
                      ERROR_DICT_REQUIRED)
from ..format import headers
from .. import runtime
from ..format.hashes import global_hash_update
from . import block_decode, block_encode
from .frame import block_size_code


class CStream:
    """Push compressor (zxc_cstream_t equivalent).

    ``compress(src, dst_capacity)`` consumes as much of ``src`` as fits the
    current block and returns up to ``dst_capacity`` produced bytes;
    ``end(dst_capacity)`` flushes the final partial block, EOF, optional
    seek table and footer. Both are reentrant — call until drained.
    """

    def __init__(self, level: int = C.LEVEL_DEFAULT,
                 block_size: int = C.BLOCK_SIZE_DEFAULT,
                 checksum: bool = False, seekable: bool = False,
                 dict_content: bytes | None = None):
        if dict_content is not None:
            raise ZxcError(ERROR_DICT_REQUIRED,
                           "dictionaries are not supported in the push path")
        block_size_code(block_size)
        self.level = max(C.LEVEL_MIN, min(C.LEVEL_MAX, level))
        self.block_size = block_size
        self.checksum = checksum
        self.seekable = seekable
        self._acc = bytearray()
        self._pending = bytearray(headers.write_file_header(block_size, checksum))
        self._global_hash = 0
        self._seek_sizes: list[int] = []
        self._total_in = 0
        self._ended = False
        self._done = False
        self._error: ZxcError | None = None

    def _sticky(self):
        if self._error is not None:
            raise self._error

    def _encode_block(self, data: bytes) -> None:
        blk = block_encode.encode_chunk(np.frombuffer(data, np.uint8),
                                        self.level, checksum=self.checksum)
        if self.checksum:
            stored = int.from_bytes(blk[-4:], "little")
            self._global_hash = global_hash_update(self._global_hash, stored)
        self._seek_sizes.append(len(blk))
        self._pending += blk

    def compress(self, src: bytes, dst_capacity: int) -> tuple[bytes, int]:
        """Returns (produced, src_consumed)."""
        self._sticky()
        if self._ended:
            raise ZxcError(ERROR_BAD_HEADER, "compress after end")
        consumed = 0
        while consumed < len(src):
            room = self.block_size - len(self._acc)
            take = min(room, len(src) - consumed)
            self._acc += src[consumed:consumed + take]
            consumed += take
            if len(self._acc) == self.block_size:
                self._encode_block(bytes(self._acc))
                self._acc.clear()
        self._total_in += consumed
        out = bytes(self._pending[:dst_capacity])
        del self._pending[:dst_capacity]
        return out, consumed

    def end(self, dst_capacity: int) -> bytes:
        """Flush; call until ``finished``."""
        self._sticky()
        if not self._ended:
            self._ended = True
            if self._acc:
                self._encode_block(bytes(self._acc))
                self._acc.clear()
            self._pending += headers.write_block_header(C.BLOCK_EOF, 0)
            if self.seekable and self._seek_sizes:
                self._pending += headers.write_seek_table(self._seek_sizes)
            self._pending += headers.write_file_footer(
                self._total_in, self._global_hash, self.checksum)
        out = bytes(self._pending[:dst_capacity])
        del self._pending[:dst_capacity]
        if not self._pending:
            self._done = True
        return out

    @property
    def finished(self) -> bool:
        return self._done

    def recommended_in_size(self) -> int:
        return self.block_size

    def recommended_out_size(self) -> int:
        return C.compress_block_bound(self.block_size)


# decompress states
_DS_HEADER = 0
_DS_BLOCK_HEADER = 1
_DS_PAYLOAD = 2
_DS_AFTER_EOF = 3
_DS_DONE = 4


class DStream:
    """Push decompressor (zxc_dstream_t equivalent).

    Feed arbitrary byte chunks with ``decompress``; drain decoded bytes
    through the returned windows. Handles seekable archives by skipping the
    SEK block (passthrough), verifies checksums when enabled.
    """

    def __init__(self, checksum: bool = False,
                 dict_content: bytes | None = None):
        if dict_content is not None:
            raise ZxcError(ERROR_DICT_REQUIRED,
                           "dictionaries are not supported in the push path")
        self.verify = checksum
        self._buf = bytearray()     # unconsumed input
        self._out = bytearray()     # decoded, not yet drained
        self._state = _DS_HEADER
        self._header: headers.FileHeader | None = None
        self._bh: headers.BlockHeader | None = None
        self._global_hash = 0
        self._produced = 0
        self._error: ZxcError | None = None

    def _sticky(self):
        if self._error is not None:
            raise self._error

    def _fail(self, code: int, msg: str = ""):
        self._error = ZxcError(code, msg)
        raise self._error

    def _step(self) -> bool:
        """One state transition if enough input; False = need more bytes."""
        b = self._buf
        if self._state == _DS_HEADER:
            if len(b) < C.FILE_HEADER_SIZE:
                return False
            try:
                self._header = headers.read_file_header(bytes(b[:C.FILE_HEADER_SIZE]))
            except ZxcError as e:
                self._error = e
                raise
            if self._header.dict_id != 0:
                self._fail(ERROR_DICT_REQUIRED,
                           "dictionary frames unsupported in push path")
            del b[:C.FILE_HEADER_SIZE]
            self._state = _DS_BLOCK_HEADER
            return True
        if self._state == _DS_BLOCK_HEADER:
            if len(b) < C.BLOCK_HEADER_SIZE:
                return False
            try:
                bh = headers.read_block_header(bytes(b[:C.BLOCK_HEADER_SIZE]))
            except ZxcError as e:
                self._error = e
                raise
            self._bh = bh
            del b[:C.BLOCK_HEADER_SIZE]
            if bh.block_type == C.BLOCK_EOF:
                if bh.comp_size != 0:
                    self._fail(ERROR_BAD_HEADER, "EOF with non-zero comp_size")
                self._state = _DS_AFTER_EOF
            else:
                if bh.comp_size > C.compress_block_bound(self._header.block_size):
                    self._fail(ERROR_CORRUPT_DATA, "comp_size exceeds bound")
                self._state = _DS_PAYLOAD
            return True
        if self._state == _DS_PAYLOAD:
            tail = C.BLOCK_CHECKSUM_SIZE if self._header.has_checksum else 0
            need = self._bh.comp_size + tail
            if len(b) < need:
                return False
            payload = np.frombuffer(bytes(b[:self._bh.comp_size]), np.uint8)
            stored = None
            if tail:
                stored = int.from_bytes(bytes(b[self._bh.comp_size:need]), "little")
                if self.verify:
                    if runtime.rapidhash32(payload) != stored:
                        self._fail(ERROR_BAD_CHECKSUM, "block payload checksum")
                    self._global_hash = global_hash_update(self._global_hash, stored)
            try:
                out = block_decode.decode_block(
                    self._bh.block_type, payload, self._header.block_size)
            except ZxcError as e:
                self._error = e
                raise
            self._out += out.tobytes()
            self._produced += len(out)
            del b[:need]
            self._state = _DS_BLOCK_HEADER
            return True
        if self._state == _DS_AFTER_EOF:
            # optional SEK block, then 12-byte footer: wait for enough bytes
            # to disambiguate (SEK header parse) or finish on footer.
            if len(b) >= C.BLOCK_HEADER_SIZE:
                try:
                    bh = headers.read_block_header(bytes(b[:C.BLOCK_HEADER_SIZE]))
                    is_sek = bh.block_type == C.BLOCK_SEK
                except ZxcError:
                    is_sek = False
                if is_sek:
                    need = C.BLOCK_HEADER_SIZE + bh.comp_size
                    if len(b) < need:
                        return False
                    del b[:need]  # skip seek table
                    return True
            if len(b) < C.FILE_FOOTER_SIZE:
                return False
            if len(b) != C.FILE_FOOTER_SIZE:
                # trailing garbage after footer is corrupt framing; but we
                # may simply not have seen the SEK fully yet
                if len(b) < C.BLOCK_HEADER_SIZE:
                    return False
                self._fail(ERROR_CORRUPT_DATA, "unexpected bytes after EOF")
            size, ghash = headers.read_file_footer(bytes(b))
            if size != self._produced:
                self._fail(ERROR_CORRUPT_DATA, "footer size mismatch")
            if self.verify and self._header.has_checksum and ghash != self._global_hash:
                self._fail(ERROR_BAD_CHECKSUM, "global hash mismatch")
            del b[:]
            self._state = _DS_DONE
            return True
        return False

    def decompress(self, src: bytes, dst_capacity: int) -> tuple[bytes, int]:
        """Feed ``src``; returns (produced up to dst_capacity, consumed).

        The stream always consumes all of ``src`` (it buffers internally,
        like the reference's bounce buffer); drain by calling again with
        ``b""`` until no output remains.
        """
        self._sticky()
        if self._state == _DS_DONE and src:
            self._fail(ERROR_CORRUPT_DATA, "input after frame end")
        self._buf += src
        while self._state != _DS_DONE and self._step():
            pass
        out = bytes(self._out[:dst_capacity])
        del self._out[:dst_capacity]
        return out, len(src)

    @property
    def finished(self) -> bool:
        """True once the footer validated and all output was drained."""
        return self._state == _DS_DONE and not self._out

    def recommended_in_size(self) -> int:
        bs = self._header.block_size if self._header else C.BLOCK_SIZE_DEFAULT
        return C.compress_block_bound(bs)

    def recommended_out_size(self) -> int:
        return self._header.block_size if self._header else C.BLOCK_SIZE_DEFAULT


def stream_compress(src: bytes, level: int = C.LEVEL_DEFAULT,
                    block_size: int = C.BLOCK_SIZE_DEFAULT,
                    checksum: bool = False, seekable: bool = False,
                    chunk: int = 1 << 16) -> bytes:
    """Convenience: run a whole buffer through the push compressor."""
    cs = CStream(level, block_size, checksum, seekable)
    out = bytearray()
    for pos in range(0, len(src), chunk):
        produced, _ = cs.compress(src[pos:pos + chunk], 1 << 62)
        out += produced
    while not cs.finished:
        out += cs.end(1 << 62)
    return bytes(out)


def stream_decompress(archive: bytes, checksum: bool = False,
                      chunk: int = 1 << 16) -> bytes:
    """Convenience: run a whole archive through the push decompressor."""
    ds = DStream(checksum)
    out = bytearray()
    for pos in range(0, len(archive), chunk):
        produced, _ = ds.decompress(archive[pos:pos + chunk], 1 << 62)
        out += produced
    produced, _ = ds.decompress(b"", 1 << 62)
    out += produced
    if not ds.finished:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "truncated stream")
    return bytes(out)
