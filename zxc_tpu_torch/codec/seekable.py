"""Seekable archives: random-access decode through the SEK table, the
port of ``zxc_tpu.codec.seekable`` (``Seekable``, ``is_seekable``).

The SEK table (one compressed size per block, in a block of its own just
before the footer) is found backwards from the footer and checked; block
and range queries follow from it. Decoding a range touches only the
blocks that overlap it: on the host one native call a block
(``decompress_block``, ``decompress_range``, ``decompress_range_mt`` on a
thread pool), or on the card (``decompress_range_device``) as one device
plan of the overlapping blocks through ``ops.batch.decode_plan_device``,
the default route of ``ops.decompress``. Error codes equal the JAX
package's.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .. import constants as C
from .. import runtime
from ..errors import (ZxcError, ERROR_CORRUPT_DATA, ERROR_SRC_TOO_SMALL,
                      ERROR_BAD_HEADER, ERROR_BAD_CHECKSUM,
                      ERROR_DICT_REQUIRED, ERROR_DICT_MISMATCH)
from ..format import headers
from ..format.dictionary import dict_id as compute_dict_id
from . import block_decode, huffman

# read_at(offset, size) -> bytes of exactly `size` (short read = error)
ReadAt = Callable[[int, int], bytes]


@dataclass
class _DictState:
    buf: np.ndarray | None = None
    tree: object | None = None
    provided_id: int = 0


class Seekable:
    """Random-access view over a seekable .zxc archive, built from a
    ``read_at`` callback plus the archive's total size; ``open_bytes`` and
    ``open_file`` wrap bytes and files."""

    def __init__(self, read_at: ReadAt, size: int):
        if size < (C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE
                   + C.FILE_FOOTER_SIZE):
            raise ZxcError(ERROR_SRC_TOO_SMALL)
        self._read = read_at
        self._size = size
        self._dict = _DictState()

        head = read_at(0, C.FILE_HEADER_SIZE)
        self.header = headers.read_file_header(head)
        tail = read_at(size - C.FILE_FOOTER_SIZE, C.FILE_FOOTER_SIZE)
        self.decompressed_size, self.global_hash = headers.read_file_footer(
            tail)

        bs = self.header.block_size
        n = (self.decompressed_size + bs - 1) // bs
        if n == 0:
            self.seek_entries: list[int] = []
            self.comp_offsets = np.zeros(1, np.int64)
            return
        sek_size = C.BLOCK_HEADER_SIZE + n * C.SEEK_ENTRY_SIZE
        start = size - C.FILE_FOOTER_SIZE - sek_size
        if start < C.FILE_HEADER_SIZE:
            raise ZxcError(ERROR_BAD_HEADER, "archive is not seekable")
        blob = read_at(start, sek_size)
        bh = headers.read_block_header(blob, 0)
        if (bh.block_type != C.BLOCK_SEK
                or bh.comp_size != n * C.SEEK_ENTRY_SIZE):
            raise ZxcError(ERROR_BAD_HEADER,
                           "archive is not seekable (no SEK)")
        entries = np.frombuffer(blob, np.uint8, count=n * C.SEEK_ENTRY_SIZE,
                                offset=C.BLOCK_HEADER_SIZE
                                ).view("<u4").astype(np.int64)
        bound = C.compress_block_bound(bs)
        if (entries < C.BLOCK_HEADER_SIZE).any() or (entries > bound).any():
            raise ZxcError(ERROR_CORRUPT_DATA, "SEK entry out of range")
        self.seek_entries = [int(e) for e in entries]
        # cumulative byte offset of block i's header
        self.comp_offsets = np.concatenate(
            [[C.FILE_HEADER_SIZE], C.FILE_HEADER_SIZE + np.cumsum(entries)])
        if int(self.comp_offsets[-1]) + C.BLOCK_HEADER_SIZE > size:
            raise ZxcError(ERROR_CORRUPT_DATA, "SEK table exceeds archive")

    # -- constructors -----------------------------------------------------

    @classmethod
    def open_bytes(cls, archive: bytes) -> "Seekable":
        def read_at(off: int, n: int) -> bytes:
            if off + n > len(archive):
                raise ZxcError(ERROR_SRC_TOO_SMALL, "read past end")
            return archive[off:off + n]
        return cls(read_at, len(archive))

    @classmethod
    def open_file(cls, path: str) -> "Seekable":
        f = open(path, "rb")
        size = os.fstat(f.fileno()).st_size

        def read_at(off: int, n: int) -> bytes:
            b = os.pread(f.fileno(), n, off)
            if len(b) != n:
                raise ZxcError(ERROR_SRC_TOO_SMALL, "short read")
            return b
        try:
            obj = cls(read_at, size)
        except BaseException:
            f.close()
            raise
        obj._file = f
        return obj

    def close(self) -> None:
        """Close the file of ``open_file`` (a no-op for other readers)."""
        f = getattr(self, "_file", None)
        if f is not None:
            f.close()

    # -- dictionary -------------------------------------------------------

    def set_dict(self, content: bytes, huf_lengths: bytes | None = None
                 ) -> None:
        """Attach the dictionary the archive requires (its tree is built
        once)."""
        d = _DictState(np.frombuffer(content, np.uint8), None,
                       compute_dict_id(content, huf_lengths))
        if huf_lengths is not None:
            d.tree = huffman.build_tree_packed(bytes(huf_lengths))
        self._dict = d

    def _check_dict(self):
        if self.header.dict_id != 0:
            if self._dict.buf is None:
                raise ZxcError(ERROR_DICT_REQUIRED)
            if self._dict.provided_id != self.header.dict_id:
                raise ZxcError(ERROR_DICT_MISMATCH)

    # -- queries ----------------------------------------------------------

    @property
    def block_size(self) -> int:
        return self.header.block_size

    @property
    def num_blocks(self) -> int:
        return len(self.seek_entries)

    def block_comp_size(self, i: int) -> int:
        """Compressed bytes of block ``i``, its header and checksum
        included."""
        if not (0 <= i < self.num_blocks):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block index out of range")
        return self.seek_entries[i]

    def block_decomp_size(self, i: int) -> int:
        """Decompressed bytes of block ``i``."""
        if not (0 <= i < self.num_blocks):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block index out of range")
        if i < self.num_blocks - 1:
            return self.block_size
        return self.decompressed_size - i * self.block_size

    def block_of(self, offset: int) -> int:
        if not (0 <= offset < max(self.decompressed_size, 1)):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "offset out of range")
        return offset // self.block_size

    def block_range(self, offset: int, length: int) -> tuple[int, int]:
        """[first, last] blocks overlapping the byte range."""
        if (length <= 0 or offset < 0
                or offset + length > self.decompressed_size):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "range out of bounds")
        return (offset // self.block_size,
                (offset + length - 1) // self.block_size)

    # -- decode -----------------------------------------------------------

    def _block_payload(self, i: int) -> tuple[np.ndarray, tuple]:
        off = int(self.comp_offsets[i])
        blob = self._read(off, self.seek_entries[i])
        bh = headers.read_block_header(blob, 0)
        tail = C.BLOCK_CHECKSUM_SIZE if self.header.has_checksum else 0
        if C.BLOCK_HEADER_SIZE + bh.comp_size + tail != self.seek_entries[i]:
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "SEK entry / block header mismatch")
        payload = np.frombuffer(blob, np.uint8, count=bh.comp_size,
                                offset=C.BLOCK_HEADER_SIZE)
        stored = None
        if tail:
            stored = int(np.frombuffer(blob, np.uint8, count=4,
                                       offset=C.BLOCK_HEADER_SIZE
                                       + bh.comp_size).view("<u4")[0])
        return payload, (bh.block_type, stored)

    def decompress_block(self, i: int, verify_checksum: bool = False
                         ) -> bytes:
        if not (0 <= i < self.num_blocks):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block index")
        self._check_dict()
        payload, (btype, stored) = self._block_payload(i)
        if verify_checksum and stored is not None:
            if runtime.rapidhash32(payload) != stored:
                raise ZxcError(ERROR_BAD_CHECKSUM, "block payload checksum")
        out = block_decode.decode_block(btype, payload, self.block_size,
                                        self._dict.buf, self._dict.tree)
        want = min(self.block_size,
                   self.decompressed_size - i * self.block_size)
        if len(out) != want:
            raise ZxcError(ERROR_CORRUPT_DATA, "block decoded size mismatch")
        return out.tobytes()

    def decompress_range(self, offset: int, length: int,
                         verify_checksum: bool = False) -> bytes:
        """Host range decode: only the overlapping blocks are touched."""
        if length == 0:
            return b""
        b0, b1 = self.block_range(offset, length)
        blob = b"".join(self.decompress_block(i, verify_checksum)
                        for i in range(b0, b1 + 1))
        lo = offset - b0 * self.block_size
        return blob[lo:lo + length]

    def decompress_range_mt(self, offset: int, length: int,
                            verify_checksum: bool = False,
                            n_threads: int = 0) -> bytes:
        """Host range decode with the overlapping blocks on a thread pool
        (the native block decode releases the GIL), reassembled in
        order."""
        if length == 0:
            return b""
        b0, b1 = self.block_range(offset, length)
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        workers = max(1, min(n_threads, b1 - b0 + 1, 16))
        if workers == 1:
            return self.decompress_range(offset, length, verify_checksum)
        with ThreadPoolExecutor(workers) as ex:
            parts = list(ex.map(
                lambda i: self.decompress_block(i, verify_checksum),
                range(b0, b1 + 1)))
        blob = b"".join(parts)
        lo = offset - b0 * self.block_size
        return blob[lo:lo + length]

    def decompress_range_device(self, offset: int, length: int,
                                device=None, batch: int = 64) -> bytes:
        """Range decode on the card: the overlapping blocks' sections are
        parsed on the host into one device plan, resolved into pieces and
        expanded in batches of ``batch`` (``ops.batch.decode_plan_device``).
        ``device``: None means cuda (raises when CUDA is absent); "cpu"
        runs the same tensor ops on the CPU."""
        from ..ops.batch import FramePlan, decode_plan_device
        from ..ops.device_pipeline import _device
        dev = _device(device, "decompress_range_device")
        if length == 0:
            return b""
        self._check_dict()
        b0, b1 = self.block_range(offset, length)
        plan = FramePlan(block_size=self.block_size, dict_buf=self._dict.buf,
                         dict_len=0 if self._dict.buf is None
                         else len(self._dict.buf))
        for i in range(b0, b1 + 1):
            payload, (btype, _) = self._block_payload(i)
            ll, ml, off_, lit = block_decode.parse_block(
                btype, payload, self.block_size, self._dict.tree)
            total = int((ll + ml).sum()) + len(lit) - int(ll.sum())
            plan.ll.append(ll.astype(np.int32))
            plan.ml.append(ml.astype(np.int32))
            plan.off.append(off_.astype(np.int32))
            plan.lit.append(np.ascontiguousarray(lit))
            plan.totals.append(total)
            plan.decompressed_size += total
        plan.resolve()
        blob = decode_plan_device(plan, batch=batch, device=dev)
        lo = offset - b0 * self.block_size
        return blob[lo:lo + length]


def is_seekable(archive: bytes) -> bool:
    try:
        Seekable.open_bytes(archive)
        return True
    except ZxcError:
        return False
