"""Reusable codec contexts, the port of ``zxc_tpu.context``.

Options set once stick across calls, with per-call overrides, and an
attached dictionary has its Huffman tree built once, at attach time (the
reference's opaque context API, zxc_create_cctx/dctx +
zxc_compress_cctx/zxc_decompress_dctx, zxc_dispatch.c:1257-1560).
``Cctx`` compresses through the native frame encoder
(``codec.frame.compress``) and, a block at a time, through the host block
encoder (``codec.block_encode.encode_chunk``). ``Dctx``'s ``device``
routes a frame decode to ``ops.decompress`` on the card.
"""
from __future__ import annotations

import numpy as np

from . import constants as C, ops
from .codec import block_decode, block_encode, frame, huffman
from .codec.frame import DecodeOpts, EncodeOpts
from .errors import (ZxcError, ERROR_BAD_LEVEL, ERROR_DICT_TOO_LARGE,
                     ERROR_SRC_TOO_SMALL)
from .format import headers


class Cctx:
    """Reusable compression context (zxc_cctx_t equivalent)."""

    def __init__(self, level: int = C.LEVEL_DEFAULT,
                 block_size: int = C.BLOCK_SIZE_DEFAULT,
                 checksum: bool = False, seekable: bool = False):
        if not (C.LEVEL_MIN <= level <= C.LEVEL_MAX):
            raise ZxcError(ERROR_BAD_LEVEL, f"level {level}")
        self.opts = EncodeOpts(level=level, block_size=block_size,
                               checksum=checksum, seekable=seekable)
        self._dict_state: block_encode.DictState | None = None

    def attach_dict(self, content: bytes, huf_lengths: bytes | None = None):
        """Attach a dictionary; the shared tree is built once, here."""
        if len(content) > C.DICT_SIZE_MAX:
            raise ZxcError(ERROR_DICT_TOO_LARGE)
        self.opts.dict_content = content
        self.opts.dict_huf = huf_lengths
        self._dict_state = block_encode.DictState(
            np.frombuffer(content, np.uint8), huf_lengths)
        return self

    def compress(self, data: bytes, level: int | None = None) -> bytes:
        opts = self.opts
        if level is not None:
            if not (C.LEVEL_MIN <= level <= C.LEVEL_MAX):
                raise ZxcError(ERROR_BAD_LEVEL, f"level {level}")
            opts = EncodeOpts(**{**opts.__dict__, "level": level})
        return frame.compress(data, opts)

    def compress_block(self, data: bytes, level: int | None = None) -> bytes:
        """Single-block API: raw chunk, no frame (zxc_compress_block)."""
        lv = level if level is not None else self.opts.level
        if len(data) > self.opts.block_size:
            raise ZxcError(ERROR_BAD_LEVEL, "data exceeds block size")
        return block_encode.encode_chunk(
            np.frombuffer(data, np.uint8), lv, self._dict_state,
            self.opts.checksum)


class Dctx:
    """Reusable decompression context (zxc_dctx_t equivalent).

    ``device``: False decodes with the native host decoder
    (``codec.frame.decompress``); True with ``ops.decompress`` on the card
    (raises without CUDA); a device name ("cpu" or "cuda") with
    ``ops.decompress`` there, "cpu" running the route's plain CPU
    versions."""

    def __init__(self, checksum: bool = False, device=False):
        self.opts = DecodeOpts(checksum=checksum)
        self.device = device
        self._dict_tree = None

    def attach_dict(self, content: bytes, huf_lengths: bytes | None = None):
        self.opts.dict_content = content
        self.opts.dict_huf = huf_lengths
        if huf_lengths is not None:
            self._dict_tree = huffman.build_tree(
                huffman.unpack_lengths(huf_lengths))
        return self

    def decompress(self, archive: bytes) -> bytes:
        if not self.device:
            return frame.decompress(archive, self.opts)
        return ops.decompress(archive, self.opts,
                              device=None if self.device is True
                              else self.device)

    def decompress_block(self, block: bytes, dst_capacity: int) -> bytes:
        """Single-block API (zxc_decompress_block_safe equivalent), through
        the native block decode, which bounds-checks. A block shorter than
        its header's payload raises ZxcError (the JAX package's raises
        numpy's ValueError there)."""
        bh = headers.read_block_header(block, 0)
        if len(block) < C.BLOCK_HEADER_SIZE + bh.comp_size:
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block payload truncated")
        payload = np.frombuffer(block, np.uint8, count=bh.comp_size,
                                offset=C.BLOCK_HEADER_SIZE)
        dict_buf = None
        if self.opts.dict_content:
            dict_buf = np.frombuffer(self.opts.dict_content, np.uint8)
        out = block_decode.decode_block(bh.block_type, payload, dst_capacity,
                                        dict_buf, self._dict_tree)
        return out.tobytes()
