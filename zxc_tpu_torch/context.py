"""Reusable decompression context, the port of ``zxc_tpu.context.Dctx``.

Options set once stick across calls, and an attached dictionary has its
Huffman tree built once, at attach time (the reference's opaque context
API, zxc_create_dctx + zxc_decompress_dctx). ``device`` routes a frame
decode to ``ops.decompress`` on the card. The compression context
(``Cctx``) is the host encoder and is not part of the port's device
surface.
"""
from __future__ import annotations

import numpy as np

from . import constants as C, ops
from .codec import block_decode, frame, huffman
from .codec.frame import DecodeOpts
from .errors import ZxcError, ERROR_SRC_TOO_SMALL
from .format import headers


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
