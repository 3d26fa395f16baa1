"""Code-length header of the PivCo canonical Huffman tables (FORMAT.md
section 5.2.1): 128 bytes, two 4-bit lengths per byte, low nibble first.

The port's copy of ``zxc_tpu.codec.huffman.unpack_lengths``; entropy
decode itself runs in the native prep."""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..errors import ZxcError, ERROR_CORRUPT_DATA

MAX_LEN = C.HUF_MAX_CODE_LEN_ULTRA  # 11


def unpack_lengths(packed: bytes | np.ndarray) -> np.ndarray:
    b = np.frombuffer(bytes(packed[:C.HUF_TABLE_SIZE]), np.uint8)
    if len(b) != C.HUF_TABLE_SIZE:
        raise ZxcError(ERROR_CORRUPT_DATA, "lengths header truncated")
    cl = np.empty(C.HUF_NUM_SYMBOLS, np.uint8)
    cl[0::2] = b & 0x0F
    cl[1::2] = b >> 4
    if cl.max() > MAX_LEN or not cl.any():
        raise ZxcError(ERROR_CORRUPT_DATA, "invalid code lengths")
    return cl
