"""PivCo canonical Huffman tables and section decode (FORMAT.md section
5.2.1), the decode half of ``zxc_tpu.codec.huffman`` for the port.

The code-length header is 128 bytes, two 4-bit lengths per byte, low
nibble first. ``build_tree`` validates a table as the JAX package's does
(the same errors for an empty, over- or under-full code) and assigns the
canonical codes; the trie walk itself runs in the native decoder
(``zxch_pivco_decode``), which builds its own trie from the lengths. There
is no Python decoder: without the native library these functions raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .. import constants as C
from ..errors import ZxcError, ERROR_CORRUPT_DATA
from .. import runtime

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


@dataclass(frozen=True)
class PivcoTree:
    """A validated canonical code: per-symbol lengths and code values (0
    where a symbol is absent)."""
    code_len: np.ndarray   # (256,) uint8
    codes: np.ndarray      # (256,) uint32


@lru_cache(maxsize=16)
def build_tree_packed(packed: bytes) -> PivcoTree:
    """Tree from a 128-byte packed lengths table, memoized on the bytes
    (a dictionary's shared table serves every block of every frame)."""
    return build_tree(unpack_lengths(packed))


def build_tree(code_len: np.ndarray) -> PivcoTree:
    """Validate ``code_len`` (a complete prefix code, or one symbol of
    length 1) and assign canonical codes in (length, symbol) order."""
    cl = np.asarray(code_len, np.uint8)
    present = np.nonzero(cl)[0]
    if len(present) == 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty code")
    bl_count = np.bincount(cl[present].astype(np.int64),
                           minlength=MAX_LEN + 1)
    if len(present) >= 2:
        kraft = int((bl_count[1:] << (MAX_LEN - np.arange(1, MAX_LEN + 1)))
                    .sum())
        if kraft != (1 << MAX_LEN):
            raise ZxcError(ERROR_CORRUPT_DATA, "Kraft inequality violated")
    elif bl_count[1] != 1:
        raise ZxcError(ERROR_CORRUPT_DATA, "degenerate code must have length 1")
    # a complete code (Kraft equality) assigns every code once, with no
    # prefix collision and at most 2*256-1 trie nodes
    next_code = np.zeros(MAX_LEN + 2, np.int64)
    code = 0
    for length in range(1, MAX_LEN + 1):
        code = (code + int(bl_count[length - 1])) << 1
        next_code[length] = code
    codes = np.zeros(C.HUF_NUM_SYMBOLS, np.uint32)
    for s in present:
        codes[s] = next_code[cl[s]]
        next_code[cl[s]] += 1
    return PivcoTree(cl.copy(), codes)


def decode_payload(payload: np.ndarray, n: int, tree: PivcoTree) -> np.ndarray:
    """Decode ``n`` symbols from a section's node runs (no lengths
    header)."""
    if n == 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty section")
    return runtime.pivco_decode(np.asarray(payload, np.uint8), n,
                                tree.code_len)


def decode_section(payload: np.ndarray, n: int) -> np.ndarray:
    """Decode a section with its inline 128-byte lengths header
    (enc_lit=2)."""
    payload = np.asarray(payload, np.uint8)
    if len(payload) < C.HUF_TABLE_SIZE:
        raise ZxcError(ERROR_CORRUPT_DATA,
                       "section smaller than lengths header")
    cl = unpack_lengths(payload[:C.HUF_TABLE_SIZE].tobytes())
    if n == 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty section")
    return runtime.pivco_decode(payload[C.HUF_TABLE_SIZE:], n, cl)
