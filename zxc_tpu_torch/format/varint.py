"""Prefix varint of the extras stream (FORMAT.md section 6), the port's
copy of ``zxc_tpu.format.varint``. The serial route parses extras with the
native chain (``runtime.varint_chain``); ``varint_decode_array`` is its
plain reference. ``varint_encode`` writes one value (the device encoder's
host emitter).

Unary length prefix in the high bits of the first byte; payload bits are
concatenated low-bits-first. Capped at 3 bytes (values < 2^21); a first
byte >= 0xE0 is corrupt by definition.
"""
from __future__ import annotations

import numpy as np

from ..errors import ZxcError, ERROR_CORRUPT_DATA


def varint_encode(value: int) -> bytes:
    if value < 0x80:
        return bytes((value,))
    if value < 0x4000:
        return bytes((0x80 | (value & 0x3F), (value >> 6) & 0xFF))
    if value < 0x200000:
        return bytes((0xC0 | (value & 0x1F), (value >> 5) & 0xFF,
                      (value >> 13) & 0xFF))
    raise ZxcError(ERROR_CORRUPT_DATA,
                   f"varint value {value} exceeds 21 bits")


def varint_decode_array(extras: np.ndarray, count: int) -> tuple[np.ndarray, bool]:
    """Decode ``count`` consecutive varints from a u8 array.

    Vectorized two-phase parse (same formulation the device kernels use):
    first resolve all start offsets by pointer-doubling over the
    self-delimiting length chain, then decode every varint in parallel.

    Returns (values[count] as uint32, ok). ``ok`` is False when the chain
    runs past the end of the stream or hits an out-of-spec prefix; values
    past the failure point are 0 (callers treat the block as corrupt via
    their own bounds checks, matching the reference's saturate-to-end
    behavior).
    """
    n = len(extras)
    if count == 0:
        return np.zeros(0, np.uint32), True
    if n == 0:
        return np.zeros(count, np.uint32), False
    b = extras.astype(np.uint32)
    # Per-position varint length (valid only where a varint actually starts).
    length = np.where(b < 0x80, 1, np.where(b < 0xC0, 2, np.where(b < 0xE0, 3, 1))).astype(np.int64)
    bad = b >= 0xE0
    # jt[i] = start of the next varint after one starting at i; index n is a
    # self-mapping sink so over-running chains saturate there.
    jt = np.empty(n + 1, dtype=np.int64)
    jt[:n] = np.minimum(np.arange(n, dtype=np.int64) + length, n)
    jt[n] = n
    # starts[k] = jump k varints from 0: binary-decompose every k at once,
    # squaring the jump table between rounds (composition is additive, so
    # bit order does not matter).
    starts = np.zeros(count, dtype=np.int64)
    ks = np.arange(count, dtype=np.int64)
    bit = 1
    while bit < count:
        sel = (ks & bit) != 0
        starts[sel] = jt[starts[sel]]
        jt = jt[jt]
        bit <<= 1
    s = np.minimum(starts, n - 1)
    b0 = b[s]
    b1 = b[np.minimum(s + 1, n - 1)]
    b2 = b[np.minimum(s + 2, n - 1)]
    v1 = b0
    v2 = (b0 & 0x3F) | (b1 << 6)
    v3 = (b0 & 0x1F) | (b1 << 5) | (b2 << 13)
    vals = np.where(b0 < 0x80, v1, np.where(b0 < 0xC0, v2, np.where(b0 < 0xE0, v3, 0)))
    in_bounds = (starts < n) & (starts + length[s] <= n) & ~bad[s]
    vals = np.where(in_bounds, vals, 0)
    ok = bool(in_bounds.all())
    return vals.astype(np.uint32), ok
