"""ZXC integrity hashes (FORMAT.md section 7), the port's copy of
``zxc_tpu.format.hashes``.

* ``hash8`` / ``hash16`` — Marsaglia-xorshift mixes over the 8-byte block
  header / 16-byte file header (reference: zxc_internal.h:1201-1228).
* ``rapidhash64`` / ``rapidhash32`` — rapidhash v3 (public algorithm,
  github.com/Nicoshev/rapidhash); the per-block payload checksum and the
  dictionary id. Bulk payload checksums go through the native runtime
  (``zxch_rapidhash32_batch``); this pure-Python form serves the small
  inputs (dictionary ids).
* ``global_hash_update`` — rotate-left-1 + XOR rolling combiner over the
  per-block checksums, stored in the footer.
"""
from __future__ import annotations

from ..constants import HASH_PRIME1, HASH_PRIME2

_M64 = (1 << 64) - 1

_RAPID_SECRET = (
    0x2D358DCCAA6C78A5,
    0x8BB84B93962EACC9,
    0x4B33A62ED433D4A3,
    0x4D5A2DA51DE1AA47,
    0xA0761D6478BD642F,
    0xE7037ED1A0B428DB,
    0x90ED1765281C388C,
    0xAAAAAAAAAAAAAAAA,
)


def _xorshift_mix(h: int) -> int:
    h &= _M64
    h ^= (h << 13) & _M64
    h ^= h >> 7
    h ^= (h << 17) & _M64
    return h


def hash8(data: bytes) -> int:
    """1-byte header checksum over exactly 8 bytes (byte 7 pre-zeroed by caller)."""
    v = int.from_bytes(data[:8], "little")
    h = _xorshift_mix(v ^ HASH_PRIME1)
    return ((h >> 32) ^ h) & 0xFF


def hash16(data: bytes) -> int:
    """2-byte header checksum over exactly 16 bytes (bytes 14-15 pre-zeroed)."""
    v1 = int.from_bytes(data[0:8], "little")
    v2 = int.from_bytes(data[8:16], "little")
    h = _xorshift_mix(v1 ^ v2 ^ HASH_PRIME2)
    res = ((h >> 32) ^ h) & 0xFFFFFFFF
    return ((res >> 16) ^ res) & 0xFFFF


def _mum(a: int, b: int) -> tuple[int, int]:
    r = (a & _M64) * (b & _M64)
    return r & _M64, r >> 64


def _mix(a: int, b: int) -> int:
    lo, hi = _mum(a, b)
    return lo ^ hi


def _read64(p: bytes, i: int) -> int:
    return int.from_bytes(p[i:i + 8], "little")


def _read32(p: bytes, i: int) -> int:
    return int.from_bytes(p[i:i + 4], "little")


def rapidhash64(data: bytes, seed: int = 0) -> int:
    """rapidhash v3 (default secret, non-protected) of ``data``."""
    s = _RAPID_SECRET
    length = len(data)
    seed = (seed ^ _mix(seed ^ s[2], s[1])) & _M64
    a = b = 0
    i = length
    p = 0
    if length <= 16:
        if length >= 4:
            seed ^= length
            if length >= 8:
                a = _read64(data, 0)
                b = _read64(data, length - 8)
            else:
                a = _read32(data, 0)
                b = _read32(data, length - 4)
        elif length > 0:
            a = ((data[0] << 45) | data[length - 1]) & _M64
            b = data[length >> 1]
    else:
        if length > 112:
            see = [seed] * 7
            while i > 112:
                for k in range(7):
                    see[k] = _mix(_read64(data, p + 16 * k) ^ s[k],
                                  _read64(data, p + 16 * k + 8) ^ see[k])
                p += 112
                i -= 112
            seed = see[0] ^ see[1] ^ see[2] ^ see[3] ^ see[4] ^ see[5] ^ see[6]
        if i > 16:
            seed = _mix(_read64(data, p) ^ s[2], _read64(data, p + 8) ^ seed)
            if i > 32:
                seed = _mix(_read64(data, p + 16) ^ s[2], _read64(data, p + 24) ^ seed)
                if i > 48:
                    seed = _mix(_read64(data, p + 32) ^ s[1], _read64(data, p + 40) ^ seed)
                    if i > 64:
                        seed = _mix(_read64(data, p + 48) ^ s[1], _read64(data, p + 56) ^ seed)
                        if i > 80:
                            seed = _mix(_read64(data, p + 64) ^ s[2], _read64(data, p + 72) ^ seed)
                            if i > 96:
                                seed = _mix(_read64(data, p + 80) ^ s[1],
                                            _read64(data, p + 88) ^ seed)
        a = _read64(data, p + i - 16) ^ i
        b = _read64(data, p + i - 8)

    a ^= s[1]
    b ^= seed
    a, b = _mum(a, b)
    return _mix(a ^ s[7], b ^ s[1] ^ i)


def rapidhash32(data: bytes, seed: int = 0) -> int:
    """rapidhash64 folded to u32 (the per-block payload checksum)."""
    h = rapidhash64(data, seed)
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def global_hash_update(running: int, block_hash: int) -> int:
    """Rolling footer hash: rotl1(running) XOR block_hash (order-sensitive)."""
    running &= 0xFFFFFFFF
    return (((running << 1) | (running >> 31)) ^ block_hash) & 0xFFFFFFFF
