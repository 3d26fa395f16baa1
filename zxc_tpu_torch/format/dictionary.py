"""Dictionary id (FORMAT.md section 12; reference: zxc_dict.c:36-45), the
port's copy of ``zxc_tpu.format.dictionary.dict_id``."""
from __future__ import annotations

from functools import lru_cache

from .. import constants as C
from .hashes import rapidhash32, rapidhash64


@lru_cache(maxsize=64)
def dict_id(content: bytes, huf_lengths: bytes | None = None) -> int:
    """32-bit id binding the (content, table) pair: the content checksum
    seeds the table checksum. Memoized: callers hash the same dictionary
    once per process, not once per frame."""
    if not content:
        return 0
    base = rapidhash32(content)
    if huf_lengths is None:
        return base
    h = rapidhash64(huf_lengths[:C.HUF_TABLE_SIZE], base)
    return (h ^ (h >> 32)) & 0xFFFFFFFF
