"""Dictionary trainer (zxc_train_dict / zxc_train_dict_huf /
zxc_dict_train analogs), the port of ``zxc_tpu.codec.dict_train``.

``train_dict`` selects the content in NumPy as the reference does
(zxc_dict.c:337-622): sample 5-gram frequencies, greedy coverage-scored
segment selection, reverse placement so the hottest bytes sit at the
dictionary's end (the shortest offsets from a block's start).
``train_dict_huf`` trains the shared literal table on the real post-LZ
literal histogram of the samples compressed at level 6 with the
dictionary attached (the host block encoder's parse). Both give the JAX
package's bytes. ``dict_train`` is the native one-shot trainer
(``zxch_dict_train``: the same algorithm, whose segment tie order may
differ from the NumPy argsort); without the native library it raises
RuntimeError, with no NumPy fallback.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C
from .. import runtime
from ..errors import ZxcError, ERROR_NULL_INPUT, ERROR_DICT_TOO_LARGE
from ..format.dictionary import Dictionary
from . import block_encode, huffman

KGRAM = 5          # matches ZXC_MIN_MATCH: only grams a match can use
SEGMENT = 64       # selection granularity (bytes)


def _gram_hash(data: np.ndarray) -> np.ndarray:
    """Vectorized 5-byte hash of every position (xorshift64*-style mix,
    independent of the wire format — trainer-internal only)."""
    if len(data) < KGRAM:
        return np.zeros(0, np.uint64)
    w = np.lib.stride_tricks.sliding_window_view(data, KGRAM).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16)
             | (w[:, 3] << 24) | (w[:, 4] << 32))
        h *= np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
    return h


def train_dict(samples: list[bytes], target_size: int = 16384) -> bytes:
    """Select dictionary content from samples (zxc_train_dict analog)."""
    if not samples or target_size <= 0:
        raise ZxcError(ERROR_NULL_INPUT, "no samples")
    target_size = min(target_size, C.DICT_SIZE_MAX)

    # 1. global 5-gram frequency table (hashed to 20 bits)
    BITS = 20
    table = np.zeros(1 << BITS, np.int64)
    arrays = [np.frombuffer(s, np.uint8) for s in samples if len(s) >= KGRAM]
    if not arrays:
        raise ZxcError(ERROR_NULL_INPUT, "samples too small")
    for a in arrays:
        h = (_gram_hash(a) >> np.uint64(64 - BITS)).astype(np.int64)
        np.add.at(table, h, 1)

    # 2. score fixed segments from every sample: sum of gram frequencies,
    # counting each distinct gram hash once per segment (coverage, not raw
    # repetition)
    seg_data: list[np.ndarray] = []
    seg_score: list[int] = []
    seg_grams: list[np.ndarray] = []
    for a in arrays:
        h = (_gram_hash(a) >> np.uint64(64 - BITS)).astype(np.int64)
        n_seg = len(a) // SEGMENT
        for k in range(n_seg):
            lo = k * SEGMENT
            hi = min(lo + SEGMENT, len(h))
            if hi <= lo:
                continue
            grams = np.unique(h[lo:hi])
            seg_data.append(a[lo:lo + SEGMENT])
            seg_grams.append(grams)
            seg_score.append(int(table[grams].sum()))

    if not seg_data:
        raise ZxcError(ERROR_NULL_INPUT, "samples too small")

    # 3. greedy selection with coverage discount: once a gram is covered by
    # the dictionary it stops contributing to later segments
    order = np.argsort(np.asarray(seg_score))[::-1]
    covered = np.zeros(1 << BITS, bool)
    chosen: list[np.ndarray] = []
    total = 0
    seen_exact: set[bytes] = set()
    for idx in order:
        if total >= target_size:
            break
        g = seg_grams[idx]
        fresh = g[~covered[g]]
        if len(fresh) * 4 < len(g):       # mostly redundant segment
            continue
        raw = seg_data[idx].tobytes()
        if raw in seen_exact:
            continue
        seen_exact.add(raw)
        covered[g] = True
        chosen.append(seg_data[idx])
        total += len(raw)

    if not chosen:
        chosen = [seg_data[int(order[0])]]
    # 4. reverse placement: hottest segment last (closest to the window)
    content = b"".join(a.tobytes() for a in reversed(chosen))[-target_size:]
    return content


def train_dict_huf(samples: list[bytes], content: bytes) -> bytes:
    """Train the shared literal table: the REAL post-LZ literal histogram of
    the samples compressed at level 6 with the dictionary attached
    (zxc_train_dict_huf analog). Returns the 128-byte packed lengths."""
    if len(content) > C.DICT_SIZE_MAX:
        raise ZxcError(ERROR_DICT_TOO_LARGE)
    dict_state = block_encode.DictState(np.frombuffer(content, np.uint8))
    freq = np.zeros(256, np.int64)
    for s in samples:
        a = np.frombuffer(s, np.uint8)
        for pos in range(0, len(a), C.BLOCK_SIZE_DEFAULT):
            chunk = a[pos:pos + C.BLOCK_SIZE_DEFAULT]
            if len(chunk) == 0:
                continue
            _, _, _, literals = block_encode._build_sequences(
                chunk, 6, dict_state)[0]
            freq += np.bincount(literals, minlength=256)
    # every byte value needs a code (decode must never hit a hole): smooth
    freq = freq + 1
    cl = huffman.build_code_lengths(freq, C.HUF_MAX_CODE_LEN)
    return huffman.pack_lengths(cl)


def dict_train(samples: list[bytes], target_size: int = 16384) -> Dictionary:
    """Train a dictionary of at most ``target_size`` content bytes from
    ``samples`` with the native trainer. Raises ZxcError on the trainer's
    errors (no samples, samples too small)."""
    return Dictionary.load(runtime.dict_train(samples, target_size))
