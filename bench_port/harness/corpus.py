"""Plaintext of a configuration, made from the seed.

The generators are a copy of ``tools/gen_corpus.py``'s Silesia stand-in
mix (text, C-like code, XML rows, DNA, binary records, noise), kept here
so that a change to the repository's tools does not change what the
benchmark compresses and decodes. The copy is restructured for speed
only: every member is cut into chunks of ``CHUNK`` bytes, chunk ``k`` of
member ``m`` is ``gen_corpus``'s interleaved mix of that length drawn
from ``default_rng([seed, m, k])``, and the chunks are made in parallel
worker processes. The bytes depend on ``(sizes, seed)`` alone.
"""
from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CHUNK = 4 << 20
_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)


def _zipf_probs(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def _make_vocab(rng: np.random.Generator, n_words: int) -> list[bytes]:
    probs = _zipf_probs(len(_LETTERS), 1.0)
    lens = np.clip(rng.poisson(4.2, n_words) + 2, 2, 14)
    letters = rng.choice(_LETTERS, size=int(lens.sum()), p=probs)
    out, pos, seen = [], 0, set()
    for ln in lens:
        w = letters[pos:pos + ln].tobytes()
        pos += ln
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def _gen_text(rng: np.random.Generator, n: int) -> bytes:
    vocab = _make_vocab(rng, 4000)
    probs = _zipf_probs(len(vocab), 1.07)
    idx = rng.choice(len(vocab), size=n // 6 + 64, p=probs)
    out = bytearray()
    sent_len = 0
    for i in idx:
        w = vocab[i]
        if sent_len == 0:
            out += w[:1].upper() + w[1:]
        else:
            out += b" " + w
        sent_len += 1
        if sent_len >= 8 + (len(w) % 9):
            out += b". "
            sent_len = 0
            if len(out) % 977 < 20:
                out += b"\n\n"
        if len(out) >= n:
            break
    return bytes(out[:n])


def _gen_code(rng: np.random.Generator, n: int) -> bytes:
    idents = [w.decode() for w in _make_vocab(rng, 300)[:200]]
    tmpl = (
        "static int {a}_{b}(const uint8_t *{c}, size_t {d}) {{\n"
        "    size_t {e} = 0;\n"
        "    for (size_t i = 0; i < {d}; ++i) {{\n"
        "        {e} += {c}[i] ^ (uint8_t)({f}u * i);\n"
        "        if ({e} > {g}u) {e} -= {g}u;\n"
        "    }}\n"
        "    return (int){e};\n"
        "}}\n\n"
    )
    out = bytearray()
    while len(out) < n:
        a, b, c, d, e = (idents[rng.integers(len(idents))] for _ in range(5))
        out += tmpl.format(a=a, b=b, c=c, d=d, e=e,
                           f=int(rng.integers(3, 251)),
                           g=int(rng.integers(1 << 10, 1 << 22))).encode()
    return bytes(out[:n])


def _gen_xml(rng: np.random.Generator, n: int) -> bytes:
    rec = b"<row id='%06d' level='3'><field>abcdefgh</field></row>\n"
    m = n // len(rec % 0) + 1
    return b"".join(rec % (i % 9973) for i in range(m))[:n]


def _gen_dna(rng: np.random.Generator, n: int) -> bytes:
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()


def _gen_records(rng: np.random.Generator, n: int) -> bytes:
    n_rec = n // 32 + 1
    base = rng.integers(0, 1 << 15, (n_rec, 4), dtype=np.int32)
    delta = rng.integers(-3, 4, (n_rec, 4), dtype=np.int32).cumsum(axis=0)
    vals = (base[:1] + delta).astype(np.int32)
    flags = rng.integers(0, 4, (n_rec, 8), dtype=np.uint8)
    ids = np.arange(n_rec, dtype=np.uint32).reshape(-1, 1)
    rec = np.concatenate([ids.view(np.uint8).reshape(n_rec, 4),
                          vals.view(np.uint8).reshape(n_rec, 16),
                          flags,
                          np.zeros((n_rec, 4), np.uint8)], axis=1)
    return rec.tobytes()[:n]


def _gen_noise(rng: np.random.Generator, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


_MIX = (
    (24, _gen_text),
    (18, _gen_code),
    (12, _gen_xml),
    (12, _gen_dna),
    (18, _gen_records),
    (8, _gen_noise),
)


def gen_chunk(n_bytes: int, entropy: tuple) -> bytes:
    """``gen_corpus``'s mix of ``n_bytes``: the six generators' outputs
    interleaved in 1 MiB slices."""
    rng = np.random.default_rng(list(entropy))
    wsum = sum(w for w, _ in _MIX)
    members = [g(rng, (n_bytes * w) // wsum + 1024) for w, g in _MIX]
    slice_sz = 1 << 20
    out, cursors = [], [0] * len(members)
    total = i = 0
    while total < n_bytes:
        m = i % len(members)
        c = cursors[m]
        chunk = members[m][c:c + slice_sz]
        if not chunk:
            cursors[m] = 0
            chunk = members[m][:slice_sz]
        cursors[m] = cursors[m] + len(chunk)
        out.append(chunk)
        total += len(chunk)
        i += 1
    return b"".join(out)[:n_bytes]


def make_members(sizes: dict, seed: int, workers: int) -> dict:
    """{name: bytes} of every member at its size, from ``seed``."""
    jobs = []
    for m, (name, size) in enumerate(sizes.items()):
        for k, off in enumerate(range(0, size, CHUNK)):
            jobs.append((name, min(CHUNK, size - off),
                         (seed % (1 << 64), m, k)))
    if workers <= 1 or sum(sizes.values()) <= 2 * CHUNK:
        parts = [gen_chunk(n, e) for _, n, e in jobs]
    else:
        # spawn: the parent holds CUDA and threads, which fork would copy
        with ProcessPoolExecutor(min(workers, len(jobs)),
                                 mp_context=mp.get_context("spawn")) as ex:
            parts = list(ex.map(gen_chunk, [n for _, n, _ in jobs],
                                [e for _, _, e in jobs]))
    out: dict = {name: [] for name in sizes}
    for (name, _, _), p in zip(jobs, parts):
        out[name].append(p)
    return {name: b"".join(ps) for name, ps in out.items()}
