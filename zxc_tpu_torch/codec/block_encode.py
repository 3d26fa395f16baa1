"""Block emitters of the device encoder: GHI (level 1), GLO (levels
2-7), the all-literal Huffman candidate and the RAW fallback.

The port's copy of the emission half of ``zxc_tpu.codec.block_encode``.
It takes the sequences a matcher chose (``(m_pos, m_len, m_off)`` in block
coordinates, ``ops.encode`` on the card) and emits the block's sections;
the host matcher stays behind the native ``codec.frame.compress``. No
dictionary on this path. Literal sections are priced with the reference's
space-speed rule ``J = size + (n_decoded * premium) >> 8`` and the
cheapest wins, so the bytes equal the JAX package's for the same
sequences.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C
from .. import runtime
from ..format import headers
from ..format.hashes import rapidhash32
from ..format.varint import varint_encode
from . import huffman
from .frame import level_params


def _prem_rle(level: int) -> int:
    return 1 if level >= 6 else 8


def _prem_huf(level: int) -> int:
    return 4 if level >= 6 else 8


def _run_lengths(data: np.ndarray) -> np.ndarray:
    """run[p] = number of consecutive bytes equal to data[p] starting at p."""
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.empty(n, bool)
    change[-1] = True
    np.not_equal(data[:-1], data[1:], out=change[:-1])
    idx = np.nonzero(change)[0]
    nxt = idx[np.searchsorted(idx, np.arange(n))]
    return nxt - np.arange(n) + 1


def encode_rle_literals(lit: np.ndarray) -> bytes:
    """RLE tokenization, byte-compatible with the reference emitter
    (zxc_compress.c:1745-1800): runs >= 4 become run tokens chunked at 131
    with a 1-3 byte raw tail; gaps up to the next 4-byte run become raw
    tokens chunked at 128. Native; the numpy tokenizer where the native
    emitter refuses."""
    if len(lit) == 0:
        return b""
    out = runtime.rle_encode_lit(lit)
    return out if out is not None else encode_rle_literals_numpy(lit)


def encode_rle_literals_numpy(lit: np.ndarray) -> bytes:
    """``encode_rle_literals`` in numpy alone (the native emitter's
    oracle)."""
    n = len(lit)
    run = _run_lengths(lit)
    idx4 = np.nonzero(run >= C.RLE_RUN_MIN)[0]
    out = bytearray()
    p = 0
    while p < n:
        r = int(run[p])
        if r >= C.RLE_RUN_MIN:
            b = int(lit[p])
            rem = r
            while rem >= C.RLE_RUN_MIN:
                chunk = min(C.RLE_RUN_MAX, rem)
                out.append(C.LIT_RLE_FLAG | (chunk - 4))
                out.append(b)
                rem -= chunk
            if rem:
                out.append(rem - 1)
                out += lit[p + r - rem:p + r].tobytes()
            p += r
        else:
            j = np.searchsorted(idx4, p)
            q = int(idx4[j]) if j < len(idx4) else n
            while p < q:
                chunk = min(C.RLE_RAW_MAX, q - p)
                out.append(chunk - 1)
                out += lit[p:p + chunk].tobytes()
                p += chunk
    return bytes(out)


def _emit_extras(vals: list[int]) -> bytes:
    """The extras varints one by one (the plain form of
    ``_extras_stream``)."""
    return b"".join(varint_encode(v) for v in vals)


def _extras_stream(ll: np.ndarray, mlb: np.ndarray, ll_mask: int,
                   ml_mask: int) -> bytes:
    """Interleaved LL/ML overflow varints in sequence order (vectorized;
    ``_emit_extras`` of the same values is its plain form)."""
    sat_ll = ll >= ll_mask
    sat_ml = mlb >= ml_mask
    n_ll = int(sat_ll.sum())
    n_ml = int(sat_ml.sum())
    if n_ll + n_ml == 0:
        return b""
    # wire order: per sequence LL extra first, then ML extra
    slot = np.zeros(len(ll), np.int64)
    slot[sat_ll] += 1
    slot[sat_ml] += 1
    start = np.cumsum(slot) - slot
    vals = np.zeros(n_ll + n_ml, np.int64)
    vals[start[sat_ll]] = ll[sat_ll] - ll_mask
    vals[(start + sat_ll)[sat_ml]] = mlb[sat_ml] - ml_mask
    # vectorized 1..3-byte prefix varints (low-bits-first payload)
    nbytes = np.where(vals < 0x80, 1, np.where(vals < 0x4000, 2, 3))
    off = np.cumsum(nbytes) - nbytes
    out = np.zeros(int(nbytes.sum()), np.uint8)
    b1 = nbytes == 1
    out[off[b1]] = vals[b1]
    b2 = nbytes == 2
    out[off[b2]] = 0x80 | (vals[b2] & 0x3F)
    out[off[b2] + 1] = (vals[b2] >> 6) & 0xFF
    b3 = nbytes == 3
    out[off[b3]] = 0xC0 | (vals[b3] & 0x1F)
    out[off[b3] + 1] = (vals[b3] >> 5) & 0xFF
    out[off[b3] + 2] = (vals[b3] >> 13) & 0xFF
    return out.tobytes()


def _sequences_to_streams(data: np.ndarray, m_pos: np.ndarray,
                          m_len: np.ndarray, m_off: np.ndarray):
    """(ll, ml, off, literals) of a block's sequences."""
    P = len(data)
    if len(m_pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, data
    prev_end = np.concatenate([[0], m_pos[:-1] + m_len[:-1]])
    ll = m_pos - prev_end
    # literal bytes = positions not covered by any match (order-preserving)
    cover = np.zeros(P + 1, np.int8)
    np.add.at(cover, m_pos, 1)
    np.add.at(cover, np.minimum(m_pos + m_len, P), -1)
    in_match = np.cumsum(cover[:P], dtype=np.int32) > 0
    return ll, m_len, m_off, data[~in_match]


def _build_sequences(data: np.ndarray, sequences):
    """The ``sequences`` branch of the JAX package's front half: the
    streams of the given (m_pos, m_len, m_off)."""
    m_pos, m_len, m_off = (np.asarray(a, np.int64) for a in sequences)
    return _sequences_to_streams(data, m_pos, m_len, m_off)


def encode_block_glo(data: np.ndarray, level: int, sequences) -> bytes:
    """GLO payload (no block header) of the given sequences (reference:
    zxc_encode_block_glo, zxc_compress.c:1179-1864)."""
    return _glo_payload(data, level, _build_sequences(data, sequences))


def _glo_payload(data: np.ndarray, level: int, streams) -> bytes:
    ll, ml, off, literals = streams
    n_seq = len(ml)
    n_lit = len(literals)
    mlb = ml - C.MIN_MATCH  # token field basis

    tok_ll = np.minimum(ll, C.TOKEN_LL_MASK)
    tok_ml = np.minimum(mlb, C.TOKEN_ML_MASK)
    tokens = ((tok_ll << C.TOKEN_LIT_BITS) | tok_ml).astype(np.uint8)
    extras = _extras_stream(ll, mlb, C.TOKEN_LL_MASK, C.TOKEN_ML_MASK)

    use_8bit = bool(n_seq == 0 or off.max(initial=1) <= 256)
    if use_8bit:
        off_stream = (off - C.OFFSET_BIAS).astype(np.uint8).tobytes()
    else:
        off_stream = (off - C.OFFSET_BIAS).astype("<u2").tobytes()

    # --- literal section candidates, priced J = size + tax ---
    enc_lit = C.ENC_RAW
    best_j = n_lit
    best_stream = literals.tobytes()
    if n_lit > 0:
        rle = encode_rle_literals(literals)
        j = len(rle) + ((n_lit * _prem_rle(level)) >> 8)
        if j < best_j:
            enc_lit, best_j, best_stream = C.ENC_RLE, j, rle
        if n_lit >= 139:
            freq = np.bincount(literals, minlength=256)
            cl = huffman.build_code_lengths(
                freq, level_params(level).max_code_len)
            if cl is not None:
                # sound skip: per-node byte rounding only ADDS to
                # sum(freq*len)/8, so when even the optimistic bound
                # loses the auction the candidate is dead weight
                bound = C.HUF_TABLE_SIZE + int(
                    (freq * cl.astype(np.int64)).sum() >> 3)
                if bound + ((n_lit * _prem_huf(level)) >> 8) < best_j:
                    pay = runtime.pivco_encode(literals, cl)
                    if pay is None:
                        pay = huffman.encode_payload(literals,
                                                     huffman.build_tree(cl))
                    j = (C.HUF_TABLE_SIZE + len(pay)
                         + ((n_lit * _prem_huf(level)) >> 8))
                    if j < best_j:
                        enc_lit, best_j = C.ENC_HUFFMAN, j
                        best_stream = huffman.pack_lengths(cl) + pay

    # --- token section candidate (ULTRA): Huffman over token bytes ---
    enc_tok = C.ENC_RAW
    tok_stream = tokens.tobytes()
    if level >= 7 and n_seq >= 139:
        tfreq = np.bincount(tokens, minlength=256)
        tcl = huffman.build_code_lengths(tfreq,
                                         level_params(level).max_code_len)
        if tcl is not None:
            ttree = huffman.build_tree(tcl)
            tsize = huffman.calc_size(tfreq, ttree, with_header=True)
            if tsize + ((n_seq * _prem_huf(level)) >> 8) < n_seq:
                enc_tok = C.ENC_HUFFMAN
                tok_stream = (huffman.pack_lengths(tcl)
                              + huffman.encode_payload(tokens, ttree))

    gh = headers.GnrHeader(n_seq, n_lit, enc_lit, enc_tok, 0,
                           1 if use_8bit else 0)
    descs = [(len(best_stream), n_lit),
             (len(tok_stream), n_seq),
             (len(off_stream), len(off_stream)),
             (len(extras), len(extras))]
    return (headers.write_gnr_header(gh, descs) + best_stream + tok_stream
            + off_stream + extras)


def encode_block_ghi(data: np.ndarray, level: int, sequences) -> bytes:
    """GHI payload of the given sequences (reference:
    zxc_encode_block_ghi, zxc_compress.c:1895)."""
    ll, ml, off, literals = _build_sequences(data, sequences)
    n_seq = len(ml)
    n_lit = len(literals)
    mlb = ml - C.MIN_MATCH
    w_ll = np.minimum(ll, C.SEQ_LL_MASK)
    w_ml = np.minimum(mlb, C.SEQ_ML_MASK)
    words = ((w_ll.astype(np.uint32) << 24)
             | (w_ml.astype(np.uint32) << 16)
             | (off - C.OFFSET_BIAS).astype(np.uint32)).astype("<u4")
    extras = _extras_stream(ll, mlb, C.SEQ_LL_MASK, C.SEQ_ML_MASK)
    gh = headers.GnrHeader(n_seq, n_lit, C.ENC_RAW, C.ENC_RAW, 0, 0)
    lit_stream = literals.tobytes()
    seq_stream = words.tobytes()
    descs = [(len(lit_stream), n_lit),
             (len(seq_stream), len(seq_stream)),
             (len(extras), len(extras))]
    return (headers.write_gnr_header(gh, descs) + lit_stream + seq_stream
            + extras)


def encode_block_hufflit(data: np.ndarray, budget: int) -> bytes | None:
    """Sequence-free GLO payload with Huffman-coded literals, or None
    unless strictly smaller than ``budget`` (the entropy fallback: block
    types are self-describing, so a GLO block in a level-1 frame is
    wire-legal). Byte-identical with the native zxch_encode_hufflit."""
    P = len(data)
    FIXED = C.GNR_HEADER_SIZE + 4 * C.SECTION_DESC_SIZE + 128
    if FIXED + (P + 7) // 8 >= budget:
        return None                       # 1 bit/symbol lower bound
    freq = np.bincount(data, minlength=256)
    if int((freq > 0).sum()) < 2:
        return None                       # degenerate: GHI/RAW always wins
    cl = huffman.build_code_lengths(freq, 8)
    if cl is None:
        return None
    bits = int((freq.astype(np.int64) * cl).sum())
    if FIXED + (bits + 7) // 8 >= budget:
        return None
    tree = huffman.build_tree(cl)
    pay = huffman.pack_lengths(cl) + huffman.encode_payload(data, tree)
    if C.GNR_HEADER_SIZE + 4 * C.SECTION_DESC_SIZE + len(pay) >= budget:
        return None
    gh = headers.GnrHeader(0, P, C.ENC_HUFFMAN, C.ENC_RAW, 0, 1)
    descs = [(len(pay), P), (0, 0), (0, 0), (0, 0)]
    return headers.write_gnr_header(gh, descs) + pay


def encode_chunk(data: np.ndarray, level: int, checksum: bool,
                 sequences) -> bytes:
    """Block header + payload (+ checksum) of the given sequences, RAW
    when the block would expand (reference: zxc_compress_chunk_wrapper,
    zxc_compress.c:2122). Level 1 emits GHI, levels 2-5 GLO, each against
    the all-literal Huffman candidate, levels 6-7 GLO."""
    if level <= 1:
        payload = encode_block_ghi(data, level, sequences)
        btype = C.BLOCK_GHI
        budget = min(len(payload), max(len(data) - C.BLOCK_HEADER_SIZE, 0))
        hl = encode_block_hufflit(data, budget)
        if hl is not None:
            payload, btype = hl, C.BLOCK_GLO
    elif level <= 5:
        payload = encode_block_glo(data, level, sequences)
        btype = C.BLOCK_GLO
        budget = min(len(payload), max(len(data) - C.BLOCK_HEADER_SIZE, 0))
        hl = encode_block_hufflit(data, budget)
        if hl is not None:
            payload = hl
    else:
        payload = encode_block_glo(data, level, sequences)
        btype = C.BLOCK_GLO
    if C.BLOCK_HEADER_SIZE + len(payload) >= len(data):
        payload = data.tobytes()
        btype = C.BLOCK_RAW
    out = headers.write_block_header(btype, len(payload)) + payload
    if checksum:
        out += int(rapidhash32(payload)).to_bytes(4, "little")
    return out
