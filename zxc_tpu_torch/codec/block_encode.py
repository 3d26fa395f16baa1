"""Block encoders: GHI (level 1), GLO (levels 2-7), the all-literal
Huffman candidate and the RAW fallback.

The port's copy of ``zxc_tpu.codec.block_encode`` over the native
runtime. From plaintext, levels 1-5 run the native find + parse
(``runtime.find_parse``) or the fused native emitters
(``runtime.encode_ghi`` / ``encode_glo``); levels 6-7 run the native
per-position matcher, a first-pass lazy parse whose literal histogram
prices the native DP optimal parse, at level 7 a second DP re-priced
with the token tree, and an 8-bit-offset DP when an offset exceeds 256;
every candidate is emitted and the shortest payload wins. Given
``sequences`` (``(m_pos, m_len, m_off)`` in block coordinates, the device
matcher of ``ops.encode``) the matcher is skipped. A dictionary
(``DictState``) prefixes the match window and its shared literal table
competes in every GLO literal auction. Literal sections are priced with
the reference's space-speed rule ``J = size + (n_decoded * premium) >> 8``
and the cheapest wins, so the bytes equal the JAX package's. Given
sequences without a dictionary, ``encode_chunk`` emits the whole block in
one native call (``runtime.emit_block``) and records that call's stage
clocks. Given every position's best candidate instead (the device
matcher at level 7), ``encode_group_opt`` runs the level-7 pipeline
from the lazy first pass on for a group of blocks in one native call
(``runtime.opt_group``). Elsewhere, under a ``profiling`` collector, the
Python emitters
record the spans ``emit.streams`` (sequences to streams, tokens,
offsets, extras), ``emit.literals`` (the literal section's auction) and
``emit.hufflit`` (the all-literal Huffman candidate); level 7's
token-section candidate has none. The JAX package's numpy matcher and
parsers are not copied: without the native library these functions
raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .. import profiling, runtime
from ..format import headers
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
    """(ll, ml, off, literals) of a block's sequences (span
    ``emit.streams``)."""
    P = len(data)
    if len(m_pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, data
    with profiling.span("emit.streams"):
        prev_end = np.concatenate([[0], m_pos[:-1] + m_len[:-1]])
        ll = m_pos - prev_end
        # literal bytes = positions not covered by any match
        # (order-preserving)
        cover = np.zeros(P + 1, np.int8)
        np.add.at(cover, m_pos, 1)
        np.add.at(cover, np.minimum(m_pos + m_len, P), -1)
        in_match = np.cumsum(cover[:P], dtype=np.int32) > 0
        return ll, m_len, m_off, data[~in_match]


@dataclass
class DictState:
    """Encoder-side dictionary state: content + optional shared table."""
    content: np.ndarray
    huf_lengths: bytes | None = None
    tree: "huffman.PivcoTree" = None

    def __post_init__(self):
        if self.huf_lengths is not None and self.tree is None:
            self.tree = huffman.build_tree_packed(bytes(self.huf_lengths))


def _window(data: np.ndarray, dict_state: DictState | None):
    """The match window (dictionary content, then the block) and where the
    block starts in it."""
    if dict_state is not None and len(dict_state.content):
        return (np.concatenate([dict_state.content, data]),
                len(dict_state.content))
    return data, 0


def _first_pass_costs(data, lens, offs, max_code_len: int) -> np.ndarray:
    """Literal prices (bits a byte value) for the DP: the code lengths of
    the literals a first-pass lazy parse leaves, or a flat 8 bits where
    that Huffman section would lose to RAW (high-entropy data)."""
    g_pos, g_len, _ = runtime.lazy_parse(lens, offs, True)
    cover = np.zeros(len(data) + 1, np.int64)
    np.add.at(cover, g_pos, 1)
    np.add.at(cover, np.minimum(g_pos + g_len, len(data)), -1)
    first_lit = data[np.cumsum(cover[:len(data)]) == 0]
    freq = np.bincount(first_lit, minlength=256)
    cl = huffman.build_code_lengths(freq, max_code_len)
    if cl is None:
        return np.full(256, 8, np.uint16)
    # regime check: priced below 8 bits, literals the auction will ship
    # RAW make the DP undervalue matches
    hb = int((freq * np.where(cl > 0, cl, 0)).sum())
    if hb + 128 * 8 >= int(freq.sum()) * 8:
        return np.full(256, 8, np.uint16)
    # absent symbols: a finite pessimistic cost
    return np.where(cl > 0, cl, max_code_len + 2).astype(np.uint16)


def _token_costs(pos, length) -> np.ndarray | None:
    """The level-7 re-pricing: the 8-bit token tree of a parse's tokens,
    marginalised over the literal-length nibble, as 16 costs by match
    length nibble. Float64 numpy, rounded half to even, as the JAX
    package's."""
    p_pos = pos.astype(np.int64)
    p_len = length.astype(np.int64)
    p_ll = p_pos - np.concatenate([[0], (p_pos + p_len)[:-1]])
    nib_ll = np.minimum(p_ll, C.TOKEN_LL_MASK)
    nib_ml = np.minimum(p_len - C.MIN_MATCH, C.TOKEN_ML_MASK)
    toks = (nib_ll << C.TOKEN_LIT_BITS) | nib_ml
    tcl = huffman.build_code_lengths(np.bincount(toks, minlength=256), 8)
    if tcl is None:
        return None
    tcost = np.where(tcl > 0, tcl, 10).astype(np.float64)
    pll = np.bincount(nib_ll, minlength=16).astype(np.float64)
    pll /= max(pll.sum(), 1.0)
    return np.rint(pll @ tcost.reshape(16, 16)).astype(np.uint16)


def _build_sequences(data: np.ndarray, level: int,
                     dict_state: DictState | None, sequences=None,
                     probes: int | None = None):
    """Match find + parse: a non-empty list of candidate (ll, ml, off,
    literals) stream tuples in block coordinates, more than one where the
    parser proposes alternatives for the caller to price exactly (the
    re-priced level-7 DP, the 8-bit-offset DP).

    ``sequences`` short-circuits the matcher with (m_pos, m_len, m_off);
    ``probes`` overrides the level's chain depth (level 6's deepening)."""
    params = level_params(level)
    if probes is not None:
        params = dataclasses.replace(params, n_candidates=probes)
    if sequences is not None:
        m_pos, m_len, m_off = (np.asarray(a, np.int64) for a in sequences)
        return [_sequences_to_streams(data, m_pos, m_len, m_off)]
    full, start = _window(data, dict_state)
    if level < 6:
        seqs = runtime.find_parse(full, start, params.n_candidates,
                                  params.lazy, params.sufficient_len,
                                  params.step_base, params.step_shift,
                                  params.cover_base, params.min_emit)
        return [_sequences_to_streams(data, *(a.astype(np.int64)
                                              for a in seqs))]
    lens, offs = runtime.find_matches(full, start, params.n_candidates)
    # DP optimal parse (reference: zxc_lz77_optimal_parse_glo,
    # zxc_compress.c:809); level 7 prices tokens at 5 bits, its token
    # section being Huffman-coded
    cost = _first_pass_costs(data, lens, offs, params.max_code_len)
    tok_bits = 5 if level >= 7 else 8
    r = runtime.optimal_parse(lens, offs, data, cost, tok_bits)
    parses = [r]
    if level >= 7 and len(r[0]) >= 64:
        # the second DP, priced with pass 1's token tree, enters the
        # auction beside pass 1 (it can lose where it shifts its own
        # token distribution)
        tok16 = _token_costs(r[0], r[1])
        if tok16 is not None:
            r2 = runtime.optimal_parse(lens, offs, data, cost, tok_bits,
                                       tok_cost16=tok16)
            if not all(np.array_equal(a, b) for a, b in zip(r2, r)):
                parses.append(r2)
    out = [_sequences_to_streams(data, *(a.astype(np.int64) for a in pr))
           for pr in parses]
    if any(len(pr[2]) and pr[2].max() > 256 for pr in parses):
        # one far offset flips the block to 16-bit offsets: an 8-bit-only
        # DP competes (reference offset-mode choice, zxc_compress.c:1694)
        r8 = runtime.optimal_parse(lens, offs, data, cost, tok_bits,
                                   only8=True)
        out.append(_sequences_to_streams(data, *(a.astype(np.int64)
                                                 for a in r8)))
    return out


def encode_block_glo(data: np.ndarray, level: int,
                     dict_state: DictState | None = None,
                     sequences=None) -> bytes:
    """GLO payload, no block header (reference: zxc_encode_block_glo,
    zxc_compress.c:1179-1864)."""
    if sequences is None and level < 6:
        # the fused native path: find, parse, emit and literal auction
        params = level_params(level)
        full, start = _window(data, dict_state)
        cl = (dict_state.tree.code_len if start and dict_state.tree
              is not None else None)
        return runtime.encode_glo(full, start, params.n_candidates,
                                  params.lazy, params.sufficient_len,
                                  params.step_base, params.step_shift,
                                  params.cover_base, params.min_emit,
                                  dict_cl=cl)
    cands = _build_sequences(data, level, dict_state, sequences)
    best = min((_glo_payload(data, level, dict_state, c) for c in cands),
               key=len)
    # adaptive deepening (level 6, as zxch_encode_block_dispatch): a
    # payload over 45% of the input (machine code) reruns at 3x the chain
    # depth and keeps the smaller payload
    if (level == 6 and sequences is None
            and len(best) * 20 > len(data) * 9):
        deep = _build_sequences(data, level, dict_state, None,
                                probes=level_params(level).n_candidates * 3)
        d = min((_glo_payload(data, level, dict_state, c) for c in deep),
                key=len)
        if len(d) < len(best):
            best = d
    return best


def _glo_payload(data: np.ndarray, level: int,
                 dict_state: DictState | None, streams) -> bytes:
    ll, ml, off, literals = streams
    n_seq = len(ml)
    n_lit = len(literals)
    mlb = ml - C.MIN_MATCH  # token field basis

    with profiling.span("emit.streams"):
        tok_ll = np.minimum(ll, C.TOKEN_LL_MASK)
        tok_ml = np.minimum(mlb, C.TOKEN_ML_MASK)
        tokens = ((tok_ll << C.TOKEN_LIT_BITS) | tok_ml).astype(np.uint8)
        extras = _extras_stream(ll, mlb, C.TOKEN_LL_MASK, C.TOKEN_ML_MASK)

        use_8bit = bool(n_seq == 0 or off.max(initial=1) <= 256)
        if use_8bit:
            off_stream = (off - C.OFFSET_BIAS).astype(np.uint8).tobytes()
        else:
            off_stream = (off - C.OFFSET_BIAS).astype("<u2").tobytes()

    with profiling.span("emit.literals"):
        enc_lit, best_stream = _literal_section(literals, level, dict_state)

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


def _literal_section(literals: np.ndarray, level: int,
                     dict_state: DictState | None) -> tuple[int, bytes]:
    """The literal section's auction, priced J = size + tax: RAW, RLE,
    PivCo Huffman with an inline table, and the dictionary's shared table
    where there is one. Returns (enc_lit, section bytes)."""
    n_lit = len(literals)
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
        if dict_state is not None and dict_state.tree is not None:
            # the shared table competes at every level: it pays no
            # 128-byte inline header (the reference lets it compete at
            # ULTRA only)
            freq = np.bincount(literals, minlength=256)
            cl_d = dict_state.tree.code_len
            # the native encoder drops symbols without a code: gate first
            if not ((freq > 0) & (cl_d == 0)).any():
                pay = huffman.encode_payload(literals, dict_state.tree)
                j = len(pay) + ((n_lit * _prem_huf(level)) >> 8)
                if j < best_j:
                    enc_lit, best_j = C.ENC_HUFFMAN_DICT, j
                    best_stream = pay
    return enc_lit, best_stream


def encode_block_ghi(data: np.ndarray, level: int,
                     dict_state: DictState | None = None,
                     sequences=None) -> bytes:
    """GHI payload (reference: zxc_encode_block_ghi, zxc_compress.c:1895):
    the fused native emitter from plaintext without a dictionary, else the
    given or parsed sequences emitted here."""
    if sequences is None and (dict_state is None
                              or not len(dict_state.content)):
        params = level_params(level)
        return runtime.encode_ghi(data, 0, params.n_candidates,
                                  params.lazy, params.sufficient_len,
                                  params.step_base, params.step_shift,
                                  params.cover_base, params.min_emit)
    ll, ml, off, literals = _build_sequences(data, level, dict_state,
                                             sequences)[0]
    n_seq = len(ml)
    n_lit = len(literals)
    mlb = ml - C.MIN_MATCH
    with profiling.span("emit.streams"):
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


# The native block emitter's stages, in the order of its stage clocks
EMIT_STAGES = ("emit.cap", "emit.streams", "emit.literals", "emit.hufflit")


def encode_chunk(data: np.ndarray, level: int,
                 dict_state: DictState | None = None,
                 checksum: bool = False, sequences=None,
                 cap_len: int = 0) -> bytes:
    """Block header + payload (+ checksum), RAW when the block would
    expand (reference: zxc_compress_chunk_wrapper, zxc_compress.c:2122).
    Level 1 emits GHI, or without a dictionary the all-literal Huffman
    block where smaller; levels 2-5 GLO against the all-literal Huffman
    candidate; levels 6-7 GLO. ``sequences``: precomputed (m_pos, m_len,
    m_off) of an external matcher (``ops.encode``).

    Given sequences and no dictionary, the block is emitted in one native
    call (``runtime.emit_block``), which first extends the sequences of
    length ``cap_len`` and over (0: none; the LCP matcher's capped
    lengths). It adds its stage clocks to the installed collector as
    ``EMIT_STAGES``, one call each, and the block's bytes to the counter
    ``emit.native_bytes``. Otherwise the Python emitters run
    (``encode_chunk_plain``)."""
    if sequences is not None and dict_state is None:
        out, stages = runtime.emit_block(data, level, checksum, *sequences,
                                         cap_len=cap_len)
        for name, sec in zip(EMIT_STAGES, stages):
            profiling.add(name, sec)
        profiling.count("emit.native_bytes", len(data))
        return out
    if cap_len:
        raise ValueError("cap_len applies to given sequences without a "
                         "dictionary")
    return encode_chunk_plain(data, level, dict_state, checksum, sequences)


# The level-7 entry's stage clocks, in their order, and its counts
OPT_STAGES = EMIT_STAGES + ("opt.prepass", "opt.dp")
OPT_COUNTS = ("opt.parses", "opt.extended")


def encode_group_opt(data: np.ndarray, block_size: int, checksum: bool,
                     packed: np.ndarray, cap_len: int, threads: int):
    """Level 7 from per-position candidates (the device matcher's best
    candidate of every position, packed ``len << 16 | (off - 1)``, one
    int32 a byte): the blocks of ``data`` cut at ``block_size``, each with
    its lengths of ``cap_len`` and over made exact, then this module's
    level-7 pipeline from the lazy first pass on (``_first_pass_costs``,
    the DP passes, ``_token_costs``, the ``_glo_payload`` auction) and
    ``encode_chunk_plain``'s block, in one native call on ``threads``
    threads (``runtime.opt_group``) that holds no Python lock. Records
    nothing, so that it may run on any thread: returns (blocks, stats),
    and ``add_opt_stats(stats)`` adds each block's stage clocks
    (``OPT_STAGES``), counts (``OPT_COUNTS``) and plaintext bytes
    (``emit.native_bytes``) to the installed collector."""
    blocks, stages, counts = runtime.opt_group(data, block_size, checksum,
                                               packed, cap_len, threads)
    return blocks, (np.size(data), stages, counts)


def add_opt_stats(stats) -> None:
    """Adds an ``encode_group_opt`` call's stats to the installed
    collector: each stage of each block as one call of its span, even
    where it reads 0, and the counters."""
    n, stages, counts = stats
    for row in stages:
        for name, sec in zip(OPT_STAGES, row):
            profiling.add(name, sec)
    for name, c in zip(OPT_COUNTS, counts.sum(0).tolist()):
        profiling.count(name, c)
    profiling.count("emit.native_bytes", n)


def encode_chunk_plain(data: np.ndarray, level: int,
                       dict_state: DictState | None = None,
                       checksum: bool = False, sequences=None) -> bytes:
    """``encode_chunk`` by the Python emitters alone: the path with a
    dictionary or from plaintext, and the native block emitter's
    oracle."""
    no_dict = dict_state is None or not len(dict_state.content)
    if level <= 1:
        payload = encode_block_ghi(data, level, dict_state, sequences)
        btype = C.BLOCK_GHI
        if no_dict:
            budget = min(len(payload),
                         max(len(data) - C.BLOCK_HEADER_SIZE, 0))
            with profiling.span("emit.hufflit"):
                hl = encode_block_hufflit(data, budget)
            if hl is not None:
                payload, btype = hl, C.BLOCK_GLO
    elif level <= 5:
        # the all-literal candidate reads the block bytes alone and is
        # wire-legal in a dictionary frame, so it competes either way
        payload = encode_block_glo(data, level, dict_state, sequences)
        btype = C.BLOCK_GLO
        budget = min(len(payload), max(len(data) - C.BLOCK_HEADER_SIZE, 0))
        with profiling.span("emit.hufflit"):
            hl = encode_block_hufflit(data, budget)
        if hl is not None:
            payload = hl
    else:
        payload = encode_block_glo(data, level, dict_state, sequences)
        btype = C.BLOCK_GLO
    if C.BLOCK_HEADER_SIZE + len(payload) >= len(data):
        payload = data.tobytes()
        btype = C.BLOCK_RAW
    out = headers.write_block_header(btype, len(payload)) + payload
    if checksum:
        out += runtime.rapidhash32(payload).to_bytes(4, "little")
    return out
