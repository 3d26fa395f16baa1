"""A plain reference of zxc's level 7 from a block's plaintext: the best of
K candidates a position, then the level-7 optimal parse and its auction.

It imports neither JAX, nor the JAX package, nor any kernel, matcher,
parser or native entry of the program. It holds:

* ``best_candidates``: a best-of-K matcher in plain torch ops, on any
  device. Every position ``p < n - 4`` is hashed by its first five bytes
  (a multiplicative hash of the little-endian word and the fifth byte,
  17 bits); a stable sort by hash gives each position the K positions
  before it in its hash group, those at most 64 KiB back. Each candidate
  is measured exactly (its common length with ``p``, at most ``n - p``)
  and must reach 5 bytes. Candidates compete by their length taken at
  most ``cap`` (256, where the LCP kernel stops measuring): the first
  strictly longer one wins and keeps its exact length. A position after
  an equal byte inside a run of 5 or more has the offset-1 match of the
  rest of the run; a hash match replaces it only when its capped length
  is longer, and positions inside a run of 64 or more search no hash
  candidates.
* ``parses``: the level-7 parse in NumPy and Python, after
  ``zxc_lz77_optimal_parse_glo`` (zxc_compress.c:809-1072) with the
  token Huffman of :1665-1688: a lazy first pass whose literal histogram
  prices the literals (Huffman code lengths capped at 11, absent bytes
  13 bits, a flat 8 bits where that Huffman section would lose to RAW),
  a shortest-path DP over the positions with 5-bit tokens, from 64
  sequences a second DP whose tokens are priced by the first parse's
  token tree, and an 8-bit-offset DP where a parse has an offset over
  256.
* ``payload``: each parse emitted by the program's Python GLO emitter
  (``codec.block_encode._glo_payload`` with the Python Huffman code
  length builder, which the program's tests hold against the JAX
  package), the smallest payload kept, the first on ties;
  ``encode_block``: the block (header, payload or the plaintext where it
  would not shrink, checksum).
"""
from __future__ import annotations

import numpy as np
import torch

from . import zxc_numpy as R

MIN_MATCH = 5
WINDOW = 1 << 16
HASH_BITS = 17
M1, M2 = 0x9E3779B1, 0x85EBCA77
CAP = 256
K_LEVEL7 = 128
MAX_CODE = 11
TOKEN_BITS = 5
BREAKS = (5, 6, 7, 8, 19, 147)
_WORD_ROUNDS = 32


# ------------------------------------------------------------- matcher ---

def _mul_mod32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2**32 in int64, in two 16-bit halves of k."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _runs(d: torch.Tensor):
    """(run, prev_same): bytes equal to d[p] from p on, and d[p] == d[p-1]."""
    n = d.numel()
    same_next = torch.zeros(n, dtype=torch.bool, device=d.device)
    same_next[:-1] = d[1:] == d[:-1]
    idx = torch.arange(n, device=d.device)
    # the first position at or after p whose next byte differs
    stop = torch.where(same_next, n - 1, idx)
    stop = torch.flip(torch.cummin(torch.flip(stop, [0]), 0).values, [0])
    prev_same = torch.zeros_like(same_next)
    prev_same[1:] = same_next[:-1]
    return stop - idx + 1, prev_same


def _words(d: torch.Tensor):
    """The block with 8 zero bytes after it, and the little-endian 8-byte
    word at every position (int64, wrapped)."""
    n = d.numel()
    pad = torch.cat([d.long(), torch.zeros(8, dtype=torch.long,
                                           device=d.device)])
    word = torch.zeros(n, dtype=torch.long, device=d.device)
    for i in range(8):
        word |= pad[i:i + n] << (8 * i)
    return pad, word


def _common_lengths(d: torch.Tensor, p: torch.Tensor, c: torch.Tensor):
    """Exact common length of d[p:] and d[c:] for pairs c < p, at most
    n - p: 8-byte words compared for up to 256 bytes, then the pairs still
    equal measured by the run of equal bytes at their lag, the others by
    up to 7 bytes more."""
    n = d.numel()
    pad, word = _words(d)
    m = torch.zeros_like(p)
    lim = n - p
    act = torch.arange(p.numel(), device=d.device)
    for _ in range(_WORD_ROUNDS):
        if act.numel() == 0:
            break
        pa, ca, ma = p[act], c[act], m[act]
        ok = (ma + 8 <= lim[act]) & (word[(ca + ma).clamp(max=n - 1)]
                                     == word[(pa + ma).clamp(max=n - 1)])
        act = act[ok]
        m[act] += 8
    lags = p[act] - c[act]
    for lag in torch.unique(lags).tolist():
        sel = act[lags == lag]
        eq = d[lag:] == d[:-lag]
        idx = torch.arange(n - lag, device=d.device)
        first = torch.where(eq, n - lag, idx)
        first = torch.flip(torch.cummin(torch.flip(first, [0]), 0).values,
                           [0])
        m[sel] = (first - idx)[c[sel]]
    live = torch.ones_like(p, dtype=torch.bool)
    live[act] = False
    for _ in range(7):
        step = live & (m < lim) & (pad[(c + m).clamp(max=n)]
                                   == pad[(p + m).clamp(max=n)])
        m += step
        live &= step
    return m


def best_candidates(block: torch.Tensor, k: int = K_LEVEL7,
                    cap: int = CAP):
    """The best (length, offset) of every position of a uint8 block (int64
    tensors on its device; length 0 is no match, its offset 1)."""
    d = block.reshape(-1)
    n = d.numel()
    dev = d.device
    lens = torch.zeros(n, dtype=torch.long, device=dev)
    offs = torch.ones(n, dtype=torch.long, device=dev)
    if n < MIN_MATCH + 1:
        return lens, offs
    run, prev_same = _runs(d)
    run_len = torch.where(prev_same & (run >= MIN_MATCH), run, 0)
    deep = prev_same & (run >= 64)
    nh = n - (MIN_MATCH - 1)
    dl = d.long()
    word = dl[:nh] | (dl[1:nh + 1] << 8) | (dl[2:nh + 2] << 16) \
        | (dl[3:nh + 3] << 24)
    h = (_mul_mod32(word, M1) ^ _mul_mod32(dl[4:nh + 4], M2)) \
        >> (32 - HASH_BITS)
    order = torch.sort(h, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nh, device=dev)
    pos = torch.arange(nh, device=dev)
    # the k candidates of every position, (k, nh), and their exact lengths
    r = rank[None] - torch.arange(1, k + 1, device=dev)[:, None]
    c = order[r.clamp(min=0)]
    ok = (r >= 0) & (h[c] == h) & (pos - c <= WINDOW) & ~deep[:nh]
    sel = ok.nonzero()
    m = torch.zeros((k, nh), dtype=torch.long, device=dev)
    m[sel[:, 0], sel[:, 1]] = _common_lengths(d, sel[:, 1],
                                              c[sel[:, 0], sel[:, 1]])
    best_key = torch.zeros(nh, dtype=torch.long, device=dev)
    best_len = torch.zeros_like(best_key)
    best_off = torch.zeros_like(best_key)
    for j in range(k):
        key = m[j].clamp(max=cap)
        win = (m[j] >= MIN_MATCH) & (key > best_key)
        best_key = torch.where(win, key, best_key)
        best_len = torch.where(win, m[j], best_len)
        best_off = torch.where(win, pos - c[j], best_off)
    lens = run_len.clone()
    use = (best_len >= MIN_MATCH) & (best_key > run_len[:nh])
    lens[:nh] = torch.where(use, best_len, run_len[:nh])
    offs[:nh] = torch.where(use, best_off, 1)
    return lens, offs


# --------------------------------------------------------------- parse ---

def _code_lengths(freq: np.ndarray, max_len: int):
    from zxc_tpu_torch.codec import huffman
    return huffman.build_code_lengths(freq, max_len)


def lazy_parse(lens: list, P: int):
    """The lazy first pass: a match of 5 or more is taken unless the next
    position's is longer. Returns (pos, len) lists."""
    out_p, out_l = [], []
    p = 0
    while p < P:
        m = lens[p]
        if m < MIN_MATCH:
            p += 1
            continue
        if p + 1 < P and lens[p + 1] >= MIN_MATCH and lens[p + 1] > m:
            p += 1
            continue
        out_p.append(p)
        out_l.append(m)
        p += m
    return out_p, out_l


def literal_costs(data: np.ndarray, lens: list) -> np.ndarray:
    """Bits a byte value: the code lengths of the literals the lazy first
    pass leaves, or a flat 8 where that section would lose to RAW."""
    P = len(data)
    covered = np.zeros(P + 1, np.int64)
    for p, m in zip(*lazy_parse(lens, P)):
        covered[p] += 1
        covered[p + m] -= 1
    freq = np.bincount(data[np.cumsum(covered[:P]) == 0], minlength=256)
    cl = _code_lengths(freq, MAX_CODE)
    if cl is None:
        return np.full(256, 8, np.int64)
    bits = int((freq * cl.astype(np.int64)).sum())
    if bits + 128 * 8 >= int(freq.sum()) * 8:
        return np.full(256, 8, np.int64)
    return np.where(cl > 0, cl, MAX_CODE + 2).astype(np.int64)


def _match_bits(L: int, off_bits: int, tok16) -> int:
    mf = L - MIN_MATCH
    bits = (TOKEN_BITS if tok16 is None else tok16[min(mf, 15)]) \
        + off_bits + 2
    if mf >= 15:
        ext = mf - 15
        bits += 8 if ext < 128 else (16 if ext < 16384 else 24)
    return bits


def dp_parse(data: np.ndarray, lens: list, offs: list, lit_cost,
             only8: bool = False, tok16=None):
    """The shortest path over the positions: a literal costs its byte's
    bits, a match its token, offset (16 bits for every match where any
    candidate of the block reaches past 256, unless ``only8`` drops those
    candidates) and extra bytes. A match is tried at the lengths where its
    price steps (5, 6, 7, 8, 19, 147) and at its own length; an edge
    replaces a path only when strictly cheaper, in that order after the
    literal. Returns (pos, len, off) lists."""
    P = len(data)
    off16 = not only8 and any(m >= MIN_MATCH and o > 256
                              for m, o in zip(lens, offs))
    off_bits = 16 if off16 else 8
    price = {}
    lc = np.asarray(lit_cost)[data].tolist()
    INF = 1 << 62
    cost = [INF] * (P + 1)
    step = [0] * (P + 1)
    cost[0] = 0
    for p in range(P):
        c = cost[p]
        x = c + lc[p]
        if x < cost[p + 1]:
            cost[p + 1] = x
            step[p + 1] = 0
        m = lens[p]
        if m < MIN_MATCH or (only8 and offs[p] > 256):
            continue
        m = min(m, P - p)
        if m < MIN_MATCH:
            continue
        for L in BREAKS + (m,):
            if L > m:
                continue
            b = price.get(L)
            if b is None:
                b = price[L] = _match_bits(L, off_bits, tok16)
            if c + b < cost[p + L]:
                cost[p + L] = c + b
                step[p + L] = L
    out_p, out_l, out_o = [], [], []
    p = P
    while p > 0:
        L = step[p]
        if L == 0:
            p -= 1
            continue
        p -= L
        out_p.append(p)
        out_l.append(L)
        out_o.append(offs[p])
    return out_p[::-1], out_l[::-1], out_o[::-1]


def token_costs(pos: list, length: list):
    """Bits a match token by its length nibble: the 8-bit-capped code of
    the parse's token bytes, absent tokens 10 bits, averaged over the
    literal-length nibbles as the parse has them; None without a code."""
    toks = np.zeros(256, np.int64)
    nib = [0.0] * 16
    cursor = 0
    for p, m in zip(pos, length):
        nl, nm = min(p - cursor, 15), min(m - MIN_MATCH, 15)
        toks[(nl << 4) | nm] += 1
        nib[nl] += 1.0
        cursor = p + m
    cl = _code_lengths(toks, 8)
    if cl is None:
        return None
    tot = max(sum(nib), 1.0)
    out = []
    for nm in range(16):
        e = 0.0
        for nl in range(16):
            b = int(cl[(nl << 4) | nm])
            e += (nib[nl] / tot) * (b if b else 10.0)
        out.append(round(e))
    return out


def parses(data: np.ndarray, lens, offs) -> list:
    """The candidate parses of level 7, each (pos, len, off) lists."""
    lens = [int(v) for v in np.asarray(lens).tolist()]
    offs = [int(v) for v in np.asarray(offs).tolist()]
    cost = literal_costs(data, lens)
    first = dp_parse(data, lens, offs, cost)
    out = [first]
    if len(first[0]) >= 64:
        tok16 = token_costs(first[0], first[1])
        if tok16 is not None:
            second = dp_parse(data, lens, offs, cost, tok16=tok16)
            if second != first:
                out.append(second)
    if any(o > 256 for pr in out for o in pr[2]):
        out.append(dp_parse(data, lens, offs, cost, only8=True))
    return out


def payload(data: np.ndarray, lens, offs) -> bytes:
    """The smallest GLO payload of the level-7 parses (the first of equal
    size)."""
    from zxc_tpu_torch.codec import block_encode as BE
    best = None
    for pos, ln, off in parses(data, lens, offs):
        streams = BE._sequences_to_streams(
            data, np.asarray(pos, np.int64), np.asarray(ln, np.int64),
            np.asarray(off, np.int64))
        pay = BE._glo_payload(data, 7, None, streams)
        if best is None or len(pay) < len(best):
            best = pay
    return best


def encode_block(data: np.ndarray, lens, offs, checksum: bool) -> bytes:
    """The level-7 block of ``data`` from its candidates: the 8-byte
    header (GLO, or RAW where the payload does not leave the block
    smaller), the payload and, with ``checksum``, its rapidhash32."""
    pay = payload(data, lens, offs)
    kind = R.GLO
    if R.BLOCK_HEADER + len(pay) >= len(data):
        pay, kind = data.tobytes(), R.RAW
    head = bytearray(R.BLOCK_HEADER)
    head[0] = kind
    head[3:7] = len(pay).to_bytes(4, "little")
    head[7] = R.hash8(bytes(head))
    out = bytes(head) + pay
    if checksum:
        out += R.rapidhash32(pay).to_bytes(4, "little")
    return out


def encode(plain: bytes, block_size: int, checksum: bool,
           device="cpu") -> list:
    """Every block of ``plain`` at level 7, matched on ``device``."""
    out = []
    for s in range(0, len(plain), block_size):
        arr = np.frombuffer(plain, np.uint8, min(block_size,
                                                 len(plain) - s), s)
        lens, offs = best_candidates(torch.from_numpy(arr.copy()).to(device))
        out.append(encode_block(arr, lens.cpu().numpy(), offs.cpu().numpy(),
                                checksum))
    return out
