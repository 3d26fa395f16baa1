"""A plain NumPy decoder of the ZXC v7 frame, the benchmark's reference.

It imports NumPy alone: nothing of the program under test, nothing of
JAX. It follows the wire format as the format notes define it:

* the file header (16 bytes, a 16-bit xorshift check), data blocks (an
  8-byte header with an 8-bit xorshift check, the payload, and a 4-byte
  rapidhash of the payload where the header's checksum flag is set), the
  EOF block, an optional seek table, and the 12-byte footer (plaintext
  size and the rolling hash of the block checksums);
* RAW blocks; GLO blocks (four sections: literals, tokens, offsets,
  extras); GHI blocks (three sections: literals, sequence words, extras);
* literal sections stored raw, RLE-tokenised, or PivCo canonical Huffman
  (node runs in breadth-first order, flat subtrees packed);
* varint extras (1 to 3 bytes) for saturated literal and match lengths.

Matches resolve by pointer doubling over the output: a byte of a match
points to the byte ``offset`` before it, and a match that overlaps
itself points into its own first ``offset`` bytes.

``decode_frame`` returns the plaintext and raises ``FrameError`` at the
first fault. ``walk_frame`` checks the container alone.
``decode_block(..., overlap=False)`` is the control of the benchmark's
comparison: a decode that copies each match as one move, so that a
match overlapping itself reads bytes not written yet (zeros).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = 0x9CB02EF5
VERSION = 7
FILE_HEADER = 16
FOOTER = 12
BLOCK_HEADER = 8
CHECKSUM = 4
FLAG_CHECKSUM = 0x80
FLAG_DICT = 0x40
RAW, GLO, GHI, SEK, EOF = 0, 1, 2, 254, 255
GNR_HEADER = 16
MIN_MATCH = 5
HUF_TABLE = 128
MAX_CODE_LEN = 11

_M64 = (1 << 64) - 1
_PRIME1 = 0x9E3779B97F4A7C15
_PRIME2 = 0xD2D84A61D2D84A61
_SECRET = (0x2D358DCCAA6C78A5, 0x8BB84B93962EACC9, 0x4B33A62ED433D4A3,
           0x4D5A2DA51DE1AA47, 0xA0761D6478BD642F, 0xE7037ED1A0B428DB,
           0x90ED1765281C388C, 0xAAAAAAAAAAAAAAAA)


class FrameError(Exception):
    """The archive breaks the format, or a check in it fails."""


# --------------------------------------------------------------- hashes ---

def _xorshift(h: int) -> int:
    h &= _M64
    h ^= (h << 13) & _M64
    h ^= h >> 7
    h ^= (h << 17) & _M64
    return h


def hash8(b: bytes) -> int:
    h = _xorshift(int.from_bytes(b[:8], "little") ^ _PRIME1)
    return ((h >> 32) ^ h) & 0xFF


def hash16(b: bytes) -> int:
    h = _xorshift(int.from_bytes(b[0:8], "little")
                  ^ int.from_bytes(b[8:16], "little") ^ _PRIME2)
    r = ((h >> 32) ^ h) & 0xFFFFFFFF
    return ((r >> 16) ^ r) & 0xFFFF


def _mix(a: int, b: int) -> int:
    r = (a & _M64) * (b & _M64)
    return (r & _M64) ^ (r >> 64)


def rapidhash64(data: bytes, seed: int = 0) -> int:
    """rapidhash v3 with its default secret."""
    s = _SECRET
    n = len(data)
    rd64 = struct.Struct("<Q").unpack_from
    seed = (seed ^ _mix(seed ^ s[2], s[1])) & _M64
    a = b = 0
    i, p = n, 0
    if n <= 16:
        if n >= 4:
            seed ^= n
            if n >= 8:
                a, b = rd64(data, 0)[0], rd64(data, n - 8)[0]
            else:
                a = int.from_bytes(data[0:4], "little")
                b = int.from_bytes(data[n - 4:n], "little")
        elif n > 0:
            a = ((data[0] << 45) | data[n - 1]) & _M64
            b = data[n >> 1]
    else:
        if n > 112:
            see = [seed] * 7
            words = struct.unpack_from(f"<{(n // 112) * 14}Q", data, 0)
            w = 0
            while i > 112:
                for k in range(7):
                    see[k] = _mix(words[w + 2 * k] ^ s[k],
                                  words[w + 2 * k + 1] ^ see[k])
                w += 14
                p += 112
                i -= 112
            seed = see[0] ^ see[1] ^ see[2] ^ see[3] ^ see[4] ^ see[5] ^ see[6]
        for j, key in enumerate((2, 2, 1, 1, 2, 1)):
            if i <= 16 * (j + 1):
                break
            seed = _mix(rd64(data, p + 16 * j)[0] ^ s[key],
                        rd64(data, p + 16 * j + 8)[0] ^ seed)
        a = rd64(data, p + i - 16)[0] ^ i
        b = rd64(data, p + i - 8)[0]
    a ^= s[1]
    b ^= seed
    r = a * b
    a, b = r & _M64, r >> 64
    return _mix(a ^ s[7], b ^ s[1] ^ i)


def rapidhash32(data: bytes) -> int:
    h = rapidhash64(data)
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def global_hash_update(running: int, block_hash: int) -> int:
    running &= 0xFFFFFFFF
    return (((running << 1) | (running >> 31)) ^ block_hash) & 0xFFFFFFFF


# ------------------------------------------------------------ container ---

@dataclass
class Block:
    kind: int
    start: int          # payload offset in the archive
    size: int           # payload bytes
    stored_hash: int    # -1 without checksums


@dataclass
class Frame:
    block_size: int
    has_checksum: bool
    blocks: list
    plain_size: int
    global_hash: int


def walk_frame(archive: bytes) -> Frame:
    """Checks the file header, every block header, the EOF block, any seek
    table and the footer, and lists the data blocks. Raises FrameError."""
    n = len(archive)
    if n < FILE_HEADER + BLOCK_HEADER + FOOTER:
        raise FrameError("archive too short")
    head = bytearray(archive[:FILE_HEADER])
    if struct.unpack_from("<I", head, 0)[0] != MAGIC or head[4] != VERSION:
        raise FrameError("magic or version")
    stored = struct.unpack_from("<H", head, 14)[0]
    head[14] = head[15] = 0
    if stored != hash16(bytes(head)) or head[6] & 0x0F:
        raise FrameError("file header check")
    if not 12 <= head[5] <= 21:
        raise FrameError("block size code")
    if head[6] & FLAG_DICT:
        raise FrameError("dictionary frames are outside the reference")
    block_size = 1 << head[5]
    ck = bool(head[6] & FLAG_CHECKSUM)
    blocks = []
    pos = FILE_HEADER
    end = n - FOOTER
    while True:
        if pos + BLOCK_HEADER > end:
            raise FrameError("block header past the end")
        bh = bytearray(archive[pos:pos + BLOCK_HEADER])
        want = bh[7]
        bh[7] = 0
        if want != hash8(bytes(bh)):
            raise FrameError(f"block header check at {pos}")
        kind = bh[0]
        size = struct.unpack_from("<I", bh, 3)[0]
        pos += BLOCK_HEADER
        if kind == EOF:
            if size:
                raise FrameError("EOF block with a payload")
            break
        if kind not in (RAW, GLO, GHI):
            raise FrameError(f"block type {kind}")
        tail = CHECKSUM if ck else 0
        if pos + size + tail > end:
            raise FrameError("block payload past the end")
        h = (struct.unpack_from("<I", archive, pos + size)[0] if ck else -1)
        blocks.append(Block(kind, pos, size, h))
        pos += size + tail
    plain_size, ghash = struct.unpack_from("<QI", archive, end)
    if pos != end:  # only a seek table may sit between EOF and footer
        bh = bytearray(archive[pos:pos + BLOCK_HEADER])
        want = bh[7]
        bh[7] = 0
        size = struct.unpack_from("<I", bh, 3)[0]
        if (len(bh) < BLOCK_HEADER or bh[0] != SEK or want != hash8(bytes(bh))
                or pos + BLOCK_HEADER + size != end
                or size != 4 * len(blocks)):
            raise FrameError("bytes between EOF and footer")
    if ck:
        g = 0
        for b in blocks:
            g = global_hash_update(g, b.stored_hash)
        if g != ghash:
            raise FrameError("global hash")
    if -(-plain_size // block_size) != len(blocks):
        raise FrameError("block count against the footer size")
    return Frame(block_size, ck, blocks, plain_size, ghash)


# ------------------------------------------------------------- sections ---

def varints(extras: np.ndarray, count: int) -> np.ndarray:
    """``count`` consecutive varints (1 to 3 bytes; a first byte of 0xE0
    or more is corrupt)."""
    out = np.zeros(count, np.int64)
    e = extras.tobytes()
    p, n = 0, len(e)
    for k in range(count):
        if p >= n:
            raise FrameError("extras exhausted")
        b0 = e[p]
        if b0 < 0x80:
            out[k], p = b0, p + 1
        elif b0 < 0xC0:
            if p + 2 > n:
                raise FrameError("extras varint truncated")
            out[k], p = (b0 & 0x3F) | (e[p + 1] << 6), p + 2
        elif b0 < 0xE0:
            if p + 3 > n:
                raise FrameError("extras varint truncated")
            out[k] = (b0 & 0x1F) | (e[p + 1] << 5) | (e[p + 2] << 13)
            p += 3
        else:
            raise FrameError("varint prefix")
    return out


def rle_literals(stream: np.ndarray, size: int) -> np.ndarray:
    """Raw tokens (high bit clear: tok + 1 bytes follow) and run tokens
    (high bit set: (tok & 0x7F) + 4 copies of the next byte)."""
    out = np.empty(size, np.uint8)
    s = stream
    p = w = 0
    while w < size:
        if p >= len(s):
            raise FrameError("RLE stream exhausted")
        t = int(s[p])
        if t & 0x80:
            ln = (t & 0x7F) + 4
            if p + 2 > len(s) or w + ln > size:
                raise FrameError("RLE run out of bounds")
            out[w:w + ln] = s[p + 1]
            p += 2
        else:
            ln = t + 1
            if p + 1 + ln > len(s) or w + ln > size:
                raise FrameError("RLE copy out of bounds")
            out[w:w + ln] = s[p + 1:p + 1 + ln]
            p += 1 + ln
        w += ln
    return out


class _Tree:
    """The canonical code trie of 256 code lengths, with the PivCo wire
    annotations: breadth-first node order and flat subtrees."""

    def __init__(self, cl: np.ndarray):
        present = [s for s in range(256) if cl[s]]
        if not present:
            raise FrameError("empty code")
        counts = [0] * (MAX_CODE_LEN + 2)
        for s in present:
            counts[int(cl[s])] += 1
        if len(present) >= 2:
            if sum(counts[ln] << (MAX_CODE_LEN - ln)
                   for ln in range(1, MAX_CODE_LEN + 1)) != 1 << MAX_CODE_LEN:
                raise FrameError("Kraft sum")
        elif counts[1] != 1:
            raise FrameError("a single symbol needs length 1")
        nxt = [0] * (MAX_CODE_LEN + 2)
        code = 0
        for ln in range(1, MAX_CODE_LEN + 1):
            code = (code + counts[ln - 1]) << 1
            nxt[ln] = code
        child = [[-1, -1]]
        sym = [-1]
        # canonical order: by length, then symbol
        for s in sorted(present, key=lambda x: (int(cl[x]), x)):
            ln = int(cl[s])
            c = nxt[ln]
            nxt[ln] += 1
            if c >> ln:
                raise FrameError("code space overflow")
            cur = 0
            for d in range(ln - 1, -1, -1):
                if sym[cur] >= 0:
                    raise FrameError("prefix collision")
                bit = (c >> d) & 1
                if child[cur][bit] < 0:
                    child[cur][bit] = len(sym)
                    child.append([-1, -1])
                    sym.append(-1)
                cur = child[cur][bit]
            if child[cur] != [-1, -1]:
                raise FrameError("leaf collision")
            sym[cur] = s
        self.child, self.sym = child, sym
        # breadth-first order with the depth of each node
        order, depth = [0], [0]
        k = 0
        while k < len(order):
            for b in (0, 1):
                ch = child[order[k]][b]
                if ch >= 0:
                    order.append(ch)
                    depth.append(depth[k] + 1)
            k += 1
        self.order, self.depth = order, depth
        # a flat root: an inner node whose leaves all lie at one relative
        # depth of 2 or more, not below another flat root
        nn = len(sym)
        lo, hi = [0] * nn, [0] * nn
        for nid in reversed(order):
            if sym[nid] >= 0:
                continue
            a, b = child[nid]
            if a >= 0 and b >= 0:
                lo[nid] = 1 + min(lo[a], lo[b])
                hi[nid] = 1 + max(hi[a], hi[b])
            else:
                lo[nid], hi[nid] = 0, MAX_CODE_LEN
        self.flat = [0] * nn
        self.covered = [False] * nn
        for nid in order:
            if (not self.covered[nid] and sym[nid] < 0 and lo[nid] == hi[nid]
                    and lo[nid] >= 2):
                self.flat[nid] = lo[nid]
            cov = self.covered[nid] or self.flat[nid] > 0
            for ch in child[nid]:
                if ch >= 0:
                    self.covered[ch] = cov

    def flat_symbols(self, nid: int, D: int) -> np.ndarray:
        """Symbol of each D-bit path below flat root ``nid``; path bit j is
        the branch taken at relative depth j."""
        table = np.zeros(1 << D, np.uint8)
        stack = [(nid, 0, 0)]
        while stack:
            cn, path, d = stack.pop()
            if self.sym[cn] >= 0:
                table[path] = self.sym[cn]
                continue
            stack.append((self.child[cn][0], path, d + 1))
            stack.append((self.child[cn][1], path | (1 << d), d + 1))
        return table


def pivco_section(section: np.ndarray, n: int) -> np.ndarray:
    """``n`` symbols from a PivCo section: 128 bytes of 4-bit code lengths
    (low nibble first), then one byte-padded run per emitting node in
    breadth-first order: a bit per symbol that passes the node (1 = right),
    or the packed paths of a flat subtree's symbols."""
    if len(section) < HUF_TABLE:
        raise FrameError("lengths header truncated")
    tb = section[:HUF_TABLE]
    cl = np.empty(256, np.uint8)
    cl[0::2] = tb & 0x0F
    cl[1::2] = tb >> 4
    if cl.max() > MAX_CODE_LEN:
        raise FrameError("code length")
    t = _Tree(cl)
    runs = section[HUF_TABLE:]
    nn = len(t.sym)
    count = [0] * nn
    count[0] = n
    data = {}
    pos = 0
    for nid in t.order:          # pass 1: each node's run and its counts
        if t.covered[nid] or t.sym[nid] >= 0:
            continue
        c, D = count[nid], t.flat[nid]
        nbytes = (c * D + 7) // 8 if D else (c + 7) // 8
        if pos + nbytes > len(runs):
            raise FrameError("node run past the section")
        raw = runs[pos:pos + nbytes]
        pos += nbytes
        if D:
            bits = np.unpackbits(raw, bitorder="little")[:c * D]
            paths = (bits.reshape(c, D).astype(np.int64)
                     << np.arange(D, dtype=np.int64)).sum(axis=1)
            data[nid] = t.flat_symbols(nid, D)[paths]
            continue
        bits = np.unpackbits(raw, bitorder="little")[:c].astype(bool)
        data[nid] = bits
        ones = int(bits.sum())
        a, b = t.child[nid]
        if (b < 0 and ones) or (a < 0 and c - ones):
            raise FrameError("symbols routed to an absent child")
        if b >= 0:
            count[b] = ones
        if a >= 0:
            count[a] = c - ones
    # pass 2, from the leaves up: a node's symbols, in the order they pass
    # it, interleave its children's by its bits
    seq = {}
    for nid in reversed(t.order):
        if t.covered[nid]:
            continue
        if t.sym[nid] >= 0:
            seq[nid] = np.full(count[nid], t.sym[nid], np.uint8)
        elif t.flat[nid]:
            seq[nid] = data[nid]
        else:
            bits = data[nid]
            out = np.empty(count[nid], np.uint8)
            a, b = t.child[nid]
            if a >= 0:
                out[~bits] = seq.pop(a)
            if b >= 0:
                out[bits] = seq.pop(b)
            seq[nid] = out
    return seq[0]


def _literals(enc: int, stream: np.ndarray, size: int, cap: int):
    if enc == 0:
        return stream
    if size > cap:
        raise FrameError("literal section larger than the block")
    if size == 0:
        return np.zeros(0, np.uint8)
    if enc == 1:
        return rle_literals(stream, size)
    if enc == 2:
        return pivco_section(stream, size)
    raise FrameError(f"literal encoding {enc}")


def _gnr(payload: np.ndarray, n_sec: int):
    need = GNR_HEADER + 8 * n_sec
    if len(payload) < need:
        raise FrameError("sub-header truncated")
    b = payload[:need].tobytes()
    n_seq, n_lit, enc_lit, enc_len, enc_ml, enc_off = struct.unpack_from(
        "<II4B", b, 0)
    descs = [struct.unpack_from("<Q", b, GNR_HEADER + 8 * k)[0]
             for k in range(n_sec)]
    comp = [d & 0xFFFFFFFF for d in descs]
    raw = [d >> 32 for d in descs]
    if need + sum(comp) != len(payload):
        raise FrameError("sections do not tile the payload")
    cuts = np.cumsum([need] + comp)
    secs = [payload[cuts[k]:cuts[k + 1]] for k in range(n_sec)]
    return n_seq, enc_lit, enc_len, enc_off, secs, raw


def _extend(ll, ml, sat_ll: int, sat_ml: int, extras):
    a, b = ll == sat_ll, ml == sat_ml
    both = a.astype(np.int64) + b
    vals = varints(extras, int(both.sum()))
    first = np.cumsum(both) - both
    ll = ll.copy()
    ml = ml.copy()
    ll[a] += vals[first[a]]
    ml[b] += vals[(first + a)[b]]
    return ll, ml


def parse_block(kind: int, payload: np.ndarray, cap: int):
    """(ll, ml, off, literals) of one block; a RAW block is all literals."""
    z = np.zeros(0, np.int64)
    if kind == RAW:
        if len(payload) > cap:
            raise FrameError("RAW block larger than the block size")
        return z, z, z, payload
    if kind == GLO:
        n_seq, enc_lit, enc_len, enc_off, secs, raw = _gnr(payload, 4)
        lit, tok, offs, extras = secs
        literals = _literals(enc_lit, lit, raw[0], cap)
        if enc_len == 2:
            tokens = pivco_section(tok, n_seq) if n_seq else tok[:0]
        elif enc_len == 0:
            if len(tok) < n_seq:
                raise FrameError("token section short")
            tokens = tok[:n_seq]
        else:
            raise FrameError(f"token encoding {enc_len}")
        wide = 1 if enc_off == 1 else 2
        if len(offs) < wide * n_seq:
            raise FrameError("offset section short")
        off = (offs[:n_seq].astype(np.int64) if wide == 1
               else offs[:2 * n_seq].view("<u2").astype(np.int64))
        ll = (tokens >> 4).astype(np.int64)
        ml = (tokens & 15).astype(np.int64)
        ll, ml = _extend(ll, ml, 15, 15, extras)
    elif kind == GHI:
        n_seq, _, _, _, secs, _ = _gnr(payload, 3)
        literals, words, extras = secs
        if len(words) < 4 * n_seq:
            raise FrameError("sequence section short")
        w = words[:4 * n_seq].view("<u4").astype(np.int64)
        ll, ml, off = w >> 24, (w >> 16) & 0xFF, w & 0xFFFF
        ll, ml = _extend(ll, ml, 255, 255, extras)
    else:
        raise FrameError(f"block type {kind}")
    return ll, ml + MIN_MATCH, off + 1, literals


def expand(ll, ml, off, literals, cap: int, overlap: bool = True):
    """Output bytes of the sequences; literals past the last sequence's
    trail it. ``overlap=False`` is the control: a self-overlapping match
    reads zeros past its first ``offset`` bytes."""
    if len(ll) == 0:
        if len(literals) > cap:
            raise FrameError("block larger than the block size")
        return np.array(literals, np.uint8)
    used = int(ll.sum())
    if used > len(literals):
        raise FrameError("literals exhausted")
    seg = ll + ml
    out_start = np.cumsum(seg) - seg
    m_start = out_start + ll
    total = int(seg.sum()) + len(literals) - used
    if total > cap:
        raise FrameError("block larger than the block size")
    if (off > m_start).any():
        raise FrameError("offset before the block")
    # segment of every output byte: 2k literal run, 2k+1 match of seq k
    lens = np.empty(2 * len(ll), np.int64)
    lens[0::2], lens[1::2] = ll, ml
    starts = np.empty(2 * len(ll), np.int64)
    starts[0::2], starts[1::2] = out_start, m_start
    sid = np.repeat(np.arange(2 * len(ll)), lens)
    rel = np.arange(len(sid)) - starts[sid]
    is_m = (sid & 1).astype(bool)
    seq = sid >> 1
    base = np.zeros(total + 1, np.uint8)     # index total: a zero byte
    ptr = np.arange(total + 1, dtype=np.int64)
    lit_src = (np.cumsum(ll) - ll)[seq[~is_m]] + rel[~is_m]
    base[:len(sid)][~is_m] = literals[lit_src]
    base[len(sid):total] = literals[used:]
    mo, mr = off[seq[is_m]], rel[is_m]
    ms = m_start[seq[is_m]]
    if overlap:
        ptr[:len(sid)][is_m] = ms + np.where(mr >= mo, mr % mo, mr) - mo
    else:
        ptr[:len(sid)][is_m] = np.where(mr >= mo, total, ms + mr - mo)
    done = np.ones(total + 1, bool)
    done[:len(sid)][is_m] = False
    while True:
        todo = ~done[ptr]
        if not todo.any():
            break
        ptr = np.where(todo, ptr[ptr], ptr)
    return base[ptr[:total]]


def decode_block(archive: bytes, blk: Block, cap: int,
                 verify: bool = True, overlap: bool = True) -> np.ndarray:
    """Plaintext of one data block; ``verify`` checks its stored hash."""
    raw = archive[blk.start:blk.start + blk.size]
    if verify and blk.stored_hash >= 0 and rapidhash32(raw) != blk.stored_hash:
        raise FrameError("block checksum")
    payload = np.frombuffer(raw, np.uint8)
    return expand(*parse_block(blk.kind, payload, cap), cap, overlap=overlap)


def decode_frame(archive: bytes, verify: bool = True,
                 overlap: bool = True) -> bytes:
    """The plaintext of a whole archive. Raises FrameError."""
    fr = walk_frame(archive)
    parts = []
    left = fr.plain_size
    for blk in fr.blocks:
        cap = min(fr.block_size, left)
        out = decode_block(archive, blk, fr.block_size, verify, overlap)
        if len(out) != cap:
            raise FrameError("block size against the footer")
        parts.append(out)
        left -= cap
    return b"".join(p.tobytes() for p in parts)
