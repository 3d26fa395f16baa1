"""PivCo canonical Huffman codec (FORMAT.md section 5.2.1), the port's
copy of ``zxc_tpu.codec.huffman`` without its Python decoder.

The code-length header is 128 bytes, two 4-bit lengths per byte, low
nibble first. ``build_tree`` validates a table as the JAX package's does
(the same errors for an empty, over- or under-full code) and builds the
canonical trie with its PivCo wire annotations. Decoding runs in the
native decoder (``zxch_pivco_decode``), which builds its own trie from the
lengths. The encode half serves the block encoder's emitters:
``encode_payload`` (native, with the numpy encoder for a code the native
one refuses), ``calc_size`` and ``build_code_lengths`` (native
package-merge), with ``encoded_bits`` and ``nudge_code_lengths`` (the
reference's reduced-cap nudge, which no encoder applies). Without the
native library these functions raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .. import constants as C
from ..errors import ZxcError, ERROR_CORRUPT_DATA
from .. import runtime

MAX_LEN = C.HUF_MAX_CODE_LEN_ULTRA  # 11


def pack_lengths(code_len: np.ndarray) -> bytes:
    cl = np.asarray(code_len, np.uint8)
    return ((cl[0::2] & 0x0F) | (cl[1::2] << 4)).astype(np.uint8).tobytes()


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


@dataclass
class PivcoTree:
    """Canonical trie + PivCo wire annotations, all as flat arrays.

    Node 0 is the root. ``child[n, b]`` is -1 when absent; ``sym[n]`` >= 0
    marks a leaf. ``bfs`` is the wire's node order (parents before children,
    left before right); ``lvl_start[d]`` indexes ``bfs`` per depth.
    ``flat_d[n]`` > 0 marks a flat-subtree root of relative depth D;
    ``covered[n]`` marks strict descendants of flat roots (emit nothing).
    """
    child: np.ndarray      # (n_nodes, 2) int16
    sym: np.ndarray        # (n_nodes,)  int16
    bfs: np.ndarray        # (n_nodes,)  int16
    lvl_start: np.ndarray  # (max_depth + 2,) int16
    flat_d: np.ndarray     # (n_nodes,) uint8
    covered: np.ndarray    # (n_nodes,) bool
    max_depth: int
    codes: np.ndarray      # (256,) uint32 canonical code values (0 if absent)
    code_len: np.ndarray   # (256,) uint8
    # per-symbol path node ids, path[s, d] = node at depth d (before the leaf)
    # -1 padding; used by the vectorized encoder.
    path: np.ndarray = field(default=None, repr=False)


@lru_cache(maxsize=16)
def build_tree_packed(packed: bytes) -> PivcoTree:
    """Tree from a 128-byte packed lengths table, memoized on the bytes
    (a dictionary's shared table serves every block of every frame)."""
    return build_tree(unpack_lengths(packed))


def build_tree(code_len: np.ndarray) -> PivcoTree:
    cl = np.asarray(code_len, np.uint8)
    present = np.nonzero(cl)[0]
    if len(present) == 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty code")
    bl_count = np.bincount(cl[present].astype(np.int64), minlength=MAX_LEN + 1)
    if len(present) >= 2:
        kraft = int((bl_count[1:] << (MAX_LEN - np.arange(1, MAX_LEN + 1))).sum())
        if kraft != (1 << MAX_LEN):
            raise ZxcError(ERROR_CORRUPT_DATA, "Kraft inequality violated")
    else:
        if bl_count[1] != 1:
            raise ZxcError(ERROR_CORRUPT_DATA, "degenerate code must have length 1")

    # canonical code assignment: order by (len, symbol)
    next_code = np.zeros(MAX_LEN + 2, np.uint32)
    code = 0
    for l in range(1, MAX_LEN + 1):
        code = (code + int(bl_count[l - 1])) << 1
        next_code[l] = code

    max_nodes = C.PIVCO_MAX_NODES
    child = np.full((max_nodes, 2), -1, np.int16)
    sym = np.full(max_nodes, -1, np.int16)
    codes = np.zeros(C.HUF_NUM_SYMBOLS, np.uint32)
    n_nodes = 1
    max_depth = 0
    for s in present:
        l = int(cl[s])
        c = int(next_code[l])
        next_code[l] += 1
        if c >> l:
            raise ZxcError(ERROR_CORRUPT_DATA, "code space overflow")
        codes[s] = c
        cur = 0
        for d in range(l - 1, -1, -1):
            if sym[cur] >= 0:
                raise ZxcError(ERROR_CORRUPT_DATA, "prefix collision")
            bit = (c >> d) & 1
            nxt = child[cur, bit]
            if nxt < 0:
                if n_nodes >= max_nodes:
                    raise ZxcError(ERROR_CORRUPT_DATA, "node overflow")
                nxt = n_nodes
                n_nodes += 1
                child[cur, bit] = nxt
            cur = nxt
        if child[cur, 0] >= 0 or child[cur, 1] >= 0:
            raise ZxcError(ERROR_CORRUPT_DATA, "leaf collision")
        sym[cur] = s
        max_depth = max(max_depth, l)

    child = child[:n_nodes]
    sym = sym[:n_nodes]

    # BFS order + level starts
    bfs = np.zeros(n_nodes, np.int16)
    lvl_start = np.zeros(max_depth + 2, np.int16)
    head = tail = 0
    bfs[tail] = 0
    tail += 1
    depth_end = 1
    depth = 0
    while head < tail:
        if head == depth_end:
            depth += 1
            lvl_start[depth] = head
            depth_end = tail
        nid = int(bfs[head])
        head += 1
        for b in (0, 1):
            ch = child[nid, b]
            if ch >= 0:
                bfs[tail] = ch
                tail += 1
    lvl_start[depth + 1:] = tail

    # flat-subtree detection (min/max leaf depth in reverse BFS, then
    # maximality masking in forward BFS)
    mn = np.zeros(n_nodes, np.int8)
    mx = np.zeros(n_nodes, np.int8)
    for i in range(n_nodes - 1, -1, -1):
        nid = int(bfs[i])
        if sym[nid] >= 0:
            mn[nid] = mx[nid] = 0
        elif child[nid, 0] >= 0 and child[nid, 1] >= 0:
            mn[nid] = 1 + min(mn[child[nid, 0]], mn[child[nid, 1]])
            mx[nid] = 1 + max(mx[child[nid, 0]], mx[child[nid, 1]])
        else:  # degenerate single-child: never flat
            mn[nid] = 0
            mx[nid] = MAX_LEN
    flat_d = np.zeros(n_nodes, np.uint8)
    covered = np.zeros(n_nodes, bool)
    for i in range(n_nodes):
        nid = int(bfs[i])
        if not covered[nid] and sym[nid] < 0 and mn[nid] == mx[nid] and mn[nid] >= 2:
            flat_d[nid] = mn[nid]
        cov = covered[nid] or flat_d[nid] > 0
        for b in (0, 1):
            ch = child[nid, b]
            if ch >= 0:
                covered[ch] = cov

    # per-symbol path table for the vectorized encoder
    path = np.full((C.HUF_NUM_SYMBOLS, MAX_LEN), -1, np.int16)
    for s in present:
        l = int(cl[s])
        c = int(codes[s])
        cur = 0
        for d in range(l):
            path[s, d] = cur
            cur = int(child[cur, (c >> (l - 1 - d)) & 1])

    return PivcoTree(child, sym, bfs, lvl_start, flat_d, covered,
                     max_depth, codes, cl.copy(), path)


def run_bytes(count: int, flat_d: int) -> int:
    return (count * flat_d + 7) // 8 if flat_d else (count + 7) // 8


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


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def node_counts(tree: PivcoTree, freq: np.ndarray) -> np.ndarray:
    """Per-node routed-symbol counts from a 256-bin histogram."""
    t = tree
    n_nodes = len(t.sym)
    count = np.zeros(n_nodes, np.int64)
    for i in range(n_nodes - 1, -1, -1):
        nid = int(t.bfs[i])
        if t.sym[nid] >= 0:
            count[nid] = freq[t.sym[nid]]
        else:
            s = 0
            for b in (0, 1):
                ch = t.child[nid, b]
                if ch >= 0:
                    s += count[ch]
            count[nid] = s
    return count


def _size_tables(tree: PivcoTree):
    """Per-tree cached (route matrix, flat widths) for calc_size.

    route[k, s] = 1 when symbol s's path passes through the k-th
    emitting (uncovered, non-leaf) node — node counts become one
    matvec. Built lazily; the shared-dict path prices MANY small
    sections against ONE tree, where the per-node Python walk was
    ~53% of small-file dict-encode time."""
    tabs = getattr(tree, "_size_tables", None)
    if tabs is not None:
        return tabs
    n_nodes = len(tree.sym)
    emit = [int(tree.bfs[i]) for i in range(n_nodes)
            if not tree.covered[int(tree.bfs[i])]
            and tree.sym[int(tree.bfs[i])] < 0]
    route = np.zeros((len(emit), 256), np.int64)
    for k, nid in enumerate(emit):
        stack = [nid]
        while stack:
            v = stack.pop()
            if tree.sym[v] >= 0:
                route[k, tree.sym[v]] = 1
            else:
                for b in (0, 1):
                    ch = tree.child[v, b]
                    if ch >= 0:
                        stack.append(int(ch))
        # a node's count includes symbols at the node itself
        if tree.sym[nid] >= 0:
            route[k, tree.sym[nid]] = 1
    flat = np.array([int(tree.flat_d[nid]) for nid in emit], np.int64)
    tabs = (route, np.where(flat == 0, 1, flat))
    tree._size_tables = tabs
    return tabs


def calc_size(freq: np.ndarray, tree: PivcoTree, with_header: bool,
              reuse: bool = False) -> int:
    """Exact encoded byte size of a section (SIZE_MAX analog: raises if a
    histogram symbol has no code).

    ``reuse=True`` builds (and caches) the per-tree route matrix so the
    count becomes one matvec — worth it for trees priced many times
    (the shared dict table); one-shot inline trees keep the plain walk
    (the matrix build costs more than one walk)."""
    f = np.asarray(freq)
    if (f > 0)[tree.code_len == 0].any():
        raise ZxcError(ERROR_CORRUPT_DATA, "symbol without code")
    if reuse or getattr(tree, "_size_tables", None) is not None:
        route, width = _size_tables(tree)
        counts = route @ f.astype(np.int64)
        total = C.HUF_TABLE_SIZE if with_header else 0
        return total + int(((counts * width + 7) >> 3).sum())
    count = node_counts(tree, f)
    total = C.HUF_TABLE_SIZE if with_header else 0
    for i in range(len(tree.sym)):
        nid = int(tree.bfs[i])
        if tree.covered[nid] or tree.sym[nid] >= 0:
            continue
        total += run_bytes(int(count[nid]), int(tree.flat_d[nid]))
    return total


def encode_payload(data: np.ndarray, tree: PivcoTree) -> bytes:
    """Encode symbols into PivCo node runs (no lengths header).

    Native (zxch_pivco_encode, byte-exact); where the native encoder
    refuses the code, the vectorized numpy encoder: explode every symbol
    occurrence into its (emitting node, bit) items, stable-sort by node,
    pack per-node runs LSB-first.
    """
    nat = runtime.pivco_encode(np.asarray(data, np.uint8), tree.code_len)
    if nat is not None:
        return nat
    return encode_payload_numpy(data, tree)


def encode_payload_numpy(data: np.ndarray, tree: PivcoTree) -> bytes:
    """``encode_payload`` in numpy alone (the native encoder's oracle)."""
    t = tree
    data = np.asarray(data, np.uint8)
    n = len(data)
    if n == 0:
        return b""
    cl = t.code_len[data].astype(np.int64)
    if (cl == 0).any():
        raise ZxcError(ERROR_CORRUPT_DATA, "symbol without code")
    codes = t.codes[data].astype(np.int64)

    # Per (symbol, depth) emission plan, precomputed once per tree:
    # at depth d on symbol s's path, either the node is a bitmap node
    # (emit 1 bit = branch) or a flat root (emit D bits = branches at
    # d..d+D-1, LSB first) or covered (emit nothing).
    n_nodes = len(t.sym)
    is_flat = t.flat_d > 0
    # Build per-symbol item templates (node id, nbits, start depth)
    sym_items: list[list[tuple[int, int, int]]] = [[] for _ in range(256)]
    for s in range(256):
        l = int(t.code_len[s])
        d = 0
        while d < l:
            nid = int(t.path[s, d])
            if is_flat[nid]:
                D = int(t.flat_d[nid])
                sym_items[s].append((nid, D, d))
                d += D
            else:
                sym_items[s].append((nid, 1, d))
                d += 1

    # Explode occurrences: counts per symbol template length
    items_per_sym = np.array([len(sym_items[s]) for s in range(256)], np.int64)
    total_items = items_per_sym[data].sum()
    occ_idx = np.repeat(np.arange(n, dtype=np.int64), items_per_sym[data])
    # per-occurrence item slot index (0..k-1)
    k = items_per_sym[data]
    slot = np.arange(total_items, dtype=np.int64) - np.repeat(
        np.cumsum(k) - k, k)
    # lookup tables (sym, slot) -> node / nbits / depth
    max_items = int(items_per_sym.max())
    tab_node = np.full((256, max_items), -1, np.int64)
    tab_nbits = np.zeros((256, max_items), np.int64)
    tab_depth = np.zeros((256, max_items), np.int64)
    for s in range(256):
        for j, (nid, nb, d) in enumerate(sym_items[s]):
            tab_node[s, j] = nid
            tab_nbits[s, j] = nb
            tab_depth[s, j] = d
    syms = data[occ_idx]
    nodes = tab_node[syms, slot]
    nbits = tab_nbits[syms, slot]
    depths = tab_depth[syms, slot]
    # branch bits: code is MSB-first; branch at depth d = bit (l-1-d).
    # For an item of nb bits starting at depth d, produce value with bit j =
    # branch at depth d+j  (LSB-first packing order).
    l_occ = cl[occ_idx]
    c_occ = codes[occ_idx]
    # value = reverse of bits... compute per bit-position below instead.
    # Expand items to individual bits.
    total_bits = int(nbits.sum())
    bit_occ = np.repeat(np.arange(total_items, dtype=np.int64), nbits)
    j_in_item = np.arange(total_bits, dtype=np.int64) - np.repeat(
        np.cumsum(nbits) - nbits, nbits)
    d_of_bit = depths[bit_occ] + j_in_item
    branch = (c_occ[bit_occ] >> (l_occ[bit_occ] - 1 - d_of_bit)) & 1
    node_of_bit = nodes[bit_occ]

    # stable sort bits by node; within a node, original order is
    # (occurrence, depth) which matches wire order (symbol sequence order,
    # then bit 0..D-1 for flat items).
    order = np.argsort(node_of_bit, kind="stable")
    sorted_nodes = node_of_bit[order]
    sorted_bits = branch[order].astype(np.uint8)
    # per-node bit counts in BFS wire order
    out = bytearray()
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for i in range(n_nodes):
        nid = int(t.bfs[i])
        if t.covered[nid] or t.sym[nid] >= 0:
            continue
        b0, b1 = int(starts[nid]), int(starts[nid + 1])
        run = np.packbits(sorted_bits[b0:b1], bitorder="little")
        out += run.tobytes()
    return bytes(out)


def build_code_lengths(freq: np.ndarray, max_len: int) -> np.ndarray | None:
    """Optimal length-limited code lengths (boundary package-merge, native
    ``zxch_code_lengths``): uint8[256] with 0 for absent symbols, or None
    when no symbol is present. A single present symbol gets length 1
    (format rule)."""
    freq = np.asarray(freq, np.int64)
    present = np.nonzero(freq)[0]
    if len(present) == 0:
        return None
    if len(present) == 1:
        cl = np.zeros(256, np.uint8)
        cl[present[0]] = 1
        return cl
    if len(present) > (1 << max_len):
        raise ZxcError(ERROR_CORRUPT_DATA, "too many symbols for length cap")
    cl = runtime.code_lengths(freq, max_len)
    if cl is None:
        raise ValueError(f"no package-merge code for max_len {max_len}")
    return cl


# ---------------------------------------------------------------------------
# Decode-speed nudge (reference: zxc_huf_nudge_code_lengths, :824-971)
# ---------------------------------------------------------------------------

NUDGE_MAX_GROWTH = 1.015  # adoption guard: <= +1.5% encoded bits


def encoded_bits(freq: np.ndarray, code_len: np.ndarray) -> int:
    """Total payload bits for a histogram under the given lengths."""
    return int((np.asarray(freq, np.int64) *
                np.asarray(code_len, np.int64)).sum())


def nudge_code_lengths(freq: np.ndarray, code_len: np.ndarray,
                       max_len: int) -> np.ndarray:
    """Reshape code lengths for decode speed within a size budget: rebuild
    the code under successively smaller length caps and adopt the
    shallowest one whose payload grows at most NUDGE_MAX_GROWTH (the
    reference nudge's reduced-cap rebuild). The encoder does not apply
    it, as the JAX package's does not; it stays for parity study."""
    base_bits = encoded_bits(freq, code_len)
    best = code_len
    depth = int(code_len.max())
    for cap in range(depth - 1, 1, -1):
        try:
            cl = build_code_lengths(freq, cap)
        except ZxcError:
            break
        if cl is None:
            break
        bits = encoded_bits(freq, cl)
        if bits <= base_bits * NUDGE_MAX_GROWTH:
            best = cl
        else:
            break
    return best
