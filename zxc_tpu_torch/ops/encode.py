"""Device encoder of the port: match finding and parse on the card, byte
emission on the host (``codec.block_encode``).

The port of ``zxc_tpu/ops/encode.py`` in torch ops on the caller's device.
Per block: 5-byte hashes of every position, candidate lists from one
stable sort (the vectorized form of walking a hash chain; reference
zxc_lz77_find_best_match, zxc_compress.c:193-560), the offset-1 runs
resolved analytically, match extension, the best candidate per position,
then the greedy or lazy parse. Two matchers, chosen per block as the JAX
package chooses them:

* the LCP matcher (blocks up to 64 KiB, ``ZXC_DEVICE_MATCHER`` unset or
  ``lcp``): every candidate measured by the LCP kernel (capped at 256;
  sequences at the cap are extended on the host), then the parse-walk
  kernel (``encode_kernels``);
* the XLA matcher (larger blocks, or ``ZXC_DEVICE_MATCHER=xla``): exact
  extension and the pointer-doubling parse, torch ops without a kernel.
  Its extension is the JAX matcher's 4-byte compare rounds
  (``_extend_rounds``), cut short after 16 rounds: the pairs still equal
  then are measured by the run of equal bytes at their lag
  (``_extend_exact``), so a long periodic stretch costs one scan of the
  block per distinct lag instead of a round per 4 bytes of its length.

Hash arithmetic is uint32 with wrap-around, computed in int64 and masked.
Candidate order follows ``torch.argsort(stable=True)``: ties stay
position-ascending, as ``jnp.argsort(stable=True)`` keeps them, so the
archives equal the JAX package's byte for byte.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from .. import constants as C
from .. import profiling
from ..codec import block_encode
from ..codec.frame import level_params
from ..format import headers
from ..format.hashes import global_hash_update
from . import encode_kernels as EK
from .device_pipeline import _device

_M1 = 0x9E3779B1
_M2 = 0x85EBCA77
_HASH_BITS = 17
_MASK32 = 0xFFFFFFFF
DISPATCH = 16     # full blocks per batched dispatch on the card
_WORD_ROUNDS = 16  # 4-byte rounds of the XLA matcher before per-lag runs


def _matcher() -> str:
    return os.environ.get("ZXC_DEVICE_MATCHER", "lcp")


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 ``a`` in [0, 2^32), without overflowing
    int64: the two 16-bit halves of k separately."""
    return (a * (k & 0xFFFF) + (((a * (k >> 16)) & 0xFFFF) << 16)) & _MASK32


def _le32(d: torch.Tensor) -> torch.Tensor:
    """u32 little-endian word (as int64) starting at every position; the
    input carries 4 bytes of padding."""
    n = d.shape[-1] - 4
    u = d.long()
    return (u[..., :n] | (u[..., 1:n + 1] << 8) | (u[..., 2:n + 2] << 16)
            | (u[..., 3:n + 3] << 24))


def _run_lengths(d: torch.Tensor) -> torch.Tensor:
    """run[p] = consecutive bytes equal to d[p] starting at p."""
    n = d.shape[-1]
    ar = torch.arange(n, device=d.device)
    change = torch.cat([d[..., :-1] != d[..., 1:],
                        torch.ones_like(d[..., :1], dtype=torch.bool)], -1)
    pos = torch.where(change, ar, n - 1)
    nxt = torch.cummin(pos.flip(-1), dim=-1).values.flip(-1)
    return nxt - ar + 1


def _run_matches(d: torch.Tensor):
    """Offset-1 run matches (analytic, uncapped): (lens int32, in_run),
    in_run marking deep-run interiors that skip the hash search."""
    run = _run_lengths(d)
    prev_same = torch.cat([torch.zeros_like(d[..., :1], dtype=torch.bool),
                           d[..., 1:] == d[..., :-1]], -1)
    lens = torch.where(prev_same & (run >= C.MIN_MATCH), run, 0).int()
    return lens, prev_same & (run >= 64)


def _hash_order(d: torch.Tensor):
    """Words, 5th bytes, hashes, the stable hash order and each position's
    rank in it (nh = n - 4 hashed positions)."""
    nh = d.shape[-1] - (C.MIN_MATCH - 1)
    w32 = _le32(torch.nn.functional.pad(d, (0, 4)))
    lo = w32[..., :nh]
    b5 = d[..., C.MIN_MATCH - 1:C.MIN_MATCH - 1 + nh].long()
    h = (_mul32(lo, _M1) ^ _mul32(b5, _M2)) >> (32 - _HASH_BITS)
    order = torch.argsort(h, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(nh, device=d.device).expand_as(order))
    return w32, lo, b5, h, order, rank


def _merge(lens0, best_len, best_off):
    """Hash matches over run matches: a hash match replaces the run match
    only when longer (ties keep offset 1)."""
    nh = best_len.shape[-1]
    lens = lens0.clone()
    offs = torch.ones_like(lens0)
    use = (best_len >= C.MIN_MATCH) & (best_len > lens[..., :nh])
    lens[..., :nh] = torch.where(use, best_len, lens[..., :nh]).int()
    offs[..., :nh] = torch.where(use, best_off, 1).int()
    return lens, offs


def _word_rounds(w32, n: int, p, c, m, act, rounds: int | None = None):
    """The JAX matcher's extension loop (``encode.py:104-117``): each
    pair of ``act`` advances m by 4 while its next word agrees and
    m + 4 <= n - p, for at most ``rounds`` rounds (None: until no pair
    advances). Returns the pairs that advanced in the last round."""
    r = 0
    while act.numel() and (rounds is None or r < rounds):
        pa, ca, ma = p[act], c[act], m[act]
        adv = ((ma + 4 <= n - pa)
               & (w32[(ca + ma).clamp(max=n - 1)]
                  == w32[(pa + ma).clamp(max=n - 1)]))
        act = act[adv]
        m[act] += 4
        r += 1
    return act


def _byte_tail(d: torch.Tensor, p, c, m, live):
    """The JAX matcher's byte tail: up to 3 more equal bytes for the pairs
    ``live``, never past n - p."""
    n = d.shape[0]
    pad = torch.nn.functional.pad(d, (0, 4))
    for _ in range(3):
        m += (live & (m < n - p)
              & (pad[(c + m).clamp(max=n)] == pad[(p + m).clamp(max=n)]))
    return m


def _extend_rounds(d: torch.Tensor, w32, p, c) -> torch.Tensor:
    """The JAX matcher's extension as it is, the plain version of
    ``_extend_exact``: for pairs c < p < n - 4 whose first 5 bytes agree,
    m = 4, then 4-byte rounds until every pair stops, then the byte tail;
    min(match length, n - p)."""
    m = torch.full_like(p, 4)
    _word_rounds(w32, d.shape[0], p, c, m,
                 torch.arange(p.numel(), device=d.device))
    return _byte_tail(d, p, c, m, torch.ones_like(p, dtype=torch.bool))


def _extend_exact(d: torch.Tensor, w32, p, c) -> torch.Tensor:
    """``_extend_rounds``'s result in at most ``_WORD_ROUNDS`` rounds: the
    pairs still equal after them are measured by the run of equal bytes
    at their lag (one O(n) scan per distinct lag), the rest by the byte
    tail."""
    n = d.shape[0]
    m = torch.full_like(p, 4)
    act = _word_rounds(w32, n, p, c, m,
                       torch.arange(p.numel(), device=d.device),
                       _WORD_ROUNDS)
    lags = p[act] - c[act]
    for lag in torch.unique(lags).tolist():
        sel = act[lags == lag]
        eq = d[lag:] == d[:-lag]                    # eq[i]: d[i] == d[i+lag]
        idx = torch.arange(n - lag, device=d.device)
        nxt = torch.cummin(torch.where(eq, n - lag, idx).flip(0),
                           dim=0).values.flip(0)
        m[sel] = (nxt - idx)[c[sel]]
    live = torch.ones_like(p, dtype=torch.bool)
    live[act] = False
    return _byte_tail(d, p, c, m, live)


def find_matches_device(data: torch.Tensor, n_candidates: int):
    """The XLA matcher: best (len, off) per position of a uint8 block
    (int32; lens == 0 means no match). Candidates are the k-back entries
    of the position's hash group, verified on 5 bytes and extended
    exactly (``_extend_exact``); offset-1 runs stay analytic."""
    n = data.shape[0]
    if n < C.MIN_MATCH + 1:
        return (torch.zeros(n, dtype=torch.int32, device=data.device),
                torch.ones(n, dtype=torch.int32, device=data.device))
    lens0, in_run = _run_matches(data)
    w32, lo, b5, h, order, rank = _hash_order(data)
    nh = h.shape[0]
    p_arr = torch.arange(nh, device=data.device)
    best_len = torch.zeros(nh, dtype=torch.long, device=data.device)
    best_off = torch.zeros_like(best_len)
    searchable = ~in_run[:nh]
    for k in range(1, n_candidates + 1):
        cr = rank - k
        cand = order[cr.clamp(min=0)]
        dist = p_arr - cand
        cc = cand.clamp(max=nh - 1)
        ok = ((cr >= 0) & searchable & (h[cand] == h)
              & (dist >= 1) & (dist <= C.WINDOW_SIZE)
              & (lo[cc] == lo) & (b5[cc] == b5))
        idx = ok.nonzero().squeeze(1)
        m = torch.zeros_like(best_len)
        m[idx] = _extend_exact(data, w32, idx, cand[idx])
        better = ok & (m > best_len)
        best_len = torch.where(better, m, best_len)
        best_off = torch.where(better, dist, best_off)
    return _merge(lens0, best_len, best_off)


def _lcp_pre(blocks: torch.Tensor, K: int):
    """Run matches and the K candidates of every hashed position of each
    block, (B, K, nh), with their validity. An invalid candidate is
    replaced by max(p - 1, 0), measured anyway and masked afterwards; no
    hash-group or 5-byte check (a collision measures below 5)."""
    lens0, in_run = _run_matches(blocks)
    _, _, _, h, order, rank = _hash_order(blocks)
    nh = h.shape[-1]
    p_arr = torch.arange(nh, device=blocks.device)
    searchable = ~in_run[..., :nh]
    cands, oks = [], []
    for k in range(1, K + 1):
        cr = rank - k
        cand = torch.gather(order, -1, cr.clamp(min=0))
        dist = p_arr - cand
        ok = (cr >= 0) & searchable & (dist >= 1) & (dist <= C.WINDOW_SIZE)
        cands.append(torch.where(ok, cand, (p_arr - 1).clamp(min=0)))
        oks.append(ok)
    return lens0, torch.stack(cands, 1), torch.stack(oks, 1)


def _lcp_post(lcp, lens0, oks, cands, n: int, K: int):
    """Best of K per position: each LCP clamped to n - p, the first
    strictly longer candidate wins."""
    B = lcp.shape[0]
    nh = n - (C.MIN_MATCH - 1)
    p_arr = torch.arange(nh, device=lcp.device)
    m2 = torch.minimum(lcp[:, :nh * K].long().view(B, nh, K),
                       (n - p_arr)[:, None])
    best_len = torch.zeros((B, nh), dtype=torch.long, device=lcp.device)
    best_off = torch.zeros_like(best_len)
    for k in range(K):
        mk = torch.where(oks[:, k], m2[:, :, k], 0)
        better = mk > best_len
        best_len = torch.where(better, mk, best_len)
        best_off = torch.where(better, p_arr - cands[:, k], best_off)
    return _merge(lens0, best_len, best_off)


def lcp_inputs(blocks: torch.Tensor, K: int):
    """The LCP kernel's input for (B, n) blocks, 6 <= n <= 65536: the
    pairs (B, nh*K) int32 packed as the JAX matcher packs them,
    ``c | p << 16`` (ascending p, the K candidates of a position
    adjacent), and what ``_lcp_post`` merges them with (lens0, cands,
    oks)."""
    B = blocks.shape[0]
    lens0, cands, oks = _lcp_pre(blocks, K)
    p = torch.arange(cands.shape[-1], device=blocks.device)[:, None]
    pc = EK.pack_pairs(p, cands.transpose(1, 2)).reshape(B, -1)
    return pc, lens0, cands, oks


def find_matches_device_lcp_batch(blocks: torch.Tensor, n_candidates: int):
    """The LCP matcher over (B, n) same-length uint8 blocks, n <= 64 KiB:
    (lens, offs) int32 (B, n). One LCP launch for the batch on the card;
    lengths cap at 256 (offset-1 runs stay uncapped)."""
    B, n = blocks.shape
    if n > EK.MAX_BLOCK:
        raise ValueError(f"the LCP matcher takes blocks of at most "
                         f"{EK.MAX_BLOCK} bytes, not {n}")
    if n < C.MIN_MATCH + 1:
        return (torch.zeros((B, n), dtype=torch.int32, device=blocks.device),
                torch.ones((B, n), dtype=torch.int32, device=blocks.device))
    pc, lens0, cands, oks = lcp_inputs(blocks, n_candidates)
    return _lcp_post(EK.lcp(blocks, pc), lens0, oks, cands, n, n_candidates)


def find_matches_device_lcp(data: torch.Tensor, n_candidates: int):
    """``find_matches_device`` with the extension done by the LCP kernel,
    for one block of at most 64 KiB."""
    lens, offs = find_matches_device_lcp_batch(data[None], n_candidates)
    return lens[0], offs[0]


def _emit_mask(lens, lazy: bool, min_emit: int):
    """Where the parse emits a match: lens >= max(5, min_emit), and with
    ``lazy`` not where the next position is good and longer."""
    good = lens >= max(C.MIN_MATCH, min_emit)
    if not (lazy and lens.shape[-1] > 1):
        return good
    nxt_len = torch.nn.functional.pad(lens[..., 1:], (0, 1))
    nxt_good = torch.nn.functional.pad(good[..., 1:], (0, 1))
    return good & ~(nxt_good & (nxt_len > lens))


def walk_steps(lens, lazy: bool, min_emit: int = 5):
    """The parse's step per position: the match length where it emits, 1
    elsewhere (int32)."""
    return torch.where(_emit_mask(lens, lazy, min_emit), lens, 1).int()


def parse_device(lens, offs, lazy: bool, min_emit: int = 5):
    """Greedy/lazy tiling of the block: True where a kept match starts
    (the pointer-doubling parse, torch ops)."""
    step = walk_steps(lens, lazy, min_emit)
    return EK.chain_marks(step[None])[0] & (step > 1)


def parse_compact_device(lens, offs, lazy: bool, min_emit: int = 5):
    """``parse_device`` plus the compaction of the kept sequences into
    P // 5 + 1 slots: (n_seq, pos, len, off)."""
    keep = parse_device(lens, offs, lazy, min_emit)
    P = lens.shape[0]
    pos = torch.arange(P, device=lens.device)
    n, bufs = EK.compact(keep[None], [pos[None], lens[None], offs[None]],
                         P // C.MIN_MATCH + 1)
    return (n[0],) + tuple(b[0] for b in bufs)


def _walk_compact(lens, offs, lazy: bool, min_emit: int):
    """Batched ``parse_compact_walk`` over (B, P) lens/offs."""
    P = lens.shape[-1]
    n_seq, pos_raw = EK.parse_walk(walk_steps(lens, lazy, min_emit))
    msk = EK.walk_defined(n_seq, pos_raw.shape[-1])
    pos = torch.where(msk, pos_raw.clamp(0, max(P - 1, 0)), 0)
    take = pos.long()
    return (n_seq, pos, torch.where(msk, torch.gather(lens, 1, take), 0),
            torch.where(msk, torch.gather(offs, 1, take), 0))


def parse_compact_walk(lens, offs, lazy: bool, min_emit: int = 5):
    """``parse_compact_device`` through the parse-walk kernel: the same
    (n_seq, pos, len, off)."""
    out = _walk_compact(lens[None], offs[None], lazy, min_emit)
    return tuple(t[0] for t in out)


def _extend_capped_host(arr: np.ndarray, pos, lns, off):
    """Host fixup for the LCP matcher's 256-byte cap: sequences at the cap
    are extended by chunked byte compare (LZ semantics, the copy reads its
    own output), and following sequences the extension swallows are
    dropped (greedy re-tile). The plain form of the native block
    emitter's extension (``block_encode.encode_chunk``'s ``cap_len``)."""
    if not (lns >= EK.CAP).any():
        return pos, lns, off
    n = len(arr)
    o_pos, o_len, o_off = [], [], []
    cursor = 0
    for i in range(len(pos)):
        p0, l0, o0 = int(pos[i]), int(lns[i]), int(off[i])
        if p0 < cursor:
            continue
        if l0 >= EK.CAP:
            q = p0 + l0
            while q < n:
                span = min(4096, n - q)
                neq = np.flatnonzero(arr[q:q + span]
                                     != arr[q - o0:q - o0 + span])
                if len(neq):
                    q += int(neq[0])
                    break
                q += span
            l0 = q - p0
        o_pos.append(p0)
        o_len.append(l0)
        o_off.append(o0)
        cursor = p0 + l0
    return (np.asarray(o_pos, np.int64), np.asarray(o_len, np.int64),
            np.asarray(o_off, np.int64))


# The keys ``compress_device`` adds into its ``_phases`` dict: spans, then
# the counters (its docstring says what each holds).
PHASES = ("frame", "match", "parse", "parse.issue", "parse.readback",
          "emit", "emit.cap", "emit.streams", "emit.literals",
          "emit.hufflit", "d2h_bytes", "emit.native_bytes")
_calls = itertools.count()


def _host_seqs(n_seq, pos, lns, off):
    """Sequences of B blocks to the host in one copy: a list of
    (pos, len, off) int64 arrays, each cut to its block's count. Under
    ``parse.readback``: the stack, the two host waits (the stacked copy,
    then the counts) and the cut; ``d2h_bytes`` counts both copies."""
    with profiling.span("parse.readback"):
        stacked = torch.stack([pos, lns, off])
        host = stacked.cpu().numpy().astype(np.int64)
        counts = n_seq.cpu().numpy()
        seqs = [tuple(host[i, j, :int(counts[j])] for i in range(3))
                for j in range(len(counts))]
    profiling.count("d2h_bytes", stacked.nbytes + n_seq.nbytes)
    return seqs


def _group_seqs(blocks: np.ndarray, dev: torch.device, params,
                use_lcp: bool) -> list:
    """Match and parse of a (B, n) group of blocks on ``dev`` (B is 1 off
    the LCP matcher), and its sequences on the host (``_host_seqs``)."""
    with profiling.span("match"):
        d = torch.from_numpy(np.array(blocks, np.uint8)).to(dev)
        if use_lcp:
            lens, offs = find_matches_device_lcp_batch(d, params.n_candidates)
        else:
            lens, offs = find_matches_device(d[0], params.n_candidates)
    with profiling.span("parse"):
        with profiling.span("parse.issue"):
            if use_lcp:
                out = _walk_compact(lens, offs, params.lazy, params.min_emit)
            else:
                out = tuple(t[None] for t in parse_compact_device(
                    lens, offs, params.lazy, params.min_emit))
        return _host_seqs(*out)


def _encode_block(arr, level: int, checksum: bool, seqs, capped: bool):
    with profiling.span("emit"):
        return block_encode.encode_chunk(arr, level, checksum=checksum,
                                         sequences=seqs,
                                         cap_len=EK.CAP if capped else 0)


def encode_chunk_device(data: bytes | np.ndarray, level: int, device=None,
                        checksum: bool = False) -> bytes:
    """One block with match finding and parse on ``device`` (None means
    cuda) and emission on the host: block header, payload (and checksum).
    No dictionary on this path. One dispatch group of one block, under
    the spans and counter of ``compress_device``."""
    dev = _device(device, "encode_chunk_device")
    arr = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, np.uint8))
    params = level_params(level)
    use_lcp = len(arr) <= EK.MAX_BLOCK and _matcher() == "lcp"
    (seqs,) = _group_seqs(arr[None], dev, params, use_lcp)
    return _encode_block(arr, level, checksum, seqs, use_lcp)


def compress_device(data: bytes, level: int = C.LEVEL_DEFAULT,
                    block_size: int = C.BLOCK_SIZE_DEFAULT, device=None,
                    checksum: bool = False,
                    _phases: dict | None = None) -> bytes:
    """Frame encode with match finding and parse on the device.

    ``device`` None means cuda (raises when CUDA is absent); ``"cpu"``
    runs the kernels' plain versions. On the card with the LCP matcher,
    full blocks go in dispatch groups of up to 16 (one LCP and one
    parse-walk launch a group); the tail block, the XLA matcher and the
    CPU go block by block. The archive is the same bytes whichever route a
    block took, and equals ``zxc_tpu.ops.compress_device``'s.

    The call records ``profiling`` spans and a counter, and never
    synchronises the card for them. ``_phases`` (a dict) receives those
    of ``PHASES``, recorded in a collector of the call's own; without it
    they go to the installed collector, if any. Spans, in seconds:
    ``frame`` (block split, framing, the global hash); ``match`` (the
    group's copy to the device, the hashes, sort and candidates, the LCP
    launch and the best of K: host seconds issuing work, except that the
    copy from pageable memory waits for the card's stream, and the XLA
    matcher's masked gathers size their outputs on the host);
    ``parse``, whose children are ``parse.issue`` (steps, the walk, the
    compaction gathers) and ``parse.readback`` (the stack, the host's
    wait until the group's queued work ends and its sequences are
    copied, then their cut into blocks); ``emit``, a block's host
    emission, one native call (``codec.block_encode.encode_chunk``),
    whose children are that call's stage clocks: ``emit.cap`` (the
    sequences checked and, at the LCP cap, extended), ``emit.streams``
    (literals gathered, tokens, offsets, extras), ``emit.literals`` (the
    literal section's auction) and ``emit.hufflit`` (the all-literal
    candidate), one call each a block and no profiler range. The counter
    ``d2h_bytes`` holds the bytes of every tensor the readback copies, on
    any device; ``emit.native_bytes`` the plaintext bytes of the blocks
    the native emitter wrote (every block of the call). The call's range
    in a profiler trace, ``compress_device``, carries the plaintext bytes
    and a call number of the process, and each group's range, ``group``,
    its index and block count."""
    dev = _device(device, "compress_device")
    C.block_size_code(block_size)  # validate
    params = level_params(level)
    n_full = len(data) // block_size
    use_batch = (n_full >= 2 and block_size <= EK.MAX_BLOCK
                 and _matcher() == "lcp" and dev.type == "cuda")
    blk_bytes: list[bytes] = []
    start = 0
    group = itertools.count()
    with profiling.collect_into(_phases, PHASES), profiling.span(
            "compress_device", {"bytes": len(data), "call": next(_calls)}):
        if use_batch:
            with profiling.span("frame"):
                start = n_full * block_size
                blocks = np.frombuffer(data, np.uint8, start).reshape(
                    n_full, block_size)
            for g0 in range(0, n_full, DISPATCH):
                grp = blocks[g0:g0 + DISPATCH]
                with profiling.span("group", {"index": next(group),
                                              "blocks": len(grp)}):
                    seqs = _group_seqs(grp, dev, params, True)
                    blk_bytes += [_encode_block(grp[j], level, checksum,
                                                seqs[j], True)
                                  for j in range(len(grp))]
        for pos in range(start, len(data), block_size):
            with profiling.span("group", {"index": next(group),
                                          "blocks": 1}):
                blk_bytes.append(encode_chunk_device(
                    data[pos:pos + block_size], level, dev, checksum))
        with profiling.span("frame"):
            out = bytearray(headers.write_file_header(block_size, checksum))
            global_hash = 0
            for blk in blk_bytes:
                if checksum:
                    global_hash = global_hash_update(
                        global_hash, int.from_bytes(blk[-4:], "little"))
                out += blk
            out += headers.write_block_header(C.BLOCK_EOF, 0)
            out += headers.write_file_footer(len(data), global_hash,
                                             checksum)
    return bytes(out)
