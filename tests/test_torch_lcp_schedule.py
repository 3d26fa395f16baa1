"""The schedule of the LCP kernel on the card, as a numpy model run on the
CPU.

``lcp_model`` follows ``csrc/encode.cu``'s ``lcp_kernel`` step by step:
the stage (the block's first n & ~15 bytes as the bulk copy brings them,
then the threads' bytes to ``MARGIN`` past that: the row's below n, 0 from
n on, whatever the row holds past n), the clamp of every start to
min(p, n), the grid of ``encode_kernels.lcp_plan`` (each CTA a contiguous
range of 4-word groups of the 16-byte aligned body, CTA 0's warp 0 the
unaligned edges of the row), each warp's rounds of 32 lanes x 4 pair
words, the first round (``lane_lcp``: up to ``FIRST`` bytes in the pair's
lane, 4 a step from 4-byte loads and funnel shifts, stopping at the first
difference), the queue (a ballot and a popcount a pair slot) and the
warp's finish (while ``BATCH`` or more queued pairs are left, 32 at a
time a pair a lane from byte ``FIRST`` on; the rest a pair a warp step,
lane l comparing bytes [8l, 8l + 8) from two aligned 8-byte loads a side,
the minimum over the lanes). Every read is checked to lie inside the
stage.

It is held against the port's plain version (``encode_kernels.
lcp_reference``) on any pair words, and against the JAX kernel
(``pallas_encode.lcp_pairs``, interpret mode, as
``tests/test_torch_encode.py`` runs it) on ascending pairs, on blocks of
n not a multiple of 4 or 16 and below 16 (no bulk copy), pairs at or past
n, pairs equal through 255 bytes and through 256, all-equal blocks (a
queue of more than 32 long pairs in one warp), random blocks and garbage
words. Tolerance: exact equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lcp_schedule.py
"""
import numpy as np
import pytest
import torch

from zxc_tpu_torch.ops import encode_kernels as EK

FIRST = 32              # csrc/encode.cu kFirst
MARGIN = EK.CAP + 48    # kMargin: staged bytes past n & ~15
QUEUE = 4 * 32          # kQueue: long pairs a warp queues in a round
BATCH = 16              # kBatch: fewest queued pairs finished a lane each
WARPS = EK.LCP_THREADS // 32


def stage_of(row: np.ndarray, n: int) -> np.ndarray:
    """The CTA's stage: the bulk copy of bytes [0, n & ~15), then the
    threads' bytes up to MARGIN past that."""
    nf = n & ~15
    st = np.full(nf + MARGIN, 0xEE, np.uint8)     # what was there before
    st[:nf] = row[:nf]
    x = np.arange(nf, nf + MARGIN)
    st[nf:] = np.where(x < n, row[np.minimum(x, len(row) - 1)], 0)
    return st


def lane_lcp(st: np.ndarray, p: int, c: int, frm: int, to: int) -> int:
    """``lane_lcp``: the first differing byte in [frm, to), or ``to``: 4
    bytes a step, one 4-byte load and a funnel shift a side, stopping at
    the first difference."""
    w = st.view("<u4")
    k, q = (p + frm) >> 2, (c + frm) >> 2
    assert max(k, q) + (to - frm) // 4 < len(w), "a load past the stage"
    sp, sc = 8 * (p & 3), 8 * (c & 3)

    def funnel(lo, hi, sh):
        return ((int(lo) | int(hi) << 32) >> sh) & 0xFFFFFFFF
    a0, b0 = w[k], w[q]
    for r in range(frm, to, 4):
        k, q = k + 1, q + 1
        d = funnel(a0, w[k], sp) ^ funnel(b0, w[q], sc)
        if d:
            return r + ((d & -d).bit_length() - 1) // 8
        a0, b0 = w[k], w[q]
    return to


def stage_u64(st: np.ndarray, x: int) -> int:
    """Bytes x .. x+7 from two aligned 8-byte loads."""
    a0 = x & ~7
    assert a0 + 16 <= len(st), "a finish load past the stage"
    lo, hi = (int(v) for v in st[a0:a0 + 16].view("<u8"))
    return ((lo | hi << 64) >> 8 * (x & 7)) & (2**64 - 1)


def warp_finish(st: np.ndarray, words: list, n: int, stats: dict) -> list:
    """The finish of a warp's queued words: while ``BATCH`` or more are
    left, 32 at a time a pair a lane from byte FIRST on; the rest a pair a
    warp step, lane l comparing bytes [8l, 8l + 8) and the minimum over
    the lanes (256 where none differs)."""
    out, e = list(words), 0
    while len(words) - e >= BATCH:
        for lane in range(min(32, len(words) - e)):
            w = words[e + lane]
            out[e + lane] = lane_lcp(st, min(w >> 16, n), min(w & 0xFFFF, n),
                                     FIRST, EK.CAP)
            stats["batched"] += 1
        e += 32
    for w in words[e:]:
        p, c, r = min(w >> 16, n), min(w & 0xFFFF, n), EK.CAP
        for lane in range(32):
            d = stage_u64(st, p + 8 * lane) ^ stage_u64(st, c + 8 * lane)
            if d:
                r = min(r, 8 * lane + ((d & -d).bit_length() - 1) // 8)
        out[e] = r
        e += 1
        stats["stepped"] += 1
    return out


def lcp_round(st, n, words, out, f, cnt, stats):
    """A warp's round: lane l's ``cnt[l]`` words from flat index f[l]."""
    w = np.zeros((32, 4), np.int64)
    for lane in range(32):
        w[lane, :cnt[lane]] = words[f[lane]:f[lane] + cnt[lane]]
    m = np.zeros((32, 4), np.int64)
    slot = np.zeros((32, 4), np.int64)
    queue, queued = [None] * QUEUE, 0
    for j in range(4):
        lng = np.zeros(32, bool)
        for lane in range(32):
            p, c = (min(int(w[lane, j]) >> 16, n),
                    min(int(w[lane, j]) & 0xFFFF, n))
            m[lane, j] = lane_lcp(st, p, c, 0, FIRST)
            lng[lane] = j < cnt[lane] and m[lane, j] == FIRST
        for lane in np.flatnonzero(lng):       # ballot, popcount
            slot[lane, j] = queued + int(lng[:lane].sum())
            queue[slot[lane, j]] = int(w[lane, j])
        queued += int(lng.sum())
    assert queued <= QUEUE
    stats["max_queue"] = max(stats["max_queue"], queued)
    stats["queued"] += queued
    queue[:queued] = warp_finish(st, queue[:queued], n, stats)
    for lane in range(32):
        for j in range(cnt[lane]):
            if m[lane, j] == FIRST:
                m[lane, j] = queue[slot[lane, j]]
            out[f[lane] + j] += 1 << 20         # written once, checked
            out[f[lane] + j] += m[lane, j]


def lcp_model(blk: np.ndarray, pc: np.ndarray, n: int, sms: int = 132):
    """(B, NP) int64 LCPs of the kernel's schedule, and its statistics:
    the pairs queued, the longest queue of a warp round, and the queued
    pairs finished a lane each and a warp step each."""
    B, NP = pc.shape
    words = (pc.astype(np.int64) & 0xFFFFFFFF).reshape(-1)
    out = np.zeros(B * NP, np.int64)
    split = EK.lcp_plan(B, NP, sms)
    stats = {"queued": 0, "max_queue": 0, "split": split, "batched": 0,
             "stepped": 0}
    for b in range(B):
        st = stage_of(blk[b], n)
        R = b * NP
        head = min((4 - R % 4) % 4, NP)
        G = (NP - head) // 4
        per = -(-G // split)
        for x in range(split):
            g0 = min(G, x * per)
            g1 = min(G, g0 + per)
            for warp in range(WARPS):
                for g in range(g0 + warp * 32, g1, EK.LCP_THREADS):
                    lanes = g + np.arange(32)
                    lcp_round(st, n, words, out, R + head + 4 * lanes,
                              np.where(lanes < g1, 4, 0), stats)
            if x == 0:              # warp 0: the row's unaligned edges
                tail = NP - head - 4 * G
                lanes = np.arange(32)
                lcp_round(st, n, words, out,
                          np.where(lanes < head, R + lanes, R + 4 * G + lanes),
                          np.where(lanes < head + tail, 1, 0), stats)
    assert (out >> 20 == 1).all(), "a pair not written exactly once"
    return (out & ((1 << 20) - 1)).reshape(B, NP), stats


# -- inputs (numpy only: the card tests use them too) -------------------------

def lcp_inputs(case: str, B: int, n: int, NP: int, seed: int = 0,
               L: int | None = None):
    """(blk (B, L) uint8, pc (B, NP) int32) of one case; the row's bytes
    past n are random, never zero. ``equal``: every byte 7, so every pair
    inside the block reaches 256; ``random``: random bytes, pairs end in
    the first round; ``runs`` / ``text``-like: long runs and a periodic
    stretch with pairs at lags 1, 7 and 300; ``edge``: pairs equal through
    exactly 255 and 256 bytes, at and past n; ``garbage``: any int32
    word."""
    rng = np.random.default_rng(seed)
    L = n if L is None else L
    blk = rng.integers(1, 256, (B, L)).astype(np.uint8)
    if case == "equal":
        blk[:, :n] = 7
    elif case == "runs":
        blk[:, :n] = rng.integers(0, 4, (B, n))
        blk[:, n // 4:n // 2] = 7
        per = rng.integers(0, 256, 7).astype(np.uint8)
        blk[:, n // 2:n] = np.resize(per, n - n // 2)
    if case == "garbage":
        return blk, rng.integers(-2**31, 2**31, (B, NP)).astype(np.int32)
    p = np.sort(rng.integers(0, max(n, 1), (B, NP)), axis=1)
    back = rng.choice([1, 7, 300], (B, NP))
    c = np.where(rng.random((B, NP)) < 0.5, p - back,
                 rng.integers(0, max(n, 1), (B, NP)))
    c = np.maximum(c, 0)
    if case == "edge":
        # bytes [a, a + 255) equal to [d, d + 255), then one differing;
        # and [a2, a2 + 256) equal to [d2, d2 + 256) (n >= 1036)
        blk[:, :n] = rng.integers(0, 256, (B, n))
        d2, a2, d, a = 0, 260, 520, 780
        blk[:, a2:a2 + 256] = blk[:, d2:d2 + 256]
        blk[:, a:a + 255] = blk[:, d:d + 255]
        blk[:, a + 255] = blk[:, d + 255] ^ 1
        k = np.arange(NP)
        p = np.where(k % 4 == 0, a, np.where(k % 4 == 1, a2, p))
        c = np.where(k % 4 == 0, d, np.where(k % 4 == 1, d2, c))
        p[:, -3:] = [n, n + 5, 65535]                # at and past n
        c[:, -3:] = [n - 1, 65535, n]
    p, c = np.minimum(p, 65535), np.minimum(c, 65535)
    return blk, ((p << 16) | c).astype(np.uint32).view(np.int32)


def plain(blk, pc, n):
    return EK.lcp_reference(torch.from_numpy(blk), torch.from_numpy(pc),
                            n).numpy()


CASES = [("equal", 2, 2048, 1030), ("random", 3, 4093, 2001),
         ("runs", 2, 4100, 3000), ("random", 2, 12, 37),
         ("edge", 2, 4099, 1503), ("garbage", 3, 1000, 523),
         ("edge", 1, 65531, 2050)]


@pytest.mark.parametrize("case,B,n,NP", CASES)
def test_lcp_model_equals_plain_version(case, B, n, NP):
    blk, pc = lcp_inputs(case, B, n, NP, seed=n + NP, L=-(-(n + 1) // 16) * 16)
    got, stats = lcp_model(blk, pc, n)
    assert np.array_equal(got, plain(blk, pc, n))
    if case == "equal":      # every pair in the block is long
        assert stats["max_queue"] > 32
    if case == "edge":
        flat = got.reshape(-1)
        assert (flat == 255).any() and (flat == 256).any()


@pytest.mark.parametrize("case,n", [("runs", 4093), ("random", 4100),
                                    ("edge", 2063), ("equal", 512),
                                    ("random", 12)])
def test_lcp_model_equals_jax_kernel(case, n):
    """Ascending pairs with c and p inside the block, as the JAX kernel's
    callers pack them; the JAX entry clamps to n - p, so the model's
    result is clamped the same."""
    from zxc_tpu.ops import pallas_encode as JPE
    blk, pc = lcp_inputs(case, 1, n, 700, seed=n)
    w = pc.astype(np.int64) & 0xFFFFFFFF
    p, c = w >> 16, w & 0xFFFF
    keep = (p < n) & (c < n)
    order = np.argsort(p[keep], kind="stable")
    p, c = p[keep][order], c[keep][order]
    pc1 = ((p << 16) | c).astype(np.uint32).view(np.int32)[None]
    got, _ = lcp_model(blk[:, :n], pc1, n)
    want = JPE.lcp_pairs(blk[0, :n], p, c, interpret=True)
    assert np.array_equal(np.minimum(got[0], n - p), want)


def test_lcp_model_reads_no_row_byte_past_n():
    """The same block with other bytes past n gives the same result, and
    the plain version agrees: nothing past n is read."""
    blk, pc = lcp_inputs("edge", 2, 1100, 400, seed=3, L=1152)
    other = blk.copy()
    other[:, 1100:] ^= 0x5A
    a, _ = lcp_model(blk, pc, 1100)
    b, _ = lcp_model(other, pc, 1100)
    assert np.array_equal(a, b) and np.array_equal(a, plain(blk, pc, 1100))


@pytest.mark.parametrize("B,NP,sms,want", [
    (16, 327_660, 132, 8), (1, 40, 132, 1), (3, 17_000, 132, 5),
    (16, 327_660, 8, 1), (70_000, 1024, 132, 1)])
def test_lcp_plan(B, NP, sms, want):
    """One wave at LCP_CTAS_PER_SM CTAs an SM, never more CTAs than
    rounds of the block's words."""
    assert EK.lcp_plan(B, NP, sms) == want


def test_lcp_model_splits_a_block_over_ctas():
    blk, pc = lcp_inputs("runs", 2, 4096, 9001, seed=9)
    got, stats = lcp_model(blk, pc, 4096, sms=12)
    assert stats["split"] > 1
    assert np.array_equal(got, plain(blk, pc, 4096))


@pytest.mark.parametrize("long_pairs", [15, 16, 40, 128])
def test_lcp_model_finish_paths(long_pairs):
    """A warp round with 15 long pairs finishes each in a warp step; with
    16 or more, 32 at a time in their own lanes, the rest of 40 (8) in
    warp steps; results equal the plain version either way."""
    blk, pc = lcp_inputs("random", 1, 4096, 128, seed=long_pairs, L=4096)
    blk[0, :2048] = 9                       # pairs inside it are long
    w = pc.astype(np.int64) & 0xFFFFFFFF
    rng = np.random.default_rng(long_pairs)
    inside = rng.permutation(128)[:long_pairs]
    p = np.where(np.isin(np.arange(128), inside), rng.integers(0, 1700, 128),
                 2100 + np.arange(128))
    c = np.where(np.isin(np.arange(128), inside), rng.integers(0, 1700, 128),
                 2500 + np.arange(128))
    pc = ((p << 16) | c).astype(np.uint32).view(np.int32)[None]
    got, stats = lcp_model(blk, pc, 4096)
    assert np.array_equal(got, plain(blk, pc, 4096))
    assert stats["queued"] == long_pairs
    if long_pairs < BATCH:
        assert stats["stepped"] == long_pairs
    else:
        assert stats["batched"] == long_pairs - long_pairs % 32 + (
            long_pairs % 32 if long_pairs % 32 >= BATCH else 0)
