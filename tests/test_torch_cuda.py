"""Card tests of the PyTorch port: each CUDA kernel (v19, v25, v26, v27,
v13, the attic's quad-tile generations as ``quad`` in modes 12, 14-17, 20,
21, 23 and 24, lcp, parse_walk, the attic's piece-serial kernel, window
merge and lane sum, and the probes of ``tools/``: v12's quad ablations,
the lane-sum probes and the gathers: gather_axis1 on the grid gather's
kernels at the probe's six shapes and at edge shapes of each form, with
its own launch count; the row gather's forms also on unaligned, long-row
and empty tables, indices outside the table and a reused output block,
and form b, a warp a row, on rows of 127, 129 and 256 words, a table off
16 bytes and G of 1, 1,023 and 3,000, its geometry refused outside 1-32
warps a CTA) against its plain PyTorch version on the card, on
valid and on garbage control, misaligned or non-contiguous operands
refused; v25, v26 and v27 also on a (supertile, block) grid larger
than the card holds at once, on plans with the longest dependency chain
and with reads on both sides of the stored-row boundary, and over
repeated launches on one stream and on two; v13 and v19 at every cluster
size of the tile routine, with every slot on one target row, and v19
with three planes; and lcp on all-equal, random and tail blocks and
garbage words, rows off 16 bytes, and its refused geometries; the window
merge on plans whose every op covers the whole window, over one round of
its stage and over two; the piece-serial kernel on equal starts, windows
of many one-byte pieces (several stage rounds), literal indices past both
ends of the row and one piece a block; the lane sum over several chunks
of 32 batches a tile and with every slot spanning all 128 lanes; and the
cold, hint, serial, v25 and attic decodes
(``attic_quad``'s ten entries included), the default expansion route (no
hand-written kernel),
``Seekable.decompress_range_device``, the device entropy decode
(``pivco_device.route_sections`` on levels 3 and 7 sections, and
``ops.decompress(device_entropy=True)`` at 16, 64 and 512 KiB blocks,
kernel-free, with its corruption refusals), ``Dctx(device=True)``,
``entry.entry()``, the sharded decode (``parallel.decode_plan_sharded``
and ``decode_plan_dp_sp`` over an NCCL group of one rank) and
``entry.dryrun_multichip(1)``, the device encode against the CPU path,
and the command line's ``-z --device --hints`` and ``-d --device
--hints`` with their launches. They need an NVIDIA card with
nvcc, are marked ``cuda`` and skip without one. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX, which the card's
machine does not have; this file imports no JAX.) Tolerance: exact byte
equality.
"""
import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch.ops import copy_engine as CE

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_group(seed: int, B: int, NST: int, MAXQ: int, RLP: int, K: int,
                 self_ref: bool, lit_max: int = 256, garbage: bool = False,
                 rows: int = 128):
    """One dispatch group of random control made with numpy. Valid control
    keeps quads in range, 16-aligned windows inside the window rows and
    target rows < ``rows``; ``garbage`` breaks all of that. ``rows=32``
    makes v13's layout: 32-row tiles (NST of them) and int32 tq."""
    rng = np.random.default_rng(seed)
    NR = NST * rows
    NG32 = 32 * -(-4 * MAXQ // 128)
    win_rows = RLP + NR if self_ref else RLP
    shape = (B, K * NG32, 128)
    if garbage:
        qs = rng.integers(-4, MAXQ + 5, (B, NST + 1)).astype(np.int32)
        qbase = rng.integers(-64, win_rows + 64, (B, MAXQ)).astype(np.int32)
        rowrel = rng.integers(0, 2048, shape)
        tq = (rng.integers(-40, 300, (B, MAXQ, 128)).astype(np.int32)
              if rows == 32 else
              rng.integers(0, 256, (B, MAXQ, 128)).astype(np.uint8))
    else:
        qs = np.zeros((B, NST + 1), np.int32)
        for b in range(B):
            # odd per-supertile quad counts included: the trailing quad of
            # an odd count is skipped
            counts = rng.integers(0, MAXQ // NST + 1, NST)
            qs[b, 1:] = np.minimum(np.cumsum(counts), MAXQ)
        qbase = (rng.integers(0, (win_rows - 128) // 16 + 1, (B, MAXQ)) * 16
                 ).astype(np.int32)
        rowrel = rng.integers(0, 128, shape)
        rowrel[:, NG32:] = 0
        tq = rng.integers(0, rows, (B, MAXQ, 128)).astype(
            np.int32 if rows == 32 else np.uint8)
    roll = rng.integers(0, 128, shape)
    s = rng.integers(0, 128, shape)
    e = np.minimum(s + rng.integers(0, 70, shape), 127)
    w = (roll | (s << 7) | (e << 14) | (rowrel << 21)).astype(np.uint32)
    w[rng.random(shape) < 0.2] = 1 << 7             # the packer's filler
    lit8 = rng.integers(0, lit_max, (B, RLP, 128)).astype(np.uint8)
    return qs, qbase, w.view(np.int32), tq, lit8


def flat_group(seed: int, group, garbage: bool = False):
    """v27's layout of a v26 ``group``: each block's first litrows rows
    (random, 1..RLP) back to back at 32-aligned offsets in one flat buffer
    with an RLP-row tail. ``garbage`` draws loff anywhere, negative and
    past the buffer included. Returns (qs, qbase, loff, pctrl, tq, flat)
    and RLP."""
    qs, qbase, pctrl, tq, lit8 = group
    rng = np.random.default_rng(seed)
    B, RLP = lit8.shape[:2]
    litrows = rng.integers(1, RLP + 1, B)
    lr32 = -(-litrows // 32) * 32
    loff = np.zeros(B, np.int64)
    loff[1:] = np.cumsum(lr32[:-1])
    flat = np.zeros((int(loff[-1] + lr32[-1]) + RLP, 128), np.uint8)
    for b in range(B):
        flat[loff[b]:loff[b] + litrows[b]] = lit8[b, :litrows[b]]
    if garbage:
        loff = rng.integers(-96, len(flat) + 96, B)
    return (qs, qbase, loff.astype(np.int32), pctrl, tq, flat), RLP


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("variant", [19, 26])
def test_kernel_equals_plain_version_on_card(card, variant, garbage):
    for seed, (B, NST, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                                (16, 4, 96, 640))):
        args = CE.group_from_numpy(*random_group(
            seed, B, NST, MAXQ, RLP, 2, variant == 26, garbage=garbage),
            device=card)
        before = CE.KERNELS[variant].launches
        out = CE.KERNELS[variant](*args)
        torch.cuda.synchronize()
        assert CE.KERNELS[variant].launches == before + 1
        assert torch.equal(out, CE.REFERENCES[variant](*args))


@pytest.mark.parametrize("garbage", [False, True])
def test_v27_equals_plain_version_on_card(card, garbage):
    for seed, (B, NST, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                                (16, 4, 96, 640))):
        host, RLP = flat_group(seed, random_group(
            seed, B, NST, MAXQ, RLP, 2, True, garbage=garbage), garbage)
        args = CE.group_from_numpy(*host, device=card)
        before = CE.v27.launches
        out = CE.v27(*args, RLP=RLP)
        torch.cuda.synchronize()
        assert CE.v27.launches == before + 1
        assert torch.equal(out, CE.v27_reference(*args, RLP=RLP))


def _plan_words(rng, K: int, kind: str):
    """Plane words (rowrel 0) of one slot covering every lane once: plane
    0 below a split, plane 1 from it (or plane 0 alone); ``kind`` "mixed"
    also makes overlapping planes (the higher wins), gaps and filler."""
    roll = rng.integers(0, 128, K)
    words = [1 << 7] * K
    cut = int(rng.integers(1, 128))
    lo1 = cut
    if kind == "mixed" and rng.random() < 0.3:
        lo1 = max(cut - int(rng.integers(1, 20)), 0)     # overlap
    if K == 1 or rng.random() < 0.25:
        words[0] = int(roll[0] | (127 << 14))
    else:
        words[0] = int(roll[0] | ((cut - 1) << 14))
        words[1] = int(roll[1] | (lo1 << 7) | (127 << 14))
    if kind == "mixed" and rng.random() < 0.2:
        words[0] = int(roll[0] | (5 << 7) | (60 << 14))  # lanes uncovered
    if kind == "mixed" and rng.random() < 0.1:
        words = [1 << 7] * K                             # filler
    for j in range(2, K):
        if rng.random() < 0.5:
            s = int(rng.integers(0, 128))
            words[j] = int(roll[j] | (s << 7) | (min(s + 9, 127) << 14))
    return words


def plan_group(seed: int, B: int, NST: int, RLP: int, K: int = 2,
               kind: str = "chain"):
    """A v26 dispatch group whose adds never collide: each supertile's
    quads (two of 64 live slots) target each tile row once, so every sum
    stays a byte (the JAX kernel's bf16 window is exact). ``kind``:
    "chain", every quad of supertile t >= 1 reads rows of supertile t-1
    (the longest dependency); "boundary", one quad of supertile t >= 1
    reads output rows t*128-64 .. t*128+63 (slot rows 63 and 64: the last
    stored row and the first row that must read 0 though the block's
    later CTAs store it; supertile 0's straddles RLP), the other lit
    rows; "mixed", windows in lit
    rows, straddling RLP, in stored and in unstored output rows, targets
    and rows out of range, odd quad counts (the trailing quad runs
    nowhere) and empty supertiles. Returns (qs, qbase, pctrl, tq, lit8)."""
    rng = np.random.default_rng(seed)
    NR = NST * 128
    blocks = []
    for b in range(B):
        quads, bounds = [], [0]
        for t in range(NST):
            rows = rng.permutation(128)
            nq = 2
            if kind == "mixed":
                nq = int(rng.choice([0, 1, 2, 2, 3]))
            for h in range(nq):
                if kind == "chain":
                    base = (RLP + (t - 1) * 128 if t else
                            16 * int(rng.integers(0, (RLP - 128) // 16 + 1)))
                elif kind == "boundary" and h == 0:
                    base = RLP + t * 128 - 64
                elif kind == "boundary":     # lit rows keep tiles busy
                    base = 16 * int(rng.integers(0, (RLP - 128) // 16 + 1))
                else:
                    opts = [16 * int(rng.integers(0, (RLP - 128) // 16 + 1)),
                            RLP - 64,
                            RLP + 16 * int(rng.integers(0, (NR - 128) // 16
                                                        + 1))]
                    if t:
                        opts.append(RLP + 16 * int(rng.integers(
                            0, max(t * 128 - 128, 0) // 16 + 1)))
                    base = int(rng.choice(opts))
                slots = []
                for i in range(64):
                    rowrel = int(rng.integers(0, 128))
                    if kind == "boundary" and h == 0:
                        rowrel = (63, 64, rowrel)[i % 3]
                    tgt = int(rows[(64 * h + i) % 128])
                    if kind == "mixed" and rng.random() < 0.05:
                        rowrel = int(rng.integers(128, 2048))
                    if kind == "mixed" and rng.random() < 0.05:
                        tgt = int(rng.integers(128, 256))
                    slots.append((rowrel, tgt, _plan_words(rng, K, kind)))
                quads.append((base, slots))
            bounds.append(len(quads))
        blocks.append((bounds, quads))
    MAXQ = max(2, max(len(q) for _, q in blocks))
    NG32 = 32 * -(-4 * MAXQ // 128)
    qs = np.zeros((B, NST + 1), np.int32)
    qbase = np.zeros((B, MAXQ), np.int32)
    pctrl = np.full((B, K * NG32, 128), 1 << 7, np.int64)
    tq = np.zeros((B, MAXQ, 128), np.uint8)
    for b, (bounds, quads) in enumerate(blocks):
        qs[b] = bounds
        for q, (base, slots) in enumerate(quads):
            qbase[b, q] = base
            for i, (rowrel, tgt, words) in enumerate(slots):
                bat = 4 * q + (i >> 5)
                for j in range(K):
                    pctrl[b, j * NG32 + 32 * (bat >> 7) + (i & 31),
                          bat & 127] = words[j] | (rowrel << 21 if j == 0
                                                   else 0)
                tq[b, q, i] = tgt
    lit8 = rng.integers(0, 256, (B, RLP, 128)).astype(np.uint8)
    return (qs, qbase, pctrl.astype(np.uint32).view(np.int32), tq, lit8)


def as_v25(group):
    """v25's form of a v26 ``group``: a quad whose window starts in the
    block's own output (qbase >= RLP) carries ``OUT_QB_FLAG`` with its
    output row instead (qbase - RLP + OUT_QB_FLAG), as ``v25_group`` makes
    them; the others keep their lit rows, so a window straddling RLP reads
    only its rows below RLP."""
    qs, qbase, pctrl, tq, lit8 = group
    RLP = lit8.shape[1]
    flagged = np.where(qbase >= RLP, qbase.astype(np.int64) - RLP
                       + CE.OUT_QB_FLAG, qbase)
    return qs, flagged.astype(np.int32), pctrl, tq, lit8


# v25/v26/v27 on the (supertile, block) grid: NST = 32 (the 512 KiB
# blocks' first group, 512 CTAs, more than the card holds at once) and 4
BIG = (16, 32, 832, 4608)


def _self_ref_call(variant: int, host, card):
    """(kernel call, plain call) of v25 (``as_v25`` of the v26 ``host``
    group), v26 or v27 (its flat layout) on the card."""
    if variant in (25, 26):
        if variant == 25:
            host = as_v25(host)
        args = CE.group_from_numpy(*host, device=card)
        kern, ref = CE.KERNELS[variant], CE.REFERENCES[variant]
        return lambda: kern(*args), lambda: ref(*args)
    flat, RLP = flat_group(7, host)
    args = CE.group_from_numpy(*flat, device=card)
    return (lambda: CE.v27(*args, RLP=RLP),
            lambda: CE.v27_reference(*args, RLP=RLP))


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("variant", [25, 26, 27])
def test_self_ref_grid_larger_than_card_on_card(card, variant, garbage):
    kern, ref = _self_ref_call(variant, random_group(
        31, *BIG, 2, True, garbage=garbage), card)
    before = CE.KERNELS[variant].launches
    out = kern()
    torch.cuda.synchronize()
    assert CE.KERNELS[variant].launches == before + 1
    assert torch.equal(out, ref())


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("variant", [25, 26, 27])
def test_self_ref_ranges_over_one_scan_on_card(card, variant, garbage):
    """Supertile ranges of more than 1024 quads (MAXQ 4200 over 2
    supertiles; with seed 32 supertile 1 runs 1,202 quads of valid and
    2,942 of garbage control): a CTA lists and adds its quads in several
    scans, pass 2 in each."""
    kern, ref = _self_ref_call(variant, random_group(
        32, 2, 2, 4200, 512, 2, True, garbage=garbage), card)
    out = kern()
    torch.cuda.synchronize()
    assert torch.equal(out, ref())


@pytest.mark.parametrize("kind", ["chain", "boundary", "mixed"])
@pytest.mark.parametrize("variant", [25, 26, 27])
def test_self_ref_dependency_plans_on_card(card, variant, kind):
    for seed, (B, NST, RLP, K) in enumerate(((16, 32, 4608, 2),
                                             (16, 4, 768, 2),
                                             (3, 8, 256, 3))):
        kern, ref = _self_ref_call(variant, plan_group(
            seed, B, NST, RLP, K, kind), card)
        out = kern()
        torch.cuda.synchronize()
        assert torch.equal(out, ref())


@pytest.mark.parametrize("variant", [25, 26, 27])
def test_self_ref_repeated_launches_on_card(card, variant):
    """50 launches on one stream, two plans in turn (each call's output
    and scratch reuse the last call's memory, which holds the other
    plan's bytes and set flags), then launches alternating between two
    streams: each equals its plain version."""
    calls = [_self_ref_call(variant, plan_group(
        40 + k, 16, 32, 4608, 2, kind), card)
        for k, kind in enumerate(("boundary", "chain"))]
    want = [ref() for _, ref in calls]
    before = CE.KERNELS[variant].launches
    for n in range(50):
        out = calls[n % 2][0]()
        assert torch.equal(out, want[n % 2]), f"launch {n}"
        del out
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for r in range(10):
        outs = []
        for k, s in enumerate(streams):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                outs.append(calls[(k + r) % 2][0]())
        torch.cuda.synchronize()
        for k, o in enumerate(outs):
            assert torch.equal(o, want[(k + r) % 2]), f"round {r}"
        del outs
    assert CE.KERNELS[variant].launches == before + 70


@pytest.mark.parametrize("garbage", [False, True])
def test_v13_equals_plain_version_on_card(card, garbage):
    for seed, (B, NT, MAXQ, RLP) in enumerate(((3, 1, 8, 256),
                                               (16, 4, 48, 512))):
        args = CE.group_from_numpy(*random_group(
            seed, B, NT, MAXQ, RLP, 1, False, garbage=garbage, rows=32),
            device=card)
        before = CE.v13.launches
        out = CE.v13(*args)
        torch.cuda.synchronize()
        assert CE.v13.launches == before + 1
        assert torch.equal(out, CE.v13_reference(*args))


# every cluster size the tile plan can give (1 to 8 CTAs a tile)
CLUSTERS = (1, 2, 4, 8)


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("variant", [13, 19])
def test_tile_routine_at_every_cluster_size_on_card(card, variant, C,
                                                    garbage):
    """v13 and v19 with the cluster size forced: each CTA of a tile's
    cluster adds its share of the slots, the cluster sums the tiles."""
    for seed, (B, NT, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                               (16, 1, 32, 256),
                                               (16, 4, 96, 640))):
        rows = 32 if variant == 13 else 128
        args = CE.group_from_numpy(*random_group(
            seed, B, NT, MAXQ, RLP, 1 if variant == 13 else 2, False,
            garbage=garbage, rows=rows), device=card)
        out = CE.KERNELS[variant](*args, _cluster=C)
        torch.cuda.synchronize()
        assert torch.equal(out, CE.REFERENCES[variant](*args))


def test_tile_routine_refuses_a_bad_cluster_on_card(card):
    args = CE.group_from_numpy(*random_group(0, 2, 1, 8, 256, 1, False,
                                             rows=32), device=card)
    for C in (0, 3, 16):
        with pytest.raises(RuntimeError, match="cudaError"):
            CE.v13(*args, _cluster=C)


@pytest.mark.parametrize("variant", [13, 19])
def test_one_target_row_takes_every_slot_on_card(card, variant):
    """Every slot of every batch is live and adds into tile row 5: the
    shared-memory atomics of 32 slots a batch (and of a cluster's CTAs)
    meet on one row; sums pass 255 and wrap mod 256."""
    B, NT, MAXQ, RLP = 4, 2, 16, 256
    rows = 32 if variant == 13 else 128
    K = 1 if variant == 13 else 2
    qs, qbase, pctrl, tq, lit8 = random_group(3, B, NT, MAXQ, RLP, K, False,
                                              rows=rows)
    qs[:] = np.arange(NT + 1) * (MAXQ // NT)
    w = pctrl.view(np.uint32) & ~np.uint32(0x3FFF << 7)
    w |= np.uint32(127 << 14)                       # every lane, plane 0
    pctrl = w.view(np.int32)
    tq[:] = 5
    for C in CLUSTERS:
        args = CE.group_from_numpy(qs, qbase, pctrl, tq, lit8, device=card)
        out = CE.KERNELS[variant](*args, _cluster=C)
        torch.cuda.synchronize()
        want = CE.REFERENCES[variant](*args)
        assert torch.equal(out, want)
        assert want.view(B, NT, rows, 128)[:, :, 5].any()


def test_v19_three_planes_on_card(card):
    """K = 3: the third plane is read per slot, past the two a lane holds
    (kRegPlanes), on the tile routine at every cluster size."""
    for seed, garbage in ((0, False), (1, True)):
        args = CE.group_from_numpy(*random_group(
            seed, 16, 4, 96, 640, 3, False, garbage=garbage), device=card)
        for C in CLUSTERS:
            out = CE.v19(*args, K=3, _cluster=C)
            torch.cuda.synchronize()
            assert torch.equal(out, CE.v19_reference(*args, K=3))


def _card_corpus(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return (b"card test " * 9000
            + rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()) * 3


@pytest.mark.parametrize("hint_variant", [19, 26])
def test_hint_e2e_on_card(card, tmp_path, hint_variant):
    data = _card_corpus(5)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    path = Z.write_hints(arc, str(tmp_path / "a.zxh"), variant=hint_variant)
    kern = CE.KERNELS[27 if hint_variant == 26 else 19]
    before = kern.launches
    assert Z.decompress_e2e(arc, hint=path, dispatch=4) == data
    assert kern.launches - before == -(-(-(-len(data) // 16384)) // 4)
    assert Z.decompress_e2e(arc, device=card, hint=path, dispatch=4,
                            _collect="fingerprint") == \
        Z.decompress_e2e(arc, device="cpu", hint=path, dispatch=4,
                         _collect="fingerprint")


@pytest.mark.parametrize("block", [4096, 16384])
def test_serial_on_card(card, block):
    data = _card_corpus(6)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=block))
    kern = CE.v13 if block < 16384 else CE.v19
    before = kern.launches
    out = Z.ops.decompress(arc, use_serial=True)
    assert out == data == Z.ops.decompress(arc, device="cpu",
                                           use_serial=True)
    assert kern.launches - before == -(-(-(-len(data) // block)) // 16)


@pytest.mark.parametrize("variant", [19, 26])
def test_e2e_on_card(card, variant):
    rng = np.random.default_rng(variant)
    data = (b"card test " * 9000
            + rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()) * 3
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    kern = CE.KERNELS[variant]
    before = kern.launches
    assert Z.decompress_e2e(arc, dispatch=4, variant=variant) == data
    assert kern.launches - before == -(-(-(-len(data) // 16384)) // 4)
    assert Z.decompress_e2e(arc, device=card, dispatch=4, variant=variant,
                            _collect="fingerprint") == \
        Z.decompress_e2e(arc, device="cpu", dispatch=4, variant=variant,
                         _collect="fingerprint")


def random_pairs(seed: int, B: int, n: int, NP: int, garbage: bool):
    """Blocks and packed LCP pairs (``c | p << 16``) made with numpy.
    Valid pairs are ascending p with c < p inside the block, many with
    long runs (c = p - 1 in a filled stretch, c = p - 7 in a periodic
    one); ``garbage`` draws any int32 word: p <= c, positions at or past
    n and p past 32767 included."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 4, (B, n)).astype(np.uint8)
    blk[:, n // 4:n // 2] = 7                                 # a long run
    per = rng.integers(0, 256, 7).astype(np.uint8)
    blk[:, n // 2:] = np.resize(per, n - n // 2)              # periodic
    if garbage:
        return blk, rng.integers(-2**31, 2**31, (B, NP)).astype(np.int32)
    p = np.sort(rng.integers(1, max(n, 2), (B, NP)), axis=1)
    back = rng.choice([1, 7, 300], (B, NP))
    c = np.maximum(p - np.where(rng.random((B, NP)) < 0.5, back,
                                rng.integers(1, max(n, 2), (B, NP))), 0)
    return blk, ((p << 16) | c).astype(np.uint32).astype(np.int32)


@pytest.mark.parametrize("garbage", [False, True])
def test_lcp_equals_plain_version_on_card(card, garbage):
    from zxc_tpu_torch.ops import encode_kernels as EK
    for seed, (B, n, NP) in enumerate(((1, 12, 40), (3, 4093, 5000),
                                       (16, 65536, 300_000))):
        blk, pc = (torch.from_numpy(a).to(card)
                   for a in random_pairs(seed, B, n, NP, garbage))
        before = EK.lcp.launches
        out = EK.lcp(blk, pc)
        torch.cuda.synchronize()
        assert EK.lcp.launches == before + 1
        assert torch.equal(out, EK.lcp_reference(blk, pc))


@pytest.mark.parametrize("NP", [327_660, 327_661])
@pytest.mark.parametrize("case", ["equal", "random", "tail", "garbage"])
def test_lcp_adversarial_blocks_on_card(card, case, NP):
    """The group's shape (16 blocks of 64 KiB): all-equal blocks (every
    pair inside the block reaches 256: every warp round queues its 128
    pairs), random blocks (pairs end in the first round), the tail block
    of n = 65,536 - 5 with random bytes past n in its row (pairs equal
    through 255 and 256 bytes, starts at and past n), and garbage words;
    327,661 pairs a block puts the rows off 16 bytes (the edge lanes).
    One launch a call, equal to the plain version."""
    from zxc_tpu_torch.ops import encode_kernels as EK
    from test_torch_lcp_schedule import lcp_inputs
    n = 65536 - 5 if case == "tail" else 65536
    blk, pc = (torch.from_numpy(a).to(card) for a in lcp_inputs(
        "edge" if case == "tail" else case, 16, n, NP, seed=NP,
        L=65536))
    before = EK.lcp.launches
    out = EK.lcp(blk, pc, n)
    torch.cuda.synchronize()
    assert EK.lcp.launches == before + 1
    assert torch.equal(out, EK.lcp_reference(blk, pc, n))
    if case == "equal":      # nearly every pair goes through the queue
        assert float((out == EK.CAP).float().mean()) > 0.9


def test_lcp_refuses_a_bad_geometry_on_card(card):
    """zxc_lcp returns cudaErrorInvalidValue (1) for a split outside
    [1, 65535], n past 65,536 or the row, a row length off 16 bytes,
    B past 65,535, NP below 0 and an operand off 16 bytes."""
    from zxc_tpu_torch.ops import _build
    lib = _build.encode_kernels()
    blk = torch.zeros((2, 4096), dtype=torch.uint8, device=card)
    pc = torch.zeros((2, 64), dtype=torch.int32, device=card)
    out = torch.empty_like(pc)
    stream = torch.cuda.current_stream().cuda_stream

    def rc(blk_p=blk.data_ptr(), pc_p=pc.data_ptr(), B=2, L=4096, n=4096,
           NP=64, split=1):
        return lib.zxc_lcp(blk_p, pc_p, out.data_ptr(), B, L, n, NP, split,
                           stream)

    assert rc() == 0
    torch.cuda.synchronize()
    for bad in (dict(split=0), dict(split=65536), dict(n=65537, L=65552),
                dict(n=4097), dict(L=4100), dict(B=65536), dict(NP=-1),
                dict(pc_p=pc.data_ptr() + 4), dict(blk_p=blk.data_ptr() + 8)):
        assert rc(**bad) == 1, bad


@pytest.mark.parametrize("garbage", [False, True])
def test_parse_walk_equals_plain_version_on_card(card, garbage):
    from zxc_tpu_torch.ops import encode_kernels as EK
    for seed, (B, P) in enumerate(((1, 1), (2, 2048), (16, 65536))):
        rng = np.random.default_rng(seed)
        if garbage:
            step = rng.integers(-5, 70_000, (B, P))
            step[:, ::3] = rng.integers(-3, 4, (B, len(step[0, ::3])))
            step[B // 2] = 2             # more records than pos holds
        else:
            lens = rng.integers(0, 40, (B, P))
            step = np.where(lens >= 5, lens, 1)
        step = torch.from_numpy(step.astype(np.int32)).to(card)
        before = EK.parse_walk.launches
        nseq, pos = EK.parse_walk(step)
        torch.cuda.synchronize()
        assert EK.parse_walk.launches == before + 1
        rn, rp = EK.parse_walk_reference(step)
        live = EK.walk_defined(rn, rp.shape[1])
        assert torch.equal(nseq, rn)
        assert torch.equal(torch.where(live, pos, 0), rp)


@pytest.mark.parametrize("name,B", [
    ("all5", 16), ("all3", 16), ("all2", 16), ("half5", 16),
    ("ones_then3", 16), ("jumps", 16), ("odd_p", 3), ("p200k", 2),
    ("p200k_all5", 2), ("p200k_jumps", 2), ("p200k_garbage", 2)])
def test_parse_walk_schedules_on_card(card, name, B):
    """The parallel walk on steps where walks never meet (all 5, all 3, in
    half the row), with more records than pos holds (all 2), jumps over
    whole chunks, P off the chunk size and rows of 200,000 steps (the
    global-memory form, garbage steps included): one launch a call, equal
    to the plain version, and the rounds and serial finish of the numpy
    model of ``tests/test_torch_walk_schedule.py``."""
    from zxc_tpu_torch.ops import encode_kernels as EK
    from test_torch_walk_schedule import inputs, walk_model
    if name == "p200k_garbage":
        rng = np.random.default_rng(5)
        rows = rng.integers(-5, 12, (B, 200_000))
        rows[1, ::7] = rng.integers(-2**31, 2**31 - 1, len(rows[1, ::7]))
    else:
        row = inputs(name)
        rows = np.stack([np.roll(row, 5 * b) if b % 2 else row
                         for b in range(B)])
    step = torch.from_numpy(rows.astype(np.int32)).to(card)
    assert EK.walk_plan(step.shape[1]).shared == (step.shape[1] <= 65536)
    before = EK.parse_walk.launches
    nseq, pos = EK.parse_walk(step)
    torch.cuda.synchronize()
    assert EK.parse_walk.launches == before + 1
    rn, rp = EK.parse_walk_reference(step)
    live = EK.walk_defined(rn, rp.shape[1])
    assert torch.equal(nseq, rn)
    assert torch.equal(torch.where(live, pos, 0), rp)
    stats = EK.walk_rounds(step).cpu().numpy()
    for b in range(B):
        n, _, rounds, serial_from = walk_model(rows[b])
        assert n == int(rn[b])
        assert stats[b].tolist() == [rounds, serial_from], b


def test_parse_walk_refuses_a_bad_geometry_on_card(card):
    from zxc_tpu_torch.ops import _build, encode_kernels as EK
    P = 70_000
    step = torch.ones((2, P), dtype=torch.int32, device=card)
    nseq = torch.empty(2, dtype=torch.int32, device=card)
    pos = torch.empty((2, P // 5 + 1), dtype=torch.int32, device=card)
    bits = torch.empty((2, 2 * -(-P // 32)), dtype=torch.int32, device=card)
    fn = _build.encode_kernels().zxc_parse_walk
    stream = torch.cuda.current_stream().cuda_stream
    good = EK.walk_plan(P)

    def launch(n, chunk, shared, smem, rounds=EK.WALK_MAX_ROUNDS,
               scratch=bits):
        return fn(step.data_ptr(), nseq.data_ptr(), pos.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), None, 2,
                  n, P // 5 + 1, chunk, shared, smem, rounds, stream)

    assert launch(P, good.chunk, 0, 0) == 0
    for args in ((P, 48, 0, 0), (P, 0, 0, 0), (P, 32, 0, 0),
                 (P, good.chunk, 1, EK.walk_plan(P).smem),
                 (P, good.chunk, 0, 16), (P, good.chunk, 0, 0, 0),
                 (P, good.chunk, 0, 0, 1, None),
                 (4096, 32, 1, EK.walk_plan(4096).smem + 16)):
        assert launch(*args) == 1, args
    torch.cuda.synchronize()
    assert nseq.tolist() == [0, 0]


@pytest.mark.parametrize("level", [1, 3, 5])
def test_compress_device_on_card_equals_cpu(card, level):
    from zxc_tpu_torch.ops import encode_kernels as EK
    data = (_card_corpus(level) * 3)[:1 << 20]
    before = (EK.lcp.launches, EK.parse_walk.launches)
    arc = Z.ops.compress_device(data, level=level, block_size=65536)
    groups = -(-(len(data) // 65536) // 16) + (len(data) % 65536 > 0)
    assert (EK.lcp.launches - before[0],
            EK.parse_walk.launches - before[1]) == (groups, groups)
    assert arc == Z.ops.compress_device(data, level=level, block_size=65536,
                                        device="cpu")
    assert Z.codec.frame.decompress(arc) == data


def test_compress_device_phases_on_card_never_synchronize(card, monkeypatch,
                                                          tmp_path):
    """``compress_device(_phases=...)`` on the card: every span and
    counter, ``torch.cuda.synchronize`` called zero times, the readback's
    bytes in their closed form (one group of 16 full blocks and the tail
    block), and in a ``profiling.trace`` the program's ranges beside the
    kernels."""
    import json
    from zxc_tpu_torch import profiling
    from zxc_tpu_torch.ops import encode as PE
    data = (_card_corpus(3) * 3)[:(1 << 20) + 1000]
    want = Z.ops.compress_device(data, level=3, block_size=65536)
    calls = []
    real = torch.cuda.synchronize

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    ph = {}
    assert Z.ops.compress_device(data, level=3, block_size=65536,
                                 _phases=ph) == want
    assert calls == []
    assert set(ph) == set(PE.PHASES)
    cap = 65536 // 5 + 1
    assert ph["d2h_bytes"] == (3 * 16 * cap * 4 + 16 * 4
                               + 3 * (1000 // 5 + 1) * 4 + 4)
    # the dispatch group's blocks and the tail, all by the native emitter
    assert ph["emit.native_bytes"] == len(data)
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    with profiling.trace(str(tmp_path)) as path:
        Z.ops.compress_device(data, level=3, block_size=65536, _phases={})
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"}
    assert {"zxc.match", "zxc.parse.readback",
            "zxc.group index=0 blocks=16",
            "zxc.group index=1 blocks=1"} <= names
    assert any("lcp_kernel" in n for n in names)
    assert any("parse_walk_kernel" in n for n in names)


def test_cli_device_hints_on_card(card, tmp_path, monkeypatch):
    """The command line on the card: ``-z --device -B 64K --hints`` runs
    lcp and parse_walk once per group of 16 full blocks and once for the
    tail block, and writes the archive ``compress_device`` makes; ``-d
    --device --hints`` decodes it through the hint it wrote, v27 once per
    dispatch group of 16 blocks."""
    from zxc_tpu_torch import cli
    from zxc_tpu_torch.ops import encode_kernels as EK
    data = (_card_corpus(3) * 5)[:(2 << 20) + 1000]
    (tmp_path / "d.bin").write_bytes(data)
    monkeypatch.chdir(tmp_path)
    before = (EK.lcp.launches, EK.parse_walk.launches)
    assert cli.main(["-z", "-k", "-q", "--device", "-B", "64K", "--hints",
                     "d.bin"]) == 0
    groups = -(-(len(data) // 65536) // 16) + (len(data) % 65536 > 0)
    assert (EK.lcp.launches - before[0],
            EK.parse_walk.launches - before[1]) == (groups, groups)
    arc = (tmp_path / "d.bin.zxc").read_bytes()
    assert arc == Z.ops.compress_device(data, level=3, block_size=65536,
                                        checksum=True)
    assert (tmp_path / "d.bin.zxc.zxh").exists()
    before = CE.v27.launches
    assert cli.main(["-d", "-q", "--device", "--hints", "-o", "d.out",
                     "d.bin.zxc"]) == 0
    assert CE.v27.launches - before == -(-(-(-len(data) // 65536)) // 16)
    assert (tmp_path / "d.out").read_bytes() == data
    before = CE.v27.launches
    assert cli.main(["-t", "--device", "-q", "d.bin.zxc"]) == 0
    assert CE.v27.launches == before       # -t takes the expansion route


def random_pieces(seed: int, B: int, block: int, garbage: bool):
    """(npieces, totals, pcs, lit8) of the attic kernel made with numpy:
    piece starts ascending from 0 with [c, s, k] that keep sources inside
    the lit row, or with ``garbage`` any int32 s, k below 1 and huge, c
    past both ends of the row, counts past pcs and totals below 0 and
    past the block (starts stay ascending: the
    kernel's contract)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, block // 8))
    PR = -(-(n + 1) * 4 // 128)
    pcs = np.zeros((B, PR, 128), np.int32)
    f = pcs.reshape(B, -1, 4)
    RL = 40
    for b in range(B):
        po = np.sort(rng.integers(0, block, n))
        po[0] = 0
        f[b, :n, 0] = po
        f[b, n:, 0] = block + np.arange(f.shape[1] - n)   # still ascending
        if garbage:
            f[b, :n, 1] = rng.integers(-300, RL * 128 + 300, n)
            f[b, :n, 2] = rng.integers(-2**31, 2**31, n)
            f[b, :n, 3] = rng.choice([-5, 0, 1, 1, 9, 2**31 - 1], n)
        else:
            k = rng.choice([1, 2, 3, 7, 64, 500], n)
            f[b, :n, 3] = k
            f[b, :n, 1] = k + rng.integers(0, 2000, n)
            f[b, :n, 2] = po + rng.integers(-600, 600, n)
    npieces = np.full(B, n, np.int32)
    totals = np.full(B, block, np.int32)
    if garbage:
        npieces = rng.integers(-2, f.shape[1] + 50, B).astype(np.int32)
        totals = rng.integers(-5, block + 3000, B).astype(np.int32)
    lit8 = rng.integers(0, 256, (B, RL, 128), dtype=np.uint8)
    return npieces, totals, pcs, lit8


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("fill_from_s", [False, True])
def test_attic_kernel_equals_plain_version_on_card(card, fill_from_s,
                                                   garbage):
    from zxc_tpu_torch.ops import attic as A
    for seed, (B, block) in enumerate(((1, 1024), (3, 4096), (16, 65536))):
        t = [torch.from_numpy(a).to(card)
             for a in random_pieces(seed, B, block, garbage)]
        before = A.piece_serial.launches
        out = A.piece_serial(*t, block=block, fill_from_s=fill_from_s)
        torch.cuda.synchronize()
        assert A.piece_serial.launches == before + 1
        assert torch.equal(out, A.piece_serial_reference(
            *t, block=block, fill_from_s=fill_from_s))


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_attic_route_on_card(card, variant):
    from zxc_tpu_torch.ops import attic as A, batch as BT
    data = _card_corpus(7)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    plan = BT.plan_frame(arc)
    pieces, lits = BT.resolve_serial(plan)
    for args in A.pack_groups(pieces, lits, plan.totals, 16384, 4):
        t = [torch.from_numpy(a).to(card) for a in args]
        fill = variant != 1
        assert torch.equal(
            A.piece_serial(*t, block=16384, fill_from_s=fill),
            A.piece_serial_reference(*t, block=16384, fill_from_s=fill))
    before = A.piece_serial.launches
    assert Z.ops.decompress(arc, use_serial=True, variant=variant,
                            dispatch=4) == data
    assert A.piece_serial.launches - before == -(-plan.n_blocks // 4)


def window_plan(seed: int, B: int, block: int, mode: int,
                garbage: bool = False, RL: int = 40):
    """(wstart, ops, lit8) of the window merge made with numpy. Valid
    plans are the JAX bodies' contract: wstart from 0, never decreasing,
    inside the ops; up to 40 ops a window (v6/v7 windows need not start on
    a multiple of their unroll), dst ranges that overlap, run past the
    window or are empty, fills with f3 past 256, nets of 0, W - 1, W,
    negative and huge, and srow negative or past the lit rows. The ops
    array has the 24 rows past the last op that the JAX bodies' staging
    reads. ``garbage`` draws wstart and every op field from any int32
    (wstart kept near the ops)."""
    rng = np.random.default_rng(seed)
    NW = block // 1024
    op_rows = max(48, -(-40 * NW * 4 // 128) + 24)
    cap = op_rows * 32
    W = 2048 if mode == 4 else 1024
    ops = np.zeros((B, op_rows, 128), np.int32)
    f = ops.reshape(B, cap, 4)
    if garbage:
        wstart = rng.integers(-40, cap + 60, (B, NW + 1)).astype(np.int32)
        f[:] = rng.integers(-2**31, 2**31, f.shape)
        d = rng.integers(0, 1200, (B, len(f[0, ::3])))
        f[:, ::3, 2] = d | ((d + 300) << 16)          # some live ranges
    else:
        wstart = np.zeros((B, NW + 1), np.int32)
        wstart[:, 1:] = np.cumsum(rng.integers(0, 41, (B, NW)), axis=1)
        n = cap
        f[..., 0] = rng.choice([0, 8, 16, RL - 16, -1, -37, RL - 3, RL + 50,
                                13], (B, n))
        f[..., 1] = rng.choice([0, W - 1, W, -1, -W - 5, 3 * W + 7, 2**30,
                                -2**30, 517], (B, n))
        dlo = rng.integers(0, 1024, (B, n))
        dhi = np.minimum(dlo + rng.choice([0, 1, 5, 200, 1024, 70000],
                                          (B, n)), 65535)
        f[..., 2] = dlo | (dhi << 16)
        f[..., 3] = np.where(rng.random((B, n)) < 0.3,
                             rng.choice([1, 2, 256, 300, -4], (B, n)), 0)
    lit8 = rng.integers(0, 256, (B, RL, 128), dtype=np.uint8)
    return wstart, ops, lit8


def lane_plan(seed: int, B: int, block: int, mode: int,
              garbage: bool = False, RL: int = 48):
    """(ts, rows, pctrl, lit, layers) of the lane sum made with numpy
    (``ts``/``rows`` None where the mode takes none). Valid plans keep
    every batch inside the control (and, for v9, the rows), with tiles of
    0-14 batches (counts that are not multiples of 4 included), lane
    ranges that overlap so sums pass 255, empty ops, rolls up to the
    field's width, and rows negative or past the lit rows (v9) or at or
    past them (v10/v11). v9's lit is any int32. ``garbage`` draws ts,
    rows, pctrl and layers from any int32 (ts and layers kept small
    enough for a test)."""
    rng = np.random.default_rng(seed)
    NT = block // 4096
    layers = 6 if mode == 11 else 0
    if mode == 11:
        NB = NT * layers
    else:
        ts = np.zeros((B, NT + 1), np.int64)
        ts[:, 1:] = np.cumsum(rng.integers(0, 15, (B, NT)), axis=1)
        NB = int(ts.max())
    MAXB = max(-(-NB // 8) * 8, 8)
    G32 = 32 * -(-MAXB // 128)
    shape = (B, G32, 128)
    rl = rng.integers(0, 256 if mode == 9 else 128, shape)
    s = rng.integers(0, 128, shape)
    e1 = np.clip(s + rng.integers(-3, 90, shape), 0, 127)
    if mode == 9:
        w = rl | (s << 8) | (e1 << 16)
        rows = rng.integers(-RL - 10, RL + 10, (B, MAXB * 32))
        lit = rng.integers(-2**31, 2**31, (B, RL, 128)).astype(np.int32)
    else:
        w = rl | (s << 7) | (e1 << 14) | (rng.integers(0, RL + 8, shape)
                                          << 21)
        rows = None
        lit = rng.integers(0, 256, (B, RL, 128)).astype(np.uint8)
    if garbage:
        w = rng.integers(0, 2**32, shape)
        if mode == 9:
            rows = rng.integers(-2**31, 2**31, (B, MAXB * 32))
        if mode == 11:
            layers = int(rng.integers(0, 300))
        else:
            ts = rng.integers(-300, MAXB + 300, (B, NT + 1))
    ts = None if mode == 11 else ts.astype(np.int32)
    rows = None if rows is None else rows.astype(np.int32)
    return ts, rows, w.astype(np.uint32).view(np.int32), lit, layers


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("mode", [4, 5, 6, 7])
def test_window_merge_equals_plain_version_on_card(card, mode, garbage):
    from zxc_tpu_torch.ops import attic as A
    for seed, (B, block) in enumerate(((1, 1024), (3, 4096), (16, 65536))):
        t = [torch.from_numpy(a).to(card)
             for a in window_plan(seed, B, block, mode, garbage)]
        before = A.window_merge.launches
        out = A.window_merge(*t, block=block, mode=mode)
        torch.cuda.synchronize()
        assert A.window_merge.launches == before + 1
        assert torch.equal(out, A.window_merge_reference(*t, block=block,
                                                         mode=mode))


@pytest.mark.parametrize("per_window", [1024, 1300])
@pytest.mark.parametrize("mode", [4, 5, 6, 7])
def test_window_merge_whole_window_ops_on_card(card, mode, per_window):
    """Ops that each cover the whole window (the skip to a round's last
    whole-window op): 1,024 a window (one full round of the stage) and
    1,300 (two rounds; the second round's ops cover the first half only,
    so the second half resolves to an op of the first round, read from
    the ops array)."""
    from zxc_tpu_torch.ops import attic as A
    from test_torch_window_schedule import cover_plan
    t = [torch.from_numpy(a).to(card)
         for a in cover_plan(per_window, 4, 16384, mode, per_window)]
    before = A.window_merge.launches
    out = A.window_merge(*t, block=16384, mode=mode)
    torch.cuda.synchronize()
    assert A.window_merge.launches == before + 1
    assert torch.equal(out, A.window_merge_reference(*t, block=16384,
                                                     mode=mode))


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("mode", [9, 10, 11])
def test_lane_sum_equals_plain_version_on_card(card, mode, garbage):
    from zxc_tpu_torch.ops import attic as A
    for seed, (B, block) in enumerate(((1, 4096), (3, 8192), (16, 65536))):
        ts, rows, pctrl, lit, layers = (
            torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
            for a in lane_plan(seed, B, block, mode, garbage))
        before = A.lane_sum.launches
        out = A.lane_sum(pctrl, lit, block, mode, ts=ts, rows=rows,
                         layers=layers)
        torch.cuda.synchronize()
        assert A.lane_sum.launches == before + 1
        assert torch.equal(out, A.lane_sum_reference(
            pctrl, lit, block, mode, ts=ts, rows=rows, layers=layers))


@pytest.mark.parametrize("fill_from_s", [False, True])
@pytest.mark.parametrize("case", ["edges", "before row", "one-byte windows",
                                  "one piece a block"])
def test_attic_kernel_schedule_edges_on_card(card, case, fill_from_s):
    """The piece-serial kernel's search, stage rounds and owner map on
    equal starts, windows of 300 and of 1,024 one-byte pieces (several
    stage rounds), windows of 1,024 pieces with one start, fills, literal
    indices past both ends of the row, a total inside a window, and one
    piece spanning each block."""
    from zxc_tpu_torch import attic_ab as AB
    from zxc_tpu_torch.ops import attic as A
    from test_torch_piece_schedule import edge_plans
    if case in ("edges", "before row"):
        block = 4096
        pieces, lits, totals = edge_plans(3, block, case == "before row")
        host = A.pack_blocks(pieces, lits, totals, block)[0]
    else:
        block = AB.BLOCK
        lits = [np.random.default_rng(j).integers(0, 256, 5000, np.uint8)
                for j in range(AB.DISPATCH)]
        host = AB.piece_worst_cases(lits, 0)[
            "1,024 pieces a window" if case == "one-byte windows"
            else "one piece a block"]
    t = [torch.from_numpy(a).to(card) for a in host]
    before = A.piece_serial.launches
    out = A.piece_serial(*t, block=block, fill_from_s=fill_from_s)
    torch.cuda.synchronize()
    assert A.piece_serial.launches == before + 1
    assert torch.equal(out, A.piece_serial_reference(
        *t, block=block, fill_from_s=fill_from_s))


@pytest.mark.parametrize("per_tile", [33, 70])
@pytest.mark.parametrize("mode", [9, 10, 11])
def test_lane_sum_several_chunks_on_card(card, mode, per_tile):
    """Tiles of 33 and 70 batches (v11: layers): two and three chunks of
    32 batches a warp."""
    from zxc_tpu_torch.ops import attic as A
    from test_torch_lane_schedule import long_plan
    ts, rows, pctrl, lit, layers = (
        torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
        for a in long_plan(per_tile, 3, 8192, mode, per_tile))
    before = A.lane_sum.launches
    out = A.lane_sum(pctrl, lit, 8192, mode, ts=ts, rows=rows, layers=layers)
    torch.cuda.synchronize()
    assert A.lane_sum.launches == before + 1
    assert torch.equal(out, A.lane_sum_reference(
        pctrl, lit, 8192, mode, ts=ts, rows=rows, layers=layers))


@pytest.mark.parametrize("probe", [None, "nomask", "floor", "norotate_add"])
def test_lane_sum_every_slot_all_lanes_on_card(card, probe):
    """Every live slot spanning all 128 lanes (the most bytes a slot
    covers), v10's packing of a corpus group, through the production mode
    and the probes that cover every lane."""
    from zxc_tpu_torch import attic_ab as AB
    from zxc_tpu_torch.ops import attic as A, batch as BT
    data = _card_corpus(11)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    plan = BT.plan_frame(arc)
    pieces, lits = BT.resolve_serial(plan)
    _, ts, pctrl, lit8 = A.pack_blocks_v10(pieces[:8], lits[:8],
                                           plan.totals[:8], 16384)
    ts, pctrl, lit8 = (torch.from_numpy(a).to(card)
                       for a in (ts, AB.all_lanes(pctrl), lit8))
    want = A.lane_sum_reference(pctrl, lit8, 16384, 10, ts=ts, probe=probe)
    if probe is None:
        out = A.lane_sum(pctrl, lit8, 16384, 10, ts=ts)
    else:
        from zxc_tpu_torch.ops import _build
        L = _build.attic_kernels()
        out = torch.empty_like(want)
        A._launch("zxc_lane_sum_probe", L.zxc_lane_sum_probe, ts.data_ptr(),
                  pctrl.data_ptr(), pctrl.shape[1], lit8.data_ptr(),
                  lit8.shape[1], out.data_ptr(), 8, 16384,
                  A.LANE_PROBES[probe])
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_attic_kernels_refuse_bad_operands_on_card(card):
    from zxc_tpu_torch.ops import attic as A
    ws, ops, lit8 = (torch.from_numpy(a).to(card)
                     for a in window_plan(0, 2, 4096, 5))
    odd = torch.empty(ops.numel() + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        A.window_merge(ws, ops.transpose(1, 2).contiguous().transpose(1, 2),
                       lit8, block=4096, mode=5)
    with pytest.raises(ValueError, match="aligned"):
        A.window_merge(ws, odd[1:].view(ops.shape), lit8, block=4096, mode=5)
    ts, rows, pctrl, lit, _ = (torch.from_numpy(a).to(card)
                               if isinstance(a, np.ndarray) else a
                               for a in lane_plan(0, 2, 8192, 9))
    with pytest.raises(ValueError, match="contiguous"):
        A.lane_sum(pctrl, lit.transpose(1, 2).contiguous().transpose(1, 2),
                   8192, 9, ts=ts, rows=rows)
    with pytest.raises(ValueError, match="aligned"):
        A.lane_sum(pctrl, lit, 8192, 9, ts=ts,
                   rows=torch.empty(rows.numel() + 1, dtype=torch.int32,
                                    device=card)[1:].view(rows.shape))


@pytest.mark.parametrize("variant", [4, 5, 6, 7, 9, 10, 11])
def test_attic_window_and_lane_paths_on_card(card, variant):
    from zxc_tpu_torch.ops import attic as A, batch as BT
    data = _card_corpus(10)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    plan = BT.plan_frame(arc)
    pieces, lits = BT.resolve_serial(plan)
    if variant < 8:
        kern = A.window_merge
        fn = lambda **kw: A.decode_blocks_v4(pieces, lits, plan.totals,
                                             16384, variant=variant, **kw)
    else:
        kern = A.lane_sum
        entry = {9: A.decode_blocks_v9, 10: A.decode_blocks_v10,
                 11: A.decode_blocks_v11}[variant]
        fn = lambda **kw: entry(pieces, lits, plan.totals, 16384, **kw)
    before = kern.launches
    assert b"".join(fn(dispatch=4)) == data
    assert kern.launches - before == -(-plan.n_blocks // 4)
    assert fn(dispatch=4, device="cpu") == fn(dispatch=4, device=card)


def quad_plan(seed: int, B: int, NT: int, MAXQ: int, RLP: int, mode: int,
              garbage: bool = False, K: int = 2):
    """(qs, qbase, pctrl, tq, lit8) of ``copy_engine.quad`` in ``mode``,
    made with numpy: K planes of control for the K-plane modes (one for
    12-17), qs of 2*NT+1 columns for v20, tq of the mode's type. Valid
    plans stay inside the JAX bodies' defined range (quads in [0, MAXQ),
    16-aligned windows (32 for v17) inside the RLP rows) and reach their
    corners: tile quad counts that are odd and not multiples of 4, a range
    whose end lies below its start (nothing runs; v14 runs the (q1 - q0)
    mod 4 quads just below q1), slot rows at or past 128, target rows
    outside the tile, plane-1 words covering lanes in v20's plane-0 range,
    and sums past 255 (many slots a target row), all far below 2^24.
    ``garbage`` draws qs, qbase, rows and target rows from anywhere."""
    from zxc_tpu_torch.ops.copy_engine import QUAD_MODES
    m = QUAD_MODES[mode]
    rng = np.random.default_rng(seed)
    nk = K if m.multi else 1
    NG32 = 32 * -(-4 * MAXQ // 128)
    shape = (B, nk * NG32, 128)
    W = 2 * NT + 1 if m.split else NT + 1
    tq_dt = np.uint8 if m.tq == torch.uint8 else np.int32
    if garbage:
        qs = rng.integers(-4, MAXQ + 5, (B, W))
        qbase = rng.integers(-64, RLP + 64, (B, MAXQ))
        rowrel = rng.integers(0, 2048, shape)
        tq = rng.integers(0, 256, (B, MAXQ, 128)) if tq_dt == np.uint8 \
            else rng.integers(-40, 300, (B, MAXQ, 128))
    else:
        qs = np.zeros((B, W), np.int64)
        cap = max(2 * MAXQ // (W - 1), 1)
        for b in range(B):
            counts = rng.integers(0, cap + 1, W - 1)
            if b == 1:
                counts[0] = 5             # odd, not a multiple of 4
            qs[b] = np.minimum(np.cumsum(np.r_[5 if b == 0 else 0, counts]),
                               MAXQ)
            c = int(rng.integers(1, W))       # a range that ends below q0
            if qs[b, c - 1] > 3:
                qs[b, c] = max(qs[b, c - 1] - int(rng.integers(1, 7)), 3)
        align = 32 if mode == 17 else 16
        qbase = rng.integers(0, (RLP - 128) // align + 1, (B, MAXQ)) * align
        rowrel = np.where(rng.random(shape) < 0.1,
                          rng.integers(128, 2048, shape),
                          rng.integers(0, 128, shape))
        tq = rng.integers(-3, m.rows + 3, (B, MAXQ, 128))
        if tq_dt == np.uint8:
            tq = rng.integers(0, m.rows + 12, (B, MAXQ, 128))
    roll = rng.integers(0, 128, shape)
    s = rng.integers(0, 128, shape)
    e = np.minimum(s + rng.integers(0, 70, shape), 127)
    w = (roll | (s << 7) | (e << 14) | (rowrel << 21)).astype(np.uint32)
    w[rng.random(shape) < 0.2] = 1 << 7             # the packer's filler
    lit8 = rng.integers(0, 256, (B, RLP, 128), dtype=np.uint8)
    return (qs.astype(np.int32), qbase.astype(np.int32), w.view(np.int32),
            tq.astype(tq_dt), lit8)


QUAD_MODES = (12, 14, 15, 16, 17, 20, 21, 23, 24)


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("mode", QUAD_MODES)
def test_quad_equals_plain_version_on_card(card, mode, garbage):
    rows = CE.QUAD_MODES[mode].rows
    for seed, (B, NT, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                               (16, 4, 96, 640))):
        NT = NT * 4 if rows == 32 else NT
        args = CE.group_from_numpy(*quad_plan(seed, B, NT, MAXQ, RLP, mode,
                                              garbage), device=card)
        before = CE.quad.launches
        out = CE.quad(*args, mode=mode)
        torch.cuda.synchronize()
        assert CE.quad.launches == before + 1
        assert torch.equal(out, CE.quad_reference(*args, mode=mode))


def test_quad_refuses_bad_operands_on_card(card):
    qs, qbase, pctrl, tq, lit8 = CE.group_from_numpy(
        *quad_plan(0, 2, 1, 24, 256, 15), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        CE.quad(qs, qbase, pctrl, tq,
                lit8.transpose(1, 2).contiguous().transpose(1, 2), mode=15)
    odd = torch.empty(pctrl.numel() + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        CE.quad(qs, qbase, odd[1:].view(pctrl.shape), tq, lit8, mode=15)
    with pytest.raises(TypeError):                  # never converted
        CE.quad(qs, qbase, pctrl, tq.to(torch.uint8), lit8, mode=15)


@pytest.mark.parametrize("variant", [12, 14, 15, 16, 17, 20, 21, 22, 23, 24])
def test_attic_quad_paths_on_card(card, variant):
    from zxc_tpu_torch.ops import attic_quad as Q, batch as BT
    data = _card_corpus(11)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=65536))
    plan = BT.plan_frame(arc)
    pieces, lits = BT.resolve_serial(plan)
    fn = Q.ENTRIES[variant]
    before = _all_launches()
    q0 = CE.quad.launches
    assert b"".join(fn(pieces, lits, plan.totals, 65536, dispatch=4)) == data
    n = -(-plan.n_blocks // 4)
    assert (CE.quad.launches - q0, _all_launches() - before) == (n, n)
    assert fn(pieces, lits, plan.totals, 65536, dispatch=4, device="cpu") \
        == fn(pieces, lits, plan.totals, 65536, dispatch=4, device=card)


def _all_launches():
    from zxc_tpu_torch.ops import attic as A, encode_kernels as EK
    return (sum(k.launches for k in CE.KERNELS.values())
            + sum(k.launches for k in EK.KERNELS.values())
            + sum(k.launches for k in A.KERNELS.values()))


@pytest.mark.parametrize("block", [4096, 65536])
def test_default_and_chase_routes_on_card(card, block):
    data = _card_corpus(8)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=block))
    before = _all_launches()
    for kw in ({}, dict(use_pieces=False)):
        ph = {}
        assert Z.ops.decompress(arc, _phases=ph, batch=8, **kw) == data \
            == Z.ops.decompress(arc, device="cpu", batch=8, **kw)
        assert ph["route"] == ("chase" if kw else "pieces")
    assert _all_launches() == before    # tensor ops only


def _corpus_head(nbytes: int) -> bytes:
    """The pinned corpus's first ``nbytes`` (``tools/gen_corpus.py``):
    about half its blocks carry PivCo literal sections at level 3."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from gen_corpus import gen_corpus
    return gen_corpus(nbytes)


def _every_launch():
    from zxc_tpu_torch.ops import probes as P
    return _all_launches() + sum(k.launches for k in P.KERNELS.values())


@pytest.mark.parametrize("level", [3, 7])
def test_route_sections_on_card_equals_cpu(card, level):
    from zxc_tpu_torch.codec.block_decode import DeferredSection
    from zxc_tpu_torch.ops import pivco_device as PV
    arc = Z.compress(_corpus_head(4 << 20), Z.EncodeOpts(level=level,
                                                         block_size=65536))
    secs = [l for l in Z.ops.plan_frame(arc, defer_entropy=True).lit
            if isinstance(l, DeferredSection)]
    assert secs
    args = ([s.payload for s in secs], [s.n for s in secs],
            [s.tree for s in secs])
    got = PV.decode_sections_device(*args)
    want = PV.decode_sections_device(*args, device="cpu")
    for g, w, s in zip(got, want, secs):
        assert np.array_equal(g, w) and np.array_equal(g, s.decode())
    # padding lanes included, and a wider L
    plans = [PV.plan_section(*a) for a in zip(*args)]
    host, L, _, _, rounds = PV.pad_plans(args[0], plans, L=1 << 17)
    on_card = PV.route_padded(host, L, rounds, card).cpu()
    assert torch.equal(on_card, PV.route_padded(host, L, rounds, "cpu"))


@pytest.mark.parametrize("level,block", [(3, 65536), (7, 16384),
                                         (3, 524288)])
def test_device_entropy_route_on_card(card, level, block):
    data = _corpus_head(4 << 20)
    arc = Z.compress(data, Z.EncodeOpts(level=level, block_size=block,
                                        checksum=True))
    before = _every_launch()
    ph = {}
    ck = Z.DecodeOpts(checksum=True)
    assert Z.ops.decompress(arc, ck, device_entropy=True, _phases=ph) \
        == data == Z.ops.decompress(arc, ck, device="cpu",
                                    device_entropy=True)
    assert _every_launch() == before    # tensor ops only
    assert ph["route"] == "chase" and ph["entropy_sections"] > 0
    bad = bytearray(arc)
    bad[len(bad) // 2] ^= 0x41
    for a, opts in ((bytes(bad), ck), (arc[:len(arc) // 2], None)):
        with pytest.raises(Z.ZxcError):
            Z.ops.decompress(a, opts, device_entropy=True)


def test_dctx_and_entry_on_card(card):
    from zxc_tpu_torch import entry
    data = _corpus_head(1 << 20)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=65536))
    assert Z.Dctx(device=True).decompress(arc) == data
    assert Z.Dctx(device="cuda", checksum=True).decompress(arc) == data
    fn, args = entry.entry()
    assert all(a.is_cuda for a in args)
    fc, ac = entry.entry(device="cpu")
    for g, w in zip(fn(*args), fc(*ac)):
        assert torch.equal(g.cpu(), w)


def test_decompress_range_device_on_card(card):
    data = _card_corpus(9)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384,
                                        seekable=True))
    sek = Z.seekable.Seekable.open_bytes(arc)
    before = _all_launches()
    for off, length in ((0, len(data)), (16384 - 5, 3 * 16384 + 11)):
        assert sek.decompress_range_device(off, length, batch=4) == \
            sek.decompress_range_device(off, length, device="cpu",
                                        batch=4) == data[off:off + length]
    assert _all_launches() == before


def v25_group(seed: int, B: int, NST: int, MAXQ: int, RLP: int,
              garbage: bool = False):
    """A v19-layout group for v25: about a third of the quads carry
    ``OUT_QB_FLAG`` (valid: a 16-aligned output row at most NR - 128, as
    the packer clamps it; ``garbage``: any row, negative and past NR
    included), so slots read rows of earlier, current and later
    supertiles."""
    qs, qbase, pctrl, tq, lit8 = random_group(seed, B, NST, MAXQ, RLP, 2,
                                              False, garbage=garbage)
    rng = np.random.default_rng(seed + 100)
    NR = NST * 128
    out_q = rng.random(qbase.shape) < 0.35
    if garbage:
        rows = rng.integers(-64, NR + 300, qbase.shape)
    else:
        rows = rng.integers(0, (NR - 128) // 16 + 1, qbase.shape) * 16
    qbase = np.where(out_q, CE.OUT_QB_FLAG + rows, qbase).astype(np.int32)
    return qs, qbase, pctrl, tq, lit8


@pytest.mark.parametrize("garbage", [False, True])
def test_v25_equals_plain_version_on_card(card, garbage):
    for seed, (B, NST, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                                (16, 4, 96, 640))):
        host = v25_group(seed, B, NST, MAXQ, RLP, garbage)
        assert (host[1] >= CE.OUT_QB_FLAG).any()
        args = CE.group_from_numpy(*host, device=card)
        before = CE.v25.launches
        out = CE.v25(*args)
        torch.cuda.synchronize()
        assert CE.v25.launches == before + 1
        assert torch.equal(out, CE.v25_reference(*args))


def test_v25_path_on_card(card):
    import os
    import sys
    from zxc_tpu_torch import runtime as prt
    from zxc_tpu_torch.ops import batch as BT, serial as S
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from gen_corpus import gen_corpus
    data = gen_corpus(1 << 20)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=65536))
    plan = BT.plan_frame(arc)
    pieces, lits = BT.resolve_serial(plan, self_ref=True)
    assert any((p[3] == prt.KOUT).any() for p in pieces)
    before = _all_launches()
    q0 = CE.v25.launches
    assert b"".join(S.decode_blocks_v25(pieces, lits, plan.totals, 65536,
                                        dispatch=4)) == data
    n = -(-plan.n_blocks // 4)
    assert (CE.v25.launches - q0, _all_launches() - before) == (n, n)
    assert S.decode_blocks_v25(pieces, lits, plan.totals, 65536, dispatch=4,
                               device="cpu") == S.decode_blocks_v25(
        pieces, lits, plan.totals, 65536, dispatch=4, device=card)


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("mode", ["full", "nopt", "statwin", "nomm",
                                  "mmonly"])
def test_quad_ablations_equal_plain_version_on_card(card, mode, garbage):
    from zxc_tpu_torch.ops import probes as P
    for seed, (B, NT, MAXQ, RLP) in enumerate(((3, 8, 24, 256),
                                               (16, 16, 96, 640))):
        args = CE.group_from_numpy(*quad_plan(seed, B, NT, MAXQ, RLP, 12,
                                              garbage), device=card)
        before = P.v12_ablate2.launches
        out = P.v12_ablate2(*args, mode)
        torch.cuda.synchronize()
        assert P.v12_ablate2.launches == before + 1
        assert torch.equal(out, P.v12_ablate2_reference(*args, mode))
        for shifted, paired in P.V13_BISECT_MODES:
            assert torch.equal(P.v13_bisect(*args, shifted, paired),
                               P.v13_bisect_reference(*args, shifted, paired))


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("name,mode", [
    ("v10_probe", m) for m in ("full", "norotate", "nobcast", "noonehot",
                               "nomatmul")] + [
    ("v12_ablate", m) for m in ("nomatmul", "norotate", "nomask", "floor")])
def test_lane_probes_equal_plain_version_on_card(card, name, mode, garbage):
    from zxc_tpu_torch.ops import probes as P
    fn = P.KERNELS[name]
    for seed, (B, block) in enumerate(((1, 4096), (3, 8192), (16, 65536))):
        ts, _, pctrl, lit, _ = (
            torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
            for a in lane_plan(seed, B, block, 10, garbage, RL=256))
        before = fn.launches
        out = fn(ts, pctrl, lit, mode)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(out, P.lane_probe_reference(name, ts, pctrl, lit,
                                                       mode))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_gathers_equal_plain_version_on_card(card, dtype):
    from zxc_tpu_torch.ops import probes as P
    rng = np.random.default_rng(4)
    for M, N, NI in ((8, 8192, 8192), (3, 1000, 4096), (64, 65536, 65536)):
        x = torch.from_numpy(rng.integers(0, 256, (M, N))).to(dtype).to(card)
        # some indices outside the row: they read 0
        idx = torch.from_numpy(rng.integers(-5, N + 5, (M, NI)).astype(
            np.int32)).to(card)
        before = (P.gather_axis1.launches, P.gather_grid.launches)
        got = P.gather_axis1(x, idx)
        grid = P.gather_grid(x, idx, 1024)
        torch.cuda.synchronize()
        assert (P.gather_axis1.launches, P.gather_grid.launches) == (
            before[0] + 1, before[1] + 1)
        want = P.gather_axis1_reference(x, idx)
        assert torch.equal(got, want) and torch.equal(grid, want)
    table = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 128)).astype(
        np.int32)).to(card)
    for G in (1, 1024, 3000):
        idx = torch.from_numpy(rng.integers(-3, 4100, G).astype(
            np.int32)).to(card)
        want = P.gather_rows_reference(table, idx)
        for form, fn in P.ROW_ENTRIES.items():
            before = fn.launches
            assert torch.equal(fn(table, idx), want)
            assert fn.launches == before + 1


GRID_CASES = {  # x (M, N), idx columns, dtype, form, K
    "probe": ((8, 1 << 16), 1 << 19, torch.int32, "cluster", 2),
    "m64": ((64, 1 << 16), 1 << 16, torch.int32, "l2", 1),
    "u8": ((8, 1 << 16), 1 << 19, torch.uint8, "cluster", 1),
    "u8_k4": ((2, 600_000), 4_800_000, torch.uint8, "cluster", 4),
    "n1000": ((3, 1000), 8192, torch.int32, "cluster", 1),
    "n1000_u8": ((8, 1000), 8192, torch.uint8, "cluster", 1),
    "x_offset": ((4, 3000), 24576, torch.int32, "cluster", 1),
    "idx_offset": ((8, 1 << 16), 1 << 19, torch.int32, "cluster", 2),
    "u8_ragged": ((4, 5000), 40_004, torch.uint8, "cluster", 1),
    "big": ((2, 1 << 20), 1 << 20, torch.int32, "l2", 1),
    "big_offset": ((2, 1 << 20), 1 << 16, torch.int32, "l2", 1),
    "n0": ((3, 0), 4096, torch.int32, "l2", 1),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_gather_grid_forms_on_card(card, case):
    """The grid gather's cluster form, where the index reads each row
    element 4 times or more (the probe's shape, uint8 rows in clusters of
    1 and 4, N = 1000 with rows off 16-byte alignment, a table and an
    index view 4 bytes into their storage, uint8 columns that are no
    multiple of 16) and its L2 form (64 rows of 256 KiB read once over, a
    row of 4 MiB, also with an index view 4 bytes off alignment, and an
    empty row), with indices outside the row: one launch a call, equal to
    the plain version."""
    from zxc_tpu_torch.ops import probes as P
    (M, N), NI, dtype, form, K = GRID_CASES[case]
    rng = np.random.default_rng(len(case))
    vals = rng.integers(0, 256, M * N + 1)
    x = torch.from_numpy(vals).to(dtype).to(card)
    x = (x[1:] if case == "x_offset" else x[:M * N]).view(M, N)
    ids = rng.integers(-5, N + 5, M * NI + 1)
    ids[::97] = rng.integers(-2**31, 2**31 - 1, len(ids[::97]))
    idx = torch.from_numpy(ids.astype(np.int32)).to(card)
    idx = (idx[1:] if case.endswith("idx_offset") or case == "big_offset"
           else idx[:M * NI]).view(M, NI)
    assert x.is_contiguous() and idx.is_contiguous()
    if case == "x_offset":
        assert x.data_ptr() % 16 == 4
    if case in ("idx_offset", "big_offset"):
        assert idx.data_ptr() % 16 == 4
    plan = P.grid_plan(M, N, NI, x.element_size(), idx.data_ptr() % 16 == 0,
                       torch.cuda.get_device_properties(card)
                       .multi_processor_count)
    assert (plan.form, plan.K) == (form, K)
    assert plan.vec == (case in ("big", "n0", "m64"))
    tile = NI // 4 if NI % 4 == 0 else NI
    before = P.gather_grid.launches
    got = P.gather_grid(x, idx, tile)
    torch.cuda.synchronize()
    assert P.gather_grid.launches == before + 1
    assert torch.equal(got, P.gather_axis1_reference(x, idx))


def test_gather_grid_refuses_a_bad_geometry_on_card(card):
    from zxc_tpu_torch.ops import probes as P
    x = torch.zeros((8, 65536), dtype=torch.int32, device=card)
    idx = torch.zeros((8, 1 << 19), dtype=torch.int32, device=card)
    out = torch.empty_like(idx)
    plan = P.grid_plan(8, 65536, 1 << 19, 4)
    assert plan.form == "cluster"
    P._launch_grid(x, idx, out, plan)
    l2 = P.l2_plan(8, 65536, 1 << 19, 4, True, 256, 1)
    assert (l2.clusters, l2.cols) == (128, 4096)
    P._launch_grid(x, idx, out, l2)
    for bad in (plan._replace(K=3), plan._replace(smem=plan.smem + 16),
                plan._replace(slice=plan.slice - 4, smem=plan.smem - 16),
                plan._replace(vec=True), plan._replace(clusters=0),
                plan._replace(cols=plan.cols - 1), l2._replace(cols=2048),
                l2._replace(clusters=127), l2._replace(K=2),
                l2._replace(smem=16), l2._replace(threads=96),
                plan._replace(threads=256)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            P._launch_grid(x, idx, out, bad)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


AXIS1_CASES = {  # x (M, N), idx columns, dtype, index view off 16 B, form
    "probe_8x8K": ((8, 1 << 13), 1 << 13, torch.int32, False, "l2"),
    "probe_8x64K": ((8, 1 << 16), 1 << 16, torch.int32, False, "l2"),
    "probe_8x512K": ((8, 1 << 19), 1 << 19, torch.int32, False, "l2"),
    "probe_64x64K": ((64, 1 << 16), 1 << 16, torch.int32, False, "l2"),
    "probe_256x8K": ((256, 1 << 13), 1 << 13, torch.int32, False, "l2"),
    "probe_8x64K_u8": ((8, 1 << 16), 1 << 16, torch.uint8, False, "l2"),
    "cluster_k1": ((3, 500), 4099, torch.int32, True, "cluster"),
    "cluster_k4_u8": ((2, 600_000), 4_800_005, torch.uint8, True,
                      "cluster"),
    "l2_offset": ((2, 1 << 20), 4100, torch.int32, True, "l2"),
    "l2_u8_offset": ((2, 2_000_000), 4104, torch.uint8, True, "l2"),
    "l2_ragged": ((3, 1 << 19), (1 << 19) + 2, torch.int32, False, "l2"),
    "n0": ((3, 0), 100, torch.int32, True, "l2"),
}


@pytest.mark.parametrize("case", list(AXIS1_CASES))
def test_gather_axis1_forms_on_card(card, case):
    """gather_axis1 on the grid gather's kernels at each of the probe's six
    shapes (the L2 form) and at edge shapes of each form (index views 4
    bytes off 16-byte alignment, columns no multiple of 4 or 16, uint8
    rows in clusters of 4 read 8 times over, an empty row), indices
    outside the row and at +-2^31:
    its plan's form, one launch of its own a call and none counted in
    gather_grid, equal to the plain version."""
    from zxc_tpu_torch.ops import probes as P
    (M, N), NI, dtype, offset, form = AXIS1_CASES[case]
    rng = np.random.default_rng(len(case) + NI)
    x = torch.from_numpy(rng.integers(0, 256, (M, N))).to(dtype).to(card)
    ids = rng.integers(-5, N + 5, M * NI + 1)
    ids[::89] = rng.integers(-2**31, 2**31 - 1, len(ids[::89]))
    ids[1] = -2**31
    ids[2] = 2**31 - 1
    idx = torch.from_numpy(ids.astype(np.int32)).to(card)
    idx = (idx[1:] if offset else idx[:M * NI]).view(M, NI)
    assert idx.is_contiguous() and (idx.data_ptr() % 16 == 4) == offset
    plan = P.gather_grid_plan(x, idx, idx)
    assert plan.form == form
    assert plan.vec == (form == "l2" and not offset
                        and NI % (16 // x.element_size()) == 0)
    before = (P.gather_axis1.launches, P.gather_grid.launches)
    got = P.gather_axis1(x, idx)
    torch.cuda.synchronize()
    assert (P.gather_axis1.launches, P.gather_grid.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, P.gather_axis1_reference(x, idx))


@pytest.mark.parametrize("C", [127, 129, 256])
@pytest.mark.parametrize("G", [1, 1023, 3000])
def test_dma_b_warp_a_row_on_card(card, G, C):
    """dma_b, a warp a row: rows of 127 and 129 words (4-byte copies) and
    of 256 (16-byte copies, two a lane), G not a multiple of the warps a
    CTA, indices outside the table and at +-2^31; one launch a call."""
    from zxc_tpu_torch.ops import probes as P
    rng = np.random.default_rng(G + C)
    table = torch.from_numpy(rng.integers(-2**31, 2**31, (500, C)).astype(
        np.int32)).to(card)
    ids = rng.integers(-5, 505, G)
    ids[::7] = rng.integers(-2**31, 2**31 - 1, len(ids[::7]))
    idx = torch.from_numpy(ids.astype(np.int32)).to(card)
    assert P.row_plan(G, C, "b").bulk == (C % 4 == 0)
    before = P.dma_b.launches
    got = P.dma_b(table, idx)
    torch.cuda.synchronize()
    assert P.dma_b.launches == before + 1
    assert torch.equal(got, P.gather_rows_reference(table, idx))


def test_dma_b_table_off_16_bytes_on_card(card):
    """dma_b on a table view 4 bytes into its storage: the 4-byte copies,
    equal to the plain version."""
    from zxc_tpu_torch.ops import probes as P
    rng = np.random.default_rng(3)
    vals = rng.integers(-2**31, 2**31, 4096 * 128 + 1).astype(np.int32)
    table = torch.from_numpy(vals).to(card)[1:].view(4096, 128)
    assert table.is_contiguous() and table.data_ptr() % 16 == 4
    idx = torch.from_numpy(rng.integers(-3, 4100, 1024).astype(
        np.int32)).to(card)
    before = P.dma_b.launches
    got = P.dma_b(table, idx)
    torch.cuda.synchronize()
    assert P.dma_b.launches == before + 1
    assert torch.equal(got, P.gather_rows_reference(table, idx))


def _row_case(case: str, card):
    """(table, idx) of one row-gather edge case; indices partly outside
    the table."""
    rng = np.random.default_rng(len(case))
    R, C, G = {"c3": (500, 3, 1024), "c12000": (300, 12000, 200),
               "offset": (4096, 128, 1024), "r0": (0, 128, 64),
               "outside": (4096, 128, 1024)}[case]
    lo, hi = (-5, R + 5) if case != "outside" else (-2**31, 2**31)
    idx = torch.from_numpy(rng.integers(lo, hi, G).astype(np.int32)).to(card)
    vals = rng.integers(-2**31, 2**31, R * C + 1).astype(np.int32)
    if case == "offset":     # a view 4 bytes into its storage
        table = torch.from_numpy(vals).to(card)[1:].view(R, C)
        assert table.is_contiguous() and table.data_ptr() % 16 == 4
    else:
        table = torch.from_numpy(vals[:R * C].reshape(R, C)).to(card)
    return table, idx


@pytest.mark.parametrize("case", ["c3", "c12000", "offset", "r0",
                                  "outside"])
def test_row_gather_edges_on_card(card, case):
    """Forms a, b and c on unaligned 12-byte rows, rows longer than one
    stage, a table 4 bytes into its storage, an empty table and indices
    spread over int32: equal to the plain version, one launch a call."""
    from zxc_tpu_torch.ops import probes as P
    table, idx = _row_case(case, card)
    want = P.gather_rows_reference(table, idx)
    C = table.shape[1]
    bulk = P.row_plan(len(idx), C, "a", table.data_ptr() % 16 == 0).bulk
    assert bulk == (case in ("c12000", "outside", "r0"))
    if case == "c12000":
        assert 4 * C > P.STAGE_BYTES     # rows longer than one stage
    for form, fn in P.ROW_ENTRIES.items():
        before = fn.launches
        got = fn(table, idx)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, want), form


def test_row_gather_reused_output_block_on_card(card):
    """Two calls in a row: the second gets the first's output block from
    the caching allocator, and its rows of 0 and its rows from the table
    must both be its own."""
    from zxc_tpu_torch.ops import probes as P
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.integers(1, 2**31, (4096, 128)).astype(
        np.int32)).to(card)
    first = torch.from_numpy(rng.integers(0, 4096, 1024).astype(
        np.int32)).to(card)
    second = torch.from_numpy(rng.integers(-600, 4096, 1024).astype(
        np.int32)).to(card)
    want = P.gather_rows_reference(table, second)
    for form, fn in P.ROW_ENTRIES.items():
        out = fn(table, first)
        ptr = out.data_ptr()
        del out
        before = fn.launches
        got = fn(table, second)
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr, "the allocator did not reuse the block"
        assert fn.launches == before + 1
        assert torch.equal(got, want), form


def test_row_gather_refuses_a_bad_geometry_on_card(card):
    from zxc_tpu_torch.ops import probes as P
    table = torch.zeros((64, 128), dtype=torch.int32, device=card)
    idx = torch.arange(64, dtype=torch.int32, device=card)
    out = torch.empty((64, 128), dtype=torch.int32, device=card)
    for form in "abc":
        plan = P.row_plan(64, 128, form)
        P._launch_rows(table, idx, out, form, plan)
        for bad in (dict(grid=plan.grid + 1), dict(smem=plan.smem + 16),
                    dict(stages=9), dict(piece=129)):
            with pytest.raises(RuntimeError, match="cudaError 1"):
                P._launch_rows(table, idx, out, form, plan._replace(**bad))
    # form b: 1-32 warps a CTA, no stage, 16-byte copies on aligned rows
    plan = P.row_plan(64, 128, "b")
    for bad in (dict(rows_per_cta=33, grid=2), dict(rows_per_cta=0),
                dict(stages=1), dict(piece=64)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            P._launch_rows(table, idx, out, "b", plan._replace(**bad))
    t127 = torch.zeros((64, 127), dtype=torch.int32, device=card)
    o127 = torch.empty((64, 127), dtype=torch.int32, device=card)
    plan = P.row_plan(64, 127, "b")
    assert not plan.bulk
    P._launch_rows(t127, idx, o127, "b", plan)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        P._launch_rows(t127, idx, o127, "b", plan._replace(bulk=True))
    torch.cuda.synchronize()
    assert torch.equal(out, table) and torch.equal(o127, t127)


def test_sharded_decode_world1_nccl_on_card(card):
    """decode_plan_sharded and decode_plan_dp_sp over an NCCL group of one
    rank on the card, equal to the host decode; a tampered plan raises
    the expansion's error after the gather."""
    import torch.distributed as dist
    from zxc_tpu_torch import parallel
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.parallel import launch
    rng = np.random.default_rng(23)
    seg = rng.integers(0, 256, 977, dtype=np.uint8).tobytes()
    data = (seg * 300 + rng.integers(0, 32, 90_000, dtype=np.uint8)
            .tobytes())[:9 * 16384 - 5]
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:"
                                        f"{launch.free_port()}")
    try:
        mesh = parallel.make_mesh()
        assert mesh.device_type == "cuda"
        plan = Z.ops.plan_frame(arc)
        want = frame.decompress(arc)
        assert want == data
        assert parallel.decode_plan_sharded(plan, mesh) == want
        assert parallel.decode_plan_sharded(plan, mesh, batch=4) == want
        sp = parallel.make_mesh(axes=("dp", "sp"), shape=(1, 1))
        assert parallel.decode_plan_dp_sp(plan, sp) == want
        plan.off[2][0] = 60_000
        with pytest.raises(Z.ZxcError, match="offset out of window"):
            parallel.decode_plan_sharded(plan, mesh)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_on_card(card):
    """One NCCL rank a card; more ranks than cards are refused."""
    from zxc_tpu_torch import entry
    entry.dryrun_multichip(1)
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks need {n} cards"):
        entry.dryrun_multichip(n)
