"""Card tests of the PyTorch port: each CUDA kernel (v19, v26, v27, v13,
lcp, parse_walk, the attic's piece-serial kernel) against its plain
PyTorch version on the card, on valid and on garbage control, and the
cold, hint, serial and attic decodes, the default expansion route (no
hand-written kernel), ``Seekable.decompress_range_device`` and the device
encode against the CPU path. They need an NVIDIA card with
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


def _all_launches():
    from zxc_tpu_torch.ops import attic as A, encode_kernels as EK
    return (sum(k.launches for k in CE.KERNELS.values())
            + sum(k.launches for k in EK.KERNELS.values())
            + A.piece_serial.launches)


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
