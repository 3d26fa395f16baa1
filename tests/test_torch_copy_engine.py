"""Copy-engine kernels v19 / v26 of the PyTorch port against the JAX
package's Pallas kernels (interpret mode).

Both packages get the same packed control: the JAX packers
(``pack_blocks_v19`` / ``pack_blocks_v26`` over ``resolve_pieces(
device_pure=True, max_frag=1[, self_ref=True])``, padded as
``decode_blocks_v19`` pads) or hand-built arrays made with numpy from a
seed. The port runs its plain versions on CPU tensors through
``group_from_numpy``. Tolerance: exact byte equality with the JAX int32
output reduced mod 256, and with the plaintext.
"""
import numpy as np
import pytest
import torch

from zxc_tpu import runtime
from zxc_tpu.codec import frame
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.ops.batch import plan_frame
from zxc_tpu.ops import pallas_decode as PD

from zxc_tpu_torch.ops import copy_engine as CE

from test_torch_cuda import random_group, flat_group
from test_torch_jax_native import jax_native



@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _mixed_body(seed: int, size: int) -> bytes:
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 256, 997, dtype=np.uint8).tobytes()
    body = (b"text " * 5000 + seg * 40 + b"\x00" * 20000 + b"ab" * 8000
            + b"".join(bytes(range(k)) * (3000 // k) for k in (3, 7, 13))
            + rng.integers(0, 256, 60000, dtype=np.uint8).tobytes())
    return (body * (size // len(body) + 1))[:size]


def _level(level):
    def make():
        rng = np.random.default_rng(level)
        seg = rng.integers(0, 256, 733, dtype=np.uint8).tobytes()
        data = (seg * 20 + b"\x00" * 9000 + b"ab" * 4000 + seg[:500]
                + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
        data = data * 2
        return data, EncodeOpts(level=level, block_size=16384), None
    return make


def _fills_periods():
    data = (b"\x00" * 30_000 + b"xy" * 8_000
            + b"".join(bytes(range(k)) * (2000 // k) for k in (3, 7, 13))
            + b"\xff" * 5_000)
    return data, EncodeOpts(level=4, block_size=16384), None


def _cross_window():
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    data = base + base[100:3100] + base[:1024] + base[2000:2001] * 2000
    data = data * 4
    return data, EncodeOpts(level=3, block_size=16384), None


def _dictionary():
    d = b"shared dictionary content for the copy engine " * 30
    data = b"shared dictionary content appears here too! " * 900
    return (data, EncodeOpts(level=3, block_size=16384, dict_content=d),
            DecodeOpts(dict_content=d))


def _big_blocks():
    return (_mixed_body(21, 65536 * 3 - 500),
            EncodeOpts(level=3, block_size=65536), None)


def _big_blocks_l7():
    return (_mixed_body(22, 65536 * 2 + 999),
            EncodeOpts(level=7, block_size=65536), None)


CORPORA = {"l1": _level(1), "l3": _level(3), "l5": _level(5),
           "l7": _level(7), "fills_periods": _fills_periods,
           "cross_window": _cross_window, "dict": _dictionary,
           "64k_l3": _big_blocks, "64k_l7": _big_blocks_l7}


def _packed(make, variant: int, K: int = 2):
    """One dispatch group of all the archive's blocks, packed by the JAX
    package's packers and padded as its decode path pads."""
    data, eopts, dopts = make()
    arc = frame.compress(data, eopts)
    plan = plan_frame(arc, dopts)
    pieces, lits = [], []
    for i in range(plan.n_blocks):
        r = runtime.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                                   plan.lit[i], plan.dict_buf,
                                   device_pure=True, max_frag=1,
                                   self_ref=(variant == 26))
        assert r is not None
        pieces.append(r[:4])
        lits.append(r[4])
    totals = list(plan.totals)
    if variant == 26:
        # v26 packs against a pinned RLP (the window is lit rows ++ the
        # block's decoded rows from RLP on), as bench.py pins it
        RLP = -(-(max(-(-len(x) // 128) for x in lits) + 1) // 16) * 16
        raw = PD.pack_blocks_v26(pieces, lits, totals, plan.block_size, RLP,
                                 quad_align=2, K=K)
    else:
        raw = PD.pack_blocks_v19(pieces, lits, totals, plan.block_size, K=K)
        RLP = -(-raw[4].shape[1] // 128) * 128
    MAXQ = -(-raw[1].shape[1] // 32) * 32
    args = PD.pad_v19_set(raw, MAXQ, RLP, K)
    return data, plan, args, MAXQ, RLP


def _jax_kernel(variant: int, block: int, MAXQ: int, RLP: int, K: int):
    fn = PD.v26_kernel if variant == 26 else PD.v19_kernel
    return fn(block, MAXQ, RLP, K, True)


@pytest.mark.parametrize("variant", [19, 26])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_kernel_parity_with_jax(corpus, variant):
    data, plan, args, MAXQ, RLP = _packed(CORPORA[corpus], variant)
    jout = np.asarray(_jax_kernel(variant, plan.block_size, MAXQ, RLP, 2)(
        *args))
    port = CE.KERNELS[variant](*CE.group_from_numpy(*args), K=2)
    assert port.dtype == torch.uint8
    assert port.shape == jout.shape
    assert np.array_equal(port.numpy(), jout.astype(np.uint8))
    flat = port.numpy().reshape(plan.n_blocks, -1)
    got = b"".join(flat[j, :plan.totals[j]].tobytes()
                   for j in range(plan.n_blocks))
    assert got == data


@pytest.mark.parametrize("variant", [19, 26])
def test_kernel_parity_k3(variant):
    data, plan, args, MAXQ, RLP = _packed(_big_blocks, variant, K=3)
    jout = np.asarray(_jax_kernel(variant, plan.block_size, MAXQ, RLP, 3)(
        *args))
    port = CE.KERNELS[variant](*CE.group_from_numpy(*args), K=3)
    assert np.array_equal(port.numpy(), jout.astype(np.uint8))


# ---------------------------------------------------------------------------
# hand-built control: pins the contract's corner cases
# ---------------------------------------------------------------------------

def _loop_oracle(qs, qbase, pctrl, tq, lit8, K: int, self_ref: bool,
                 rows: int = 128):
    """Slot-by-slot, lane-by-lane statement of the kernels' function
    (``rows``: tile rows, 32 for v13)."""
    B, NST1 = qs.shape
    NST = NST1 - 1
    MAXQ = qbase.shape[1]
    G32 = pctrl.shape[1] // K
    RLP = lit8.shape[1]
    NR = NST * rows
    out = np.zeros((B, NR, 128), np.int64)
    for b in range(B):
        for t in range(NST):
            win = (np.concatenate([lit8[b], (out[b] & 255)]) if self_ref
                   else lit8[b]).astype(np.int64)
            tile = np.zeros((rows, 128), np.int64)
            q0 = int(qs[b, t])
            npairs = max(0, (int(qs[b, t + 1]) - q0) >> 1)
            for q in range(q0, q0 + 2 * npairs):
                if not 0 <= q < MAXQ:
                    continue
                for i in range(128):
                    bat = 4 * q + (i >> 5)
                    r, c = 32 * (bat >> 7) + (i & 31), bat & 127
                    w = [int(pctrl[b, j * G32 + r, c]) & 0xFFFFFFFF
                         for j in range(K)]
                    rowrel = w[0] >> 21
                    src = int(qbase[b, q]) + rowrel
                    tgt = int(tq[b, q, i])
                    if (rowrel >= 128 or not 0 <= tgt < rows
                            or not 0 <= src < len(win)):
                        continue
                    for lane in range(128):
                        roll = None
                        for j in range(K):
                            if ((w[j] >> 7) & 127) <= lane <= ((w[j] >> 14)
                                                               & 127):
                                roll = w[j] & 127
                        if roll is not None:
                            tile[tgt, lane] += win[src, (lane + roll) & 127]
            out[b, t * rows:(t + 1) * rows] = tile
    return out


def _word(roll, s, e_incl, rowrel=0):
    return np.int32(np.uint32(roll | (s << 7) | (e_incl << 14)
                              | (rowrel << 21)).view(np.int32))


def test_hand_built_v19_matches_jax_and_oracle():
    K = 2
    args = random_group(7, B=2, NST=2, MAXQ=12, RLP=256, K=K,
                         self_ref=False)
    jout = np.asarray(PD.v19_kernel(2 * 16384, 12, 256, K, True)(*args))
    port = CE.v19(*CE.group_from_numpy(*args), K=K).numpy()
    assert jout.max() > 255          # the adds really collide and wrap
    assert np.array_equal(port, jout.astype(np.uint8))
    assert np.array_equal(port, (_loop_oracle(*args, K, False) & 255)
                          .astype(np.uint8))


def test_hand_built_v26_matches_jax_and_oracle():
    K = 2
    # small literal values keep every tile sum <= 255, where the JAX
    # kernel's bf16 window rows are exact
    args = random_group(8, B=2, NST=2, MAXQ=8, RLP=128, K=K, self_ref=True,
                         lit_max=3)
    jout = np.asarray(PD.v26_kernel(2 * 16384, 8, 128, K, True)(*args))
    assert jout.max() <= 255
    port = CE.v26(*CE.group_from_numpy(*args), K=K).numpy()
    assert np.array_equal(port, jout.astype(np.uint8))
    assert np.array_equal(port, _loop_oracle(*args, K, True)
                          .astype(np.uint8))
    # the second supertile really read decoded rows of the first
    assert (np.asarray(args[1]) >= 128).any()


@pytest.mark.parametrize("variant", [19, 26])
def test_garbage_control_matches_oracle(variant):
    """Out-of-range quads, windows, source and target rows add nothing
    (the JAX kernels clamp such windows instead, so only the oracle can
    judge here)."""
    args = random_group(11 + variant, B=2, NST=2, MAXQ=6, RLP=128, K=2,
                        self_ref=(variant == 26), garbage=True)
    port = CE.KERNELS[variant](*CE.group_from_numpy(*args)).numpy()
    want = (_loop_oracle(*args, 2, variant == 26) & 255).astype(np.uint8)
    assert np.array_equal(port, want)
    assert port.any()


def _one_slot_group(w0, w1, tgt=5):
    """B=1, NST=1, MAXQ=2: quad 0 slot 0 carries (w0, w1); every other
    slot is the filler."""
    K, MAXQ, RLP, NG32 = 2, 2, 128, 32
    qs = np.array([[0, 2]], np.int32)
    qbase = np.zeros((1, MAXQ), np.int32)
    pctrl = np.full((1, K * NG32, 128), 1 << 7, np.int32)
    pctrl[0, 0, 0] = w0
    pctrl[0, NG32, 0] = w1
    tq = np.zeros((1, MAXQ, 128), np.uint8)
    tq[0, 0, 0] = tgt
    lit8 = (np.arange(RLP * 128).reshape(1, RLP, 128) % 251).astype(np.uint8)
    return qs, qbase, pctrl, tq, lit8


def test_overlapping_subops_highest_plane_wins():
    # plane 0: lanes 0..100 roll 5 from row 3; plane 1: lanes 50..127 roll 9
    args = _one_slot_group(_word(5, 0, 100, rowrel=3), _word(9, 50, 127))
    out = CE.v19(*CE.group_from_numpy(*args)).numpy()
    jout = np.asarray(PD.v19_kernel(16384, 2, 128, 2, True)(*args))
    assert np.array_equal(out, jout.astype(np.uint8))
    lanes = np.arange(128)
    roll = np.where(lanes >= 50, 9, 5)
    want = args[4][0, 3, (lanes + roll) & 127]
    assert np.array_equal(out[0, 5], want)
    assert not out[0, :5].any() and not out[0, 6:].any()


def test_odd_quad_count_skips_trailing_quad():
    # quads 0..2 in the supertile: the pair-unrolled loop runs 0 and 1
    # only, so quad 2 (which would write row 9) contributes nothing
    K, MAXQ, RLP, NG32 = 2, 4, 128, 32
    qs = np.array([[0, 3]], np.int32)
    qbase = np.zeros((1, MAXQ), np.int32)
    pctrl = np.full((1, K * NG32, 128), 1 << 7, np.int32)
    tq = np.zeros((1, MAXQ, 128), np.uint8)
    for q, row in ((0, 7), (1, 8), (2, 9)):
        bat = 4 * q
        pctrl[0, 32 * (bat >> 7), bat & 127] = _word(0, 0, 127, rowrel=q)
        tq[0, q, 0] = row
    lit8 = np.full((1, RLP, 128), 1, np.uint8)
    args = (qs, qbase, pctrl, tq, lit8)
    out = CE.v19(*CE.group_from_numpy(*args)).numpy()
    jout = np.asarray(PD.v19_kernel(16384, MAXQ, RLP, K, True)(*args))
    assert np.array_equal(out, jout.astype(np.uint8))
    assert out[0, 7].all() and out[0, 8].all() and not out[0, 9].any()


def test_empty_and_filler_slots_write_nothing():
    # filler (s=1 > e-1=0) in both planes, an explicit empty sub-op, and
    # out-of-range rows: nothing lands anywhere
    for w0, w1, tgt in ((1 << 7, 1 << 7, 5),
                        (_word(3, 1, 0, rowrel=2), 1 << 7, 5),
                        (_word(0, 0, 127, rowrel=200), 1 << 7, 5),
                        (_word(0, 0, 127, rowrel=1), 1 << 7, 200)):
        args = _one_slot_group(np.int32(w0), np.int32(w1), tgt=tgt)
        for variant in (19, 26):
            out = CE.KERNELS[variant](*CE.group_from_numpy(*args)).numpy()
            fn = PD.v26_kernel if variant == 26 else PD.v19_kernel
            jout = np.asarray(fn(16384, 2, 128, 2, True)(*args))
            assert not out.any()
            assert np.array_equal(out, jout.astype(np.uint8))


def test_wrapper_rejects_bad_inputs():
    args = CE.group_from_numpy(*_one_slot_group(_word(0, 0, 127), 1 << 7))
    qs, qbase, pctrl, tq, lit8 = args
    with pytest.raises(TypeError):
        CE.v19(qs, qbase, pctrl, tq.to(torch.int32), lit8)
    with pytest.raises(ValueError):
        CE.v19(qs, qbase, pctrl[:, :40], tq, lit8)
    with pytest.raises(ValueError):
        CE.v26(*(t.to("meta") for t in args))
    with pytest.raises(TypeError):
        CE.group_from_numpy(np.zeros((1, 2), np.int64), *[np.asarray(a)
                                                          for a in args[1:]])


def _bytes_oracle(qs, qbase, pctrl, tq, lit8, K: int, rows: int = 128,
                  loff=None, RLP=None) -> int:
    """Slot-by-slot count of what ``bytes_moved`` states; v27 (``loff``):
    rows of the flat buffer ``lit8``; v13: ``rows=32``."""
    B, NST1 = qs.shape
    MAXQ, G32 = qbase.shape[1], pctrl.shape[1] // K
    if loff is None:
        RLP = lit8.shape[1]
    quads, read = set(), set()
    for b in range(B):
        for t in range(NST1 - 1):
            q0 = int(qs[b, t])
            for q in range(q0, q0 + 2 * max(0, (int(qs[b, t + 1]) - q0) >> 1)):
                if 0 <= q < MAXQ:
                    quads.add((b, q))
    for b, q in quads:
        for i in range(128):
            bat = 4 * q + (i >> 5)
            w = [int(pctrl[b, j * G32 + 32 * (bat >> 7) + (i & 31), bat & 127])
                 & 0xFFFFFFFF for j in range(K)]
            src = int(qbase[b, q]) + (w[0] >> 21)
            if not (any(((x >> 7) & 127) <= ((x >> 14) & 127) for x in w)
                    and (w[0] >> 21) < 128 and 0 <= tq[b, q, i] < rows
                    and 0 <= src < RLP):
                continue
            if loff is None:
                read.add((b, src))
            elif loff[b] >= 0 and 0 <= loff[b] + src < len(lit8):
                read.add(int(loff[b]) + src)
    return (qs.nbytes + len(quads) * (4 + 128 * tq.itemsize + K * 512)
            + len(read) * 128 + (0 if loff is None else 4 * B)
            + B * (NST1 - 1) * rows * 128)


@pytest.mark.parametrize("case", ["valid19", "valid26", "garbage", "64k_l3",
                                  "flat27", "flat27_garbage", "v13",
                                  "v13_garbage"])
def test_bytes_moved_counts_live_control_and_rows(case):
    if case == "64k_l3":
        args = _packed(_big_blocks, 26)[2]
    elif case.startswith("v13"):
        args = random_group(6, B=3, NST=3, MAXQ=12, RLP=256, K=1,
                            self_ref=False, garbage=case.endswith("garbage"),
                            rows=32)
        assert CE.bytes_moved(*CE.group_from_numpy(*args), K=1, rows=32) \
            == _bytes_oracle(*args, 1, rows=32)
        return
    elif case.startswith("flat27"):
        garbage = case.endswith("garbage")
        (qs, qbase, loff, pctrl, tq, flat), RLP = flat_group(
            5, random_group(5, B=3, NST=2, MAXQ=24, RLP=128, K=2,
                            self_ref=True, garbage=garbage), garbage)
        assert CE.bytes_moved(qs, qbase, pctrl, tq, flat, K=2, loff=loff,
                              RLP=RLP) == _bytes_oracle(
            qs, qbase, pctrl, tq, flat, 2, loff=loff, RLP=RLP)
        return
    else:
        args = random_group(5, B=3, NST=2, MAXQ=24, RLP=256, K=2,
                            self_ref=(case == "valid26"),
                            garbage=(case == "garbage"))
    assert CE.bytes_moved(*CE.group_from_numpy(*args), K=2) == \
        _bytes_oracle(*args, 2)


def test_bytes_moved_ignores_padding():
    args = _packed(_big_blocks, 19)[2]
    MAXQ, RLP = args[1].shape[1], args[4].shape[1]
    wider = PD.pad_v19_set(args, MAXQ + 64, RLP + 256, 2)
    assert CE.bytes_moved(*wider) == CE.bytes_moved(*args)


def test_plain_versions_do_not_count_launches():
    before = (CE.v19.launches, CE.v26.launches)
    args = CE.group_from_numpy(*_one_slot_group(_word(0, 0, 127), 1 << 7))
    CE.v19(*args)
    CE.v26(*args)
    assert (CE.v19.launches, CE.v26.launches) == before
