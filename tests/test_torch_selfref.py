"""v25, the self-referential window chosen per quad, of the PyTorch port
against the JAX package: ``serial.lane_ops_blocks_v25`` and
``serial.pack_blocks_v25`` array for array against
``zxc_tpu/ops/pallas_decode.py``, the plain version
``copy_engine.v25_reference`` against ``v25_kernel`` in interpret mode, and
``serial.decode_blocks_v25`` against the plaintext.

Inputs: the pinned corpus (``tools/gen_corpus.py``, the smoke's 32 MiB)
cut to its first 2 blocks of 64 KiB and 4 blocks of 32 KiB, encoded at
level 3 by the port's encoder and resolved with ``self_ref=True`` (their
plans hold KOUT pieces, so their groups have OUT quads); a KOUT-free body
at 32 KiB; and hand-made groups whose OUT sources lie in supertiles
already stored, with disjoint target cells (so no cell passes 255 and the
JAX kernel's bf16 reads of its own output stay exact). Tolerance: exact
equality of every packed array, of the kernel's output bytes (JAX's int32
output reduced mod 256; max abs err 0) and of the decoded bytes.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.ops import batch as PB, copy_engine as CE, serial as S

from zxc_tpu.ops import pallas_decode as PD
from zxc_tpu import runtime as jrt

from test_torch_jax_native import jax_native
from test_torch_serial import _mixed_body

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from gen_corpus import gen_corpus  # noqa: E402

FLAG = CE.OUT_QB_FLAG


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


@functools.lru_cache(maxsize=None)
def _corpus() -> bytes:
    return gen_corpus(32 << 20)


@functools.lru_cache(maxsize=None)
def _plans(name: str, block: int, n_blocks: int):
    """(data, totals, pieces, lits) resolved with self_ref=True: the
    pinned corpus's first blocks, or a body with no KOUT piece."""
    if name == "pinned":
        data = _corpus()[:block * n_blocks]
    else:
        data = _mixed_body(3, block * n_blocks - 77)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=block))
    plan = PB.plan_frame(arc)
    pieces, lits = PB.resolve_serial(plan, self_ref=True)
    return data, list(plan.totals), pieces, lits


CASES = [("pinned", 65536, 2), ("pinned", 32768, 4), ("plain", 32768, 3)]


def jax_v25(args, K: int = 2) -> np.ndarray:
    qs, qbase, pctrl, tq, lit8 = args
    block = (qs.shape[1] - 1) * 128 * 128
    kern = PD.v25_kernel(block, qbase.shape[1], lit8.shape[1], K, True)
    return (np.asarray(kern(*args)) & 255).astype(np.uint8)


@pytest.mark.parametrize("name,block,n_blocks", CASES)
def test_pack_blocks_v25_equals_jax(name, block, n_blocks):
    _, totals, pieces, lits = _plans(name, block, n_blocks)
    kout = sum(int((p[3] == prt.KOUT).sum()) for p in pieces)
    assert (kout > 0) == (name == "pinned")
    got_per = S.lane_ops_blocks_v25(pieces, totals)
    want_per = PD.lane_ops_blocks_v25(pieces, totals)
    for g, w in zip(got_per, want_per):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    got = S.pack_blocks_v25(pieces, lits, totals, block)
    want = PD.pack_blocks_v25(pieces, lits, totals, block)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (got[1] >= FLAG).any() == (name == "pinned")     # OUT quads
    # explicit MAXQ and RL, as a caller buckets them
    MAXQ, RL = got[1].shape[1] + 32, got[4].shape[1] + 100
    for x, y in zip(S.pack_blocks_v25(pieces, lits, totals, block, MAXQ=MAXQ,
                                      RL=RL),
                    PD.pack_blocks_v25(pieces, lits, totals, block,
                                       MAXQ=MAXQ, RL=RL)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_self_ref_plans_equal_the_jax_resolver():
    data, totals, pieces, lits = _plans("pinned", 65536, 2)
    plan = PB.plan_frame(Z.compress(data, Z.EncodeOpts(level=3,
                                                       block_size=65536)))
    for i, (p, lit) in enumerate(zip(pieces, lits)):
        r = jrt.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                               plan.lit[i], None, device_pure=True,
                               max_frag=1, self_ref=True)
        for x, y in zip(p + (lit,), r):
            assert np.array_equal(x, y)
    assert prt.KOUT == jrt.KOUT


@pytest.mark.parametrize("name,block,n_blocks", CASES)
def test_v25_reference_equals_jax_on_packed_arrays(name, block, n_blocks):
    """Every byte of the group's supertiles, padding past totals
    included; and the bytes equal the plaintext."""
    data, totals, pieces, lits = _plans(name, block, n_blocks)
    args = S.pack_blocks_v25(pieces, lits, totals, block)
    got = CE.v25(*CE.group_from_numpy(*args)).numpy()
    want = jax_v25(args)
    assert got.shape == want.shape
    assert int(np.abs(got.astype(np.int32) - want).max()) == 0
    out = b"".join(got[j].reshape(-1)[:t].tobytes()
                   for j, t in enumerate(totals))
    assert out == data


@pytest.mark.parametrize("dispatch", [2, 3])
@pytest.mark.parametrize("name,block,n_blocks", CASES)
def test_decode_blocks_v25_equals_plaintext(name, block, n_blocks, dispatch):
    """Dispatch groups padded as the tool pads them (the last group with
    copies of the last block whose totals are 0)."""
    data, totals, pieces, lits = _plans(name, block, n_blocks)
    ph = {}
    got = S.decode_blocks_v25(pieces, lits, totals, block, device="cpu",
                              dispatch=dispatch, _phases=ph)
    assert b"".join(got) == data
    assert [len(g) for g in got] == totals
    assert set(ph) == {"pack", "device"}


def _hand_made(seed: int, B: int = 2, NST: int = 3, MAXQ: int = 24,
               RLP: int = 256, K: int = 2):
    """A v25 group made with numpy: each supertile's quads (odd counts
    included) are lit quads (16-aligned windows inside lit8) or, past
    supertile 0, OUT quads whose rows all lie in supertiles already
    stored. Slot i of the n-th quad of a supertile targets row i, lanes
    [16n, 16n + 15]: no output cell is written twice. Some slots' rows
    are 128 or past (they add nothing)."""
    rng = np.random.default_rng(seed)
    NG32 = 32 * -(-4 * MAXQ // 128)
    qs = np.zeros((B, NST + 1), np.int32)
    qbase = np.zeros((B, MAXQ), np.int32)
    pctrl = np.full((B, K * NG32, 128), 1 << 7, np.int64)
    tq = np.zeros((B, MAXQ, 128), np.uint8)
    lit8 = rng.integers(0, 256, (B, RLP, 128), dtype=np.uint8)
    for b in range(B):
        q = 0
        for t in range(NST):
            n = int(rng.integers(1, 8))       # at most 8 bands of 16 lanes
            n = min(n, MAXQ - q)
            for band in range(n):
                out_q = t > 0 and rng.random() < 0.5
                if out_q:
                    ob = int(rng.integers(0, t * 128 - 127)) // 16 * 16
                    qbase[b, q] = FLAG + ob
                    span = t * 128 - ob      # rows stored: [ob, ob + span)
                else:
                    qbase[b, q] = 16 * int(rng.integers(0, (RLP - 112) // 16))
                    span = 128
                slot = np.arange(128)
                bat = 4 * q + (slot >> 5)
                rowrel = rng.integers(0, min(span, 128), 128)
                rowrel[rng.random(128) < 0.05] = rng.integers(128, 2048)
                lo = 16 * band + rng.integers(0, 8, 128)
                hi = np.minimum(lo + rng.integers(0, 12, 128), 16 * band + 15)
                w0 = (rng.integers(0, 128, 128) | (lo << 7) | (hi << 14)
                      | (rowrel << 21))
                w0[rng.random(128) < 0.1] = 1 << 7      # the filler
                pctrl[b, 32 * (bat >> 7) + (slot & 31), bat & 127] = w0
                # plane 1: a second roll on part of the same band
                lo1 = 16 * band + rng.integers(0, 16, 128)
                w1 = rng.integers(0, 128, 128) | (lo1 << 7) | (
                    np.minimum(lo1 + 3, 16 * band + 15) << 14)
                w1[rng.random(128) < 0.5] = 1 << 7
                pctrl[b, NG32 + 32 * (bat >> 7) + (slot & 31), bat & 127] = w1
                tq[b, q] = slot
                q += 1
            qs[b, t + 1] = q
    return (qs, qbase, pctrl.astype(np.uint32).view(np.int32), tq, lit8)


@pytest.mark.parametrize("seed", range(3))
def test_v25_reference_hand_made_groups_equal_jax(seed):
    args = _hand_made(seed)
    got = CE.v25(*CE.group_from_numpy(*args)).numpy()
    assert int(np.abs(got.astype(np.int32) - jax_v25(args)).max()) == 0
    assert (args[1] >= FLAG).any() and got.any()
    # the OUT quads matter: reading lit8 instead changes the bytes
    plain = list(args)
    plain[1] = np.where(args[1] >= FLAG, 0, args[1]).astype(np.int32)
    assert not np.array_equal(CE.v19(*CE.group_from_numpy(*plain)).numpy(),
                              got)


def test_v25_reads_zero_where_the_output_is_not_stored():
    """An OUT quad's row in its own or a later supertile, or at NR and
    past, adds nothing in the port (the JAX kernel reads whatever its
    output buffer holds there: INT32_MIN in interpret mode)."""
    MAXQ, RLP = 8, 128
    G32 = 32 * -(-4 * MAXQ // 128)
    qs = np.array([[0, 2, 4]], np.int32)       # quads 0-1, then 2-3
    pctrl = np.full((1, 2 * G32, 128), 1 << 7, np.int32)
    every_lane = 127 << 14
    pctrl[0, 0, 0] = every_lane | (5 << 21)    # q0 slot 0: lit row 5
    pctrl[0, 0, 8] = every_lane                # q2 slot 0: out row 0
    lit8 = np.zeros((1, RLP, 128), np.uint8)
    lit8[0, 5] = 7
    tq = np.zeros((1, MAXQ, 128), np.uint8)
    tq[0, 3, 0] = 1                            # q3 slot 0: tile row 1
    qbase = np.zeros((1, MAXQ), np.int32)
    qbase[0, 2] = FLAG

    def run(row):
        pctrl[0, 0, 12] = every_lane | ((row % 128) << 21)
        qbase[0, 3] = FLAG + row - row % 128
        return CE.v25(*CE.group_from_numpy(qs, qbase, pctrl, tq,
                                           lit8)).numpy()[0]

    for row in (128, 200, 255, 256, 5000):    # not stored yet, or past NR
        out = run(row)
        assert (out[0] == 7).all() and (out[128] == 7).all()
        assert not out[129].any()
    assert (run(0)[129] == 7).all()           # a stored row


def test_decode_blocks_v25_refuses_small_blocks():
    _, totals, pieces, lits = _plans("plain", 32768, 3)
    for block in (4096, 16384, 49152 - 1):
        with pytest.raises(ValueError, match="32768"):
            S.decode_blocks_v25(pieces, lits, totals, block, device="cpu")
    with pytest.raises(AssertionError):
        PD.pack_blocks_v25(pieces, lits, totals, 8192)


def test_decode_blocks_v25_defaults_to_cuda_and_counts_no_cpu_launches():
    _, totals, pieces, lits = _plans("pinned", 32768, 4)
    before = CE.v25.launches
    S.decode_blocks_v25(pieces, lits, totals, 32768, device="cpu")
    assert CE.v25.launches == before
    assert CE.KERNELS[25] is CE.v25 and CE.REFERENCES[25] is CE.v25_reference
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        S.decode_blocks_v25(pieces, lits, totals, 32768)


def test_bytes_moved_counts_out_rows_as_output():
    """A flagged quad's rows are the call's own output: v25's count
    holds only the lit rows that lit quads read."""
    args = _hand_made(0)
    qs, qbase, pctrl, tq, lit8 = args
    v25 = CE.bytes_moved(*args)
    lit_only = list(args)
    lit_only[1] = np.where(qbase >= FLAG, 10 ** 6, qbase).astype(np.int32)
    assert v25 == CE.bytes_moved(*lit_only)
    out = qbase.shape[0] * (qs.shape[1] - 1) * 128 * 128
    assert out < v25 < out + lit8.nbytes + pctrl.nbytes + tq.nbytes + 4096


def test_decompress_names_the_v25_entry():
    data = _mixed_body(3, 40000)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=32768))
    with pytest.raises(NotImplementedError, match="decode_blocks_v25"):
        Z.ops.decompress(arc, device="cpu", use_serial=True, variant=25)
