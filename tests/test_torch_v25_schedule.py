"""The schedule of the port's v25 kernel, held on the CPU.

On the card v25 runs v26's (supertile, block) grid: pass 1 adds the slots
of the quads whose ``qbase`` lies below RLP (lit rows ``qbase + rowrel``,
read only below RLP) at once; pass 2, after the block's earlier
supertiles are stored, adds the slots of the flagged quads (``qbase >=
OUT_QB_FLAG``) whose output row ``qbase - OUT_QB_FLAG + rowrel`` lies
below t*128, a stored supertile (their base put in v26's window rows,
``qbase - OUT_QB_FLAG + RLP``). A numpy model of that order (pass 1 over
every supertile, then pass 2 in supertile order) must equal the port's
plain version ``v25_reference``, which walks the supertiles in order, and
the JAX kernel ``v25_kernel`` in interpret mode where the JAX kernel's
window is defined. Plans: ``serial.pack_blocks_v25`` groups of the pinned
corpus; ``test_torch_cuda.plan_group`` in v25's form (collision-free, so
the JAX kernel's bf16 window is exact): the longest chain of supertiles,
a flagged quad reading rows t*128 - 1 (its value) and t*128 (0), and
mixed windows with rows out of range; an unflagged window straddling RLP;
and garbage control (``v25_group(garbage=True)``). The JAX kernel cuts
its 128-row window with a dynamic slice, which interpret mode clamps into
the buffer, and reads what its output holds past the stored rows (whose
bytes mod 256 stay exact only on collision-free plans), so the straddling
window and garbage control are judged against the plain version alone.
Tolerance: exact bytes.
"""
import functools
import os
import sys

import numpy as np
import pytest

import zxc_tpu_torch as Z
from zxc_tpu.ops import pallas_decode as PD
from zxc_tpu_torch.ops import batch as PB, copy_engine as CE, serial as S

from test_torch_cuda import as_v25, plan_group, v25_group
from test_torch_jax_native import jax_native
from test_torch_self_ref_schedule import _slots

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from gen_corpus import gen_corpus  # noqa: E402

FLAG = CE.OUT_QB_FLAG


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def v25_model(qs, qbase, pctrl, tq, lit8, K: int) -> np.ndarray:
    """The kernel's order: pass 1 (unflagged quads, lit rows 0 <= src <
    RLP) over every supertile first, then pass 2 (flagged quads, output
    row r = src - OUT_QB_FLAG read if r < t*128) and the store, supertile
    by supertile. Returns (B, NST*128, 128) uint8."""
    B, NST = qs.shape[0], qs.shape[1] - 1
    RLP = lit8.shape[1]
    acc = np.zeros((B, NST, 128, 128), np.int64)
    out = np.zeros((B, NST * 128, 128), np.uint8)
    slots = {(b, t): list(_slots(qs, qbase, pctrl, tq, K, b, t))
             for b in range(B) for t in range(NST)}
    for (b, t), ss in slots.items():                       # pass 1
        for src, tgt, idx, cov in ss:
            if src < FLAG and 0 <= src < RLP:
                acc[b, t, tgt, cov] += lit8[b, src, idx[cov]]
    for t in range(NST):                                    # pass 2
        for b in range(B):
            for src, tgt, idx, cov in slots[(b, t)]:
                if src >= FLAG and src - FLAG < t * 128:
                    acc[b, t, tgt, cov] += out[b, src - FLAG, idx[cov]]
        out[:, t * 128:(t + 1) * 128] = acc[:, t] & 255
    return out


def jax_v25(group, K: int) -> np.ndarray:
    qs, qbase, pctrl, tq, lit8 = group
    kern = PD.v25_kernel((qs.shape[1] - 1) * 128 * 128, qbase.shape[1],
                         lit8.shape[1], K, True)
    return (np.asarray(kern(*group)) & 255).astype(np.uint8)


def _check(group, K: int, jax: bool) -> np.ndarray:
    model = v25_model(*group, K)
    port = CE.v25_reference(*CE.group_from_numpy(*group), K=K).numpy()
    assert np.array_equal(model, port)
    if jax:
        assert np.array_equal(model, jax_v25(group, K))
    return model


@functools.lru_cache(maxsize=None)
def _packed(block: int, n_blocks: int):
    data = gen_corpus(32 << 20)[:block * n_blocks]
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=block))
    plan = PB.plan_frame(arc)
    pieces, lits = PB.resolve_serial(plan, self_ref=True)
    return data, list(plan.totals), S.pack_blocks_v25(pieces, lits,
                                                      list(plan.totals),
                                                      block)


@pytest.mark.parametrize("block,n_blocks", [(65536, 2), (32768, 4)])
def test_model_equals_jax_and_plain_on_packed_groups(block, n_blocks):
    data, totals, group = _packed(block, n_blocks)
    assert (group[1] >= FLAG).any()                 # OUT quads
    out = _check(group, 2, True)
    assert b"".join(out[j].reshape(-1)[:t].tobytes()
                    for j, t in enumerate(totals)) == data


@pytest.mark.parametrize("NST", [4, 8])
@pytest.mark.parametrize("kind", ["chain", "boundary", "mixed"])
def test_model_equals_jax_and_plain_on_dependency_plans(kind, NST):
    """plan_group's windows at RLP + r become flagged quads at output row
    r; its windows straddling RLP (supertile 0 of "boundary", some of
    "mixed") stay lit quads, whose JAX window is clamped, so those plans
    keep them out (``_no_straddle``) for the JAX comparison."""
    group = _no_straddle(as_v25(plan_group(NST + len(kind), 2, NST, 256, 2,
                                           kind)))
    out = _check(group, 2, True)
    assert out[:, 128:].any()      # later supertiles hold bytes


def _no_straddle(group):
    """``group`` with each unflagged window that straddles RLP moved to
    lit row 0."""
    qs, qbase, pctrl, tq, lit8 = group
    RLP = lit8.shape[1]
    straddle = (qbase < FLAG) & (qbase + 127 >= RLP)
    return qs, np.where(straddle, 0, qbase).astype(np.int32), pctrl, tq, lit8


def test_chain_reads_the_previous_supertile():
    """Every live quad of supertile t >= 1 is flagged at output row
    (t-1)*128: pass 1 adds nothing there, every byte comes through pass 2
    (the longest chain: each supertile waits on the one before)."""
    group = as_v25(plan_group(1, 2, 8, 256, 2, "chain"))
    qs, qbase = group[:2]
    for b in range(2):
        for t in range(1, 8):
            for q in range(qs[b, t], qs[b, t + 1]):
                assert qbase[b, q] == FLAG + (t - 1) * 128
    out = _check(group, 2, True)
    assert all(out[:, t * 128:(t + 1) * 128].any() for t in range(8))


def test_boundary_reads_its_value_below_t128_and_zero_at_it():
    """The flagged boundary quad of supertile t reads output rows
    t*128 - 64 .. t*128 + 63: slot row 63 (output row t*128 - 1, stored)
    adds its value, slot row 64 (row t*128, not yet stored though the
    finished output holds bytes there) adds nothing."""
    group = _no_straddle(as_v25(plan_group(2, 2, 4, 256, 2, "boundary")))
    qs, qbase, pctrl, tq, lit8 = group
    out = _check(group, 2, True)
    assert out[:, 128::128].any()     # row t*128 holds bytes when finished
    for t in range(1, 4):
        q = int(qs[0, t])
        assert qbase[0, q] == FLAG + t * 128 - 64
    # the same plan read against the finished output (a stale buffer)
    # differs, so the rows at t*128 matter
    stale = np.zeros_like(out)
    for b in range(2):
        for t in range(4):
            tile = np.zeros((128, 128), np.int64)
            for src, tgt, idx, cov in _slots(qs, qbase, pctrl, tq, 2, b, t):
                if src >= FLAG and src - FLAG < out.shape[1]:
                    tile[tgt, cov] += out[b, src - FLAG, idx[cov]]
                elif 0 <= src < lit8.shape[1]:
                    tile[tgt, cov] += lit8[b, src, idx[cov]]
            stale[b, t * 128:(t + 1) * 128] = tile & 255
    assert not np.array_equal(stale, out)


def test_unflagged_window_past_rlp_adds_nothing_there():
    """An unflagged quad at qbase RLP - 64 (in [RLP - 127, RLP)): its slot
    rows 0..63 read lit rows RLP - 64 .. RLP - 1, its slot rows 64..127
    (window rows RLP .. RLP + 63, which v26 would read from the output)
    add nothing."""
    RLP, MAXQ, K = 256, 2, 2
    G32 = 32 * -(-4 * MAXQ // 128)
    qs = np.array([[0, 2, 2]], np.int32)
    qbase = np.array([[RLP - 64, 0]], np.int32)
    pctrl = np.full((1, K * G32, 128), 1 << 7, np.int64)
    tq = np.zeros((1, MAXQ, 128), np.uint8)
    for i in range(128):                     # slot i: row i, tile row i
        bat = i >> 5
        pctrl[0, 32 * (bat >> 7) + (i & 31), bat & 127] = (127 << 14) | (
            i << 21)
        tq[0, 0, i] = i
    lit8 = np.random.default_rng(0).integers(1, 256, (1, RLP, 128),
                                             dtype=np.uint8)
    group = (qs, qbase, pctrl.astype(np.uint32).view(np.int32), tq, lit8)
    out = _check(group, K, False)
    assert np.array_equal(out[0, :64], lit8[0, RLP - 64:])
    assert not out[0, 64:].any()
    # as a v26 plan the same quad reads output rows 0..63 (zero at
    # supertile 0 too), and as v19 the same lit rows: both agree here
    assert np.array_equal(out, CE.v19_reference(
        *CE.group_from_numpy(*group)).numpy())


@pytest.mark.parametrize("NST", [4, 8])
def test_model_equals_plain_on_garbage(NST):
    group = v25_group(60 + NST, 2, NST, 16, 256, garbage=True)
    assert (group[1] >= FLAG).any()
    out = _check(group, 2, False)
    assert out.any()


def test_straddling_plans_equal_plain():
    """The dependency plans with their straddling lit windows kept: the
    model equals the plain version (the JAX window is clamped there)."""
    for seed, kind in enumerate(("boundary", "mixed")):
        group = as_v25(plan_group(70 + seed, 2, 4, 256, 2, kind))
        assert ((group[1] < FLAG) & (group[1] + 127 >= 256)).any()
        _check(group, 2, False)


def test_k3_plans_equal_jax_and_plain():
    group = _no_straddle(as_v25(plan_group(5, 2, 4, 256, 3, "mixed")))
    _check(group, 3, True)
