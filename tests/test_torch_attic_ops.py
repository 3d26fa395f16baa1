"""The attic's window-op (v4-v7) and lane-op (v9-v11) generations of the
PyTorch port against the JAX package: ``runtime.window_ops``, the packers
``_pad_ops_to_unroll``, ``pack_blocks_v4`` and ``pack_blocks_v9/v10/v11``
of ``ops/attic.py``, the plain versions ``window_merge_reference`` and
``lane_sum_reference`` and the entries ``decode_blocks_v4/v9/v10/v11``
against ``tools/kernel_attic.py`` (``v4_kernel`` with bodies v4-v7,
``v9_kernel``, ``v10_kernel``, ``v11_kernel`` and the decode entries) in
interpret mode.

Inputs: archives made by ``zxc_tpu.codec.frame.compress`` from numpy data
with fixed seeds (8 KiB blocks for v4-v7 and 16 KiB for v9-v11, as
``tests/test_pallas_serial.py`` runs them), resolved as ``ops.decompress``
resolves them (``device_pure``, ``max_frag=1``), and hand-made plans
(numpy, ``test_torch_cuda.window_plan`` / ``lane_plan``) where the
function matters: overlapping ranges, fills, nets and rows out of range,
windows that do not start on the unroll, sums past 255. Tolerance: exact
equality of every packed array, of the kernels' output bytes (JAX's int32
reduced mod 256) and of the decoded bytes.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from zxc_tpu import runtime as jrt
from zxc_tpu.ops import batch as JB

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.ops import attic as A

from test_torch_jax_native import jax_native
from test_torch_serial import _case
from test_torch_attic import _archive, _resolved
from test_torch_cuda import lane_plan, window_plan

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import kernel_attic  # noqa: E402

WINDOW_BLOCK = 8192
LANE_BLOCK = 16384
PAD = {4: 0, 5: 0, 6: kernel_attic.UNROLL, 7: kernel_attic.UNROLL7}
JAX_DECODE = {9: kernel_attic.decode_blocks_v9,
              10: kernel_attic.decode_blocks_v10,
              11: kernel_attic.decode_blocks_v11}
PORT_DECODE = {9: A.decode_blocks_v9, 10: A.decode_blocks_v10,
               11: A.decode_blocks_v11}


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


@functools.lru_cache(maxsize=None)
def _plans(name: str, block: int):
    """(data, totals, pieces, lits) of a case, resolved once."""
    data, arc, do = _archive(name, block)
    plan, pieces, lits = _resolved(arc, do)
    return data, list(plan.totals), pieces, lits


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("split_src", [False, True])
@pytest.mark.parametrize("name,block", [("l3", 8192), ("fills", 4096),
                                        ("cross", 16384), ("dict", 8192)])
def test_window_ops_equals_jax(name, block, split_src):
    _, totals, pieces, _ = _plans(name, block)
    for p, t in zip(pieces, totals):
        got = prt.window_ops(*p, int(t), split_src)
        want = jrt.window_ops(*p, int(t), split_src)
        assert len(got) == 2
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
        for unroll in (kernel_attic.UNROLL, kernel_attic.UNROLL7):
            for x, y in zip(A._pad_ops_to_unroll(*got, unroll=unroll),
                            kernel_attic._pad_ops_to_unroll(*want,
                                                            unroll=unroll)):
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("variant", [4, 5, 6, 7])
@pytest.mark.parametrize("name", ["l3", "fills", "dict"])
def test_pack_blocks_v4_equals_jax(name, variant):
    _, totals, pieces, lits = _plans(name, WINDOW_BLOCK)
    kw = dict(split_src=variant >= 5, pad_unroll=PAD[variant])
    (a, ashape), (b, bshape) = (
        A.pack_blocks_v4(pieces, lits, totals, WINDOW_BLOCK, **kw),
        kernel_attic.pack_blocks_v4(pieces, lits, totals, WINDOW_BLOCK,
                                    **kw))
    assert ashape == bshape
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", ["l3", "fills", "cross"])
def test_pack_blocks_v9_v10_v11_equal_jax(name):
    _, totals, pieces, lits = _plans(name, LANE_BLOCK)
    per = kernel_attic.lane_ops_blocks(pieces, totals)
    layers = A.v11_layers(per)
    for got, want in (
            (A.pack_blocks_v9(pieces, lits, totals, LANE_BLOCK),
             kernel_attic.pack_blocks_v9(pieces, lits, totals, LANE_BLOCK)),
            (A.pack_blocks_v10(pieces, lits, totals, LANE_BLOCK),
             kernel_attic.pack_blocks_v10(pieces, lits, totals, LANE_BLOCK)),
            (A.pack_blocks_v11(pieces, lits, totals, LANE_BLOCK),
             kernel_attic.pack_blocks_v11(pieces, lits, totals, LANE_BLOCK,
                                          per=per, LAYERS=layers))):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _jax_window(args, OR, RL, block, mode):
    out = np.asarray(kernel_attic.v4_kernel(block, OR, RL, True, mode)(*args))
    return (out.reshape(len(out), -1)[:, :block] & 255).astype(np.uint8)


def _jax_lane(ts, rows, pctrl, lit, layers, block, mode):
    B = len(pctrl)
    if mode == 9:
        out = kernel_attic.v9_kernel(block, rows.shape[1] // 32, lit.shape[1],
                                     True)(np.zeros(B, np.int32), ts, rows,
                                           pctrl, lit)
    elif mode == 10:
        out = kernel_attic.v10_kernel(block, pctrl.shape[1] // 32 * 128,
                                      lit.shape[1], True)(
            np.zeros(B, np.int32), ts, pctrl, lit)
    else:
        out = kernel_attic.v11_kernel(block, layers, lit.shape[1], True)(
            pctrl, lit)
    return (np.asarray(out).reshape(B, -1) & 255).astype(np.uint8)


@pytest.mark.parametrize("variant", [4, 5, 6, 7])
def test_window_merge_reference_equals_jax_on_packed_arrays(variant):
    """Every byte of the block, the padding past totals included."""
    _, totals, pieces, lits = _plans("cross", WINDOW_BLOCK)
    args, (OR, RL, _) = A.pack_blocks_v4(
        pieces, lits, totals, WINDOW_BLOCK, split_src=variant >= 5,
        pad_unroll=PAD[variant])
    got = A.window_merge(*_t(args), block=WINDOW_BLOCK, mode=variant)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), _jax_window(args, OR, RL,
                                                   WINDOW_BLOCK, variant))


def test_lane_sum_reference_equals_jax_on_packed_arrays():
    _, totals, pieces, lits = _plans("cross", LANE_BLOCK)
    nb, ts, rows, pctrl, lit32 = A.pack_blocks_v9(pieces, lits, totals,
                                                  LANE_BLOCK)
    nb10, ts10, pctrl10, lit8 = A.pack_blocks_v10(pieces, lits, totals,
                                                  LANE_BLOCK)
    layers = A.v11_layers(kernel_attic.lane_ops_blocks(pieces, totals))
    pctrl11, lit11 = A.pack_blocks_v11(pieces, lits, totals, LANE_BLOCK,
                                       LAYERS=layers)
    for mode, (t, r, pc, lit, la) in (
            (9, (ts, rows, pctrl, lit32, 0)),
            (10, (ts10, None, pctrl10, lit8, 0)),
            (11, (None, None, pctrl11, lit11, layers))):
        got = A.lane_sum(torch.from_numpy(pc), torch.from_numpy(lit),
                         LANE_BLOCK, mode,
                         ts=None if t is None else torch.from_numpy(t),
                         rows=None if r is None else torch.from_numpy(r),
                         layers=la)
        assert np.array_equal(got.numpy(), _jax_lane(t, r, pc, lit, la,
                                                     LANE_BLOCK, mode))


@pytest.mark.parametrize("mode", [4, 5, 6, 7])
@pytest.mark.parametrize("seed", range(3))
def test_window_merge_hand_made_plans_equal_jax(seed, mode):
    """Overlapping ranges (the last op wins), fills past 256, nets at 0,
    W - 1, W, negative and huge, srow negative and past the rows, v6/v7
    windows that do not start on a multiple of the unroll."""
    block = 2048 if seed else 4096
    ws, ops, lit8 = window_plan(seed, 2, block, mode)
    if mode >= 6:
        assert (ws % A.WINDOW_MODES[mode][1]).any()
    got = A.window_merge_reference(*_t((ws, ops, lit8)), block, mode)
    want = _jax_window((ws, ops, lit8), ops.shape[1], lit8.shape[1], block,
                       mode)
    assert np.array_equal(got.numpy(), want)
    # the plans reach every case they are made for
    f = ops.reshape(2, -1, 4)[:, :ws.max()]
    assert (f[..., 3] > 256).any() and (f[..., 0] < 0).any()
    assert (f[..., 0] > lit8.shape[1]).any() and (f[..., 1] < 0).any()


@pytest.mark.parametrize("mode", [9, 10, 11])
@pytest.mark.parametrize("seed", range(3))
def test_lane_sum_hand_made_plans_equal_jax(seed, mode):
    """Lane overlaps whose sums wrap past 255, v9 rows negative or past
    the lit rows (clamped as interpret mode clamps) and any int32 lit,
    v10/v11 rows at or past the lit rows (0), tile batch counts that are
    not multiples of 4."""
    block = 8192 if seed else 4096
    ts, rows, pctrl, lit, layers = lane_plan(seed, 2, block, mode)
    got = A.lane_sum_reference(
        torch.from_numpy(pctrl), torch.from_numpy(lit), block, mode,
        ts=None if ts is None else torch.from_numpy(ts),
        rows=None if rows is None else torch.from_numpy(rows), layers=layers)
    assert np.array_equal(got.numpy(), _jax_lane(ts, rows, pctrl, lit,
                                                 layers, block, mode))
    c = pctrl.astype(np.int64)
    if mode == 9:
        assert (rows < 0).any() and (rows >= lit.shape[1]).any()
    else:
        assert ((c >> 21 & 2047) >= lit.shape[1]).any()
    if mode != 11:
        assert (np.diff(ts, axis=1) % 4).any()


def test_lane_sum_wraps_past_255():
    """Four ops of one sublane over the same lanes: the byte is the low
    byte of the int32 sum, in the plain version and the JAX kernel."""
    block = 4096
    ts = np.array([[0, 4]], np.int32)
    rows = np.zeros((1, 8 * 32), np.int32)
    pctrl = np.full((1, 32, 128), 1 << 8, np.int32)
    pctrl[0, 5, :4] = 0 | (0 << 8) | (127 << 16)          # sublane 5, bats 0-3
    lit = np.full((1, 2, 128), 200, np.int32)
    got = A.lane_sum_reference(*_t((pctrl, lit)), block, 9,
                               ts=torch.from_numpy(ts),
                               rows=torch.from_numpy(rows)).numpy()
    assert (got.reshape(32, 128)[5] == (800 & 255)).all()
    assert not np.delete(got.reshape(32, 128), 5, axis=0).any()
    assert np.array_equal(got, _jax_lane(ts, rows, pctrl, lit, 0, block, 9))


@pytest.mark.parametrize("variant", [4, 5, 6, 7, 9, 10, 11])
@pytest.mark.parametrize("level", [1, 3, 5])
def test_decode_blocks_equal_jax_and_plaintext(level, variant):
    """Five blocks, the last one short, in three dispatch groups."""
    block = WINDOW_BLOCK if variant < 8 else LANE_BLOCK
    data, arc, do = _case(f"l{level}", block)
    plan, pieces, lits = _resolved(arc, do)
    totals = list(plan.totals)
    assert len(totals) == 5 and totals[-1] < block
    ph = {}
    if variant < 8:
        got = A.decode_blocks_v4(pieces, lits, totals, block, device="cpu",
                                 variant=variant, dispatch=2, _phases=ph)
        want = kernel_attic.decode_blocks_v4(pieces, lits, totals, block,
                                             interpret=True, variant=variant)
    else:
        got = PORT_DECODE[variant](pieces, lits, totals, block, device="cpu",
                                   dispatch=2, _phases=ph)
        want = JAX_DECODE[variant](pieces, lits, totals, block,
                                   interpret=True)
    assert got == want
    assert b"".join(got) == data
    assert set(ph) == {"pack", "device"}


def test_v10_v11_refuse_more_than_2048_literal_rows():
    _, totals, pieces, lits = _plans("l3", LANE_BLOCK)
    big = [np.zeros(2048 * 128, np.uint8)] + list(lits[1:])
    for port, jax_pack in ((A.pack_blocks_v10, kernel_attic.pack_blocks_v10),
                           (A.pack_blocks_v11, kernel_attic.pack_blocks_v11)):
        with pytest.raises(ValueError, match="at most 2048"):
            port(pieces, big, totals, LANE_BLOCK)
        with pytest.raises(AssertionError):
            jax_pack(pieces, big, totals, LANE_BLOCK)
        port(pieces, [big[0][:2047 * 128 - 128]] + big[1:], totals,
             LANE_BLOCK)                                   # 2048 rows: fits
    for fn in (A.decode_blocks_v10, A.decode_blocks_v11):
        with pytest.raises(ValueError, match="2048"):
            fn(pieces, big, totals, LANE_BLOCK, device="cpu")


def test_split_src_op_budget_refuses_as_jax_does():
    """``zxch_window_ops2`` splits a periodic piece at every source
    granule its phase crosses, which can pass its budget of 3 ops a
    piece: the JAX packer asserts, the port raises ValueError (v4's
    unsplit ops still decode the block)."""
    data, totals, pieces, lits = _plans("l3", LANE_BLOCK)
    assert prt.window_ops(*pieces[1], totals[1], True) is None
    assert jrt.window_ops(*pieces[1], totals[1], True) is None
    with pytest.raises(ValueError, match="budget"):
        A.decode_blocks_v4(pieces, lits, totals, LANE_BLOCK, device="cpu",
                           variant=5)
    with pytest.raises(AssertionError):
        kernel_attic.pack_blocks_v4(pieces, lits, totals, LANE_BLOCK,
                                    split_src=True)
    assert b"".join(A.decode_blocks_v4(pieces, lits, totals, LANE_BLOCK,
                                       device="cpu")) == data


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    ws, ops, lit8 = _t(window_plan(0, 2, 4096, 4))
    ts, rows, pctrl, lit = (torch.from_numpy(a) for a in
                            lane_plan(0, 2, 8192, 9)[:4])
    before = (A.window_merge.launches, A.lane_sum.launches)
    A.window_merge(ws, ops, lit8, block=4096, mode=4)
    A.lane_sum(pctrl, lit, 8192, 9, ts=ts, rows=rows)
    assert (A.window_merge.launches, A.lane_sum.launches) == before
    with pytest.raises(TypeError):
        A.window_merge(ws, ops.long(), lit8, block=4096, mode=4)
    with pytest.raises(ValueError, match="inconsistent"):
        A.window_merge(ws, ops, lit8, block=8192, mode=4)
    with pytest.raises(ValueError, match="inconsistent"):
        A.window_merge(ws, ops, lit8[:, :15], block=4096, mode=4)
    with pytest.raises(ValueError, match="mode"):
        A.window_merge(ws, ops, lit8, block=4096, mode=8)
    with pytest.raises(TypeError):
        A.lane_sum(pctrl, lit.to(torch.uint8), 8192, 9, ts=ts, rows=rows)
    with pytest.raises(TypeError):
        A.lane_sum(pctrl, lit, 8192, 9, ts=ts)
    with pytest.raises(ValueError, match="inconsistent"):
        A.lane_sum(pctrl, lit, 4096, 9, ts=ts, rows=rows)
    with pytest.raises(ValueError, match="inconsistent"):
        A.lane_sum(pctrl, lit.to(torch.uint8), 8192, 11, layers=-4)
    meta = [x.to("meta") for x in (ws, ops, lit8)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.window_merge(*meta, block=4096, mode=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.lane_sum(pctrl.to("meta"), lit.to("meta"), 8192, 9,
                   ts=ts.to("meta"), rows=rows.to("meta"))
    with pytest.raises(ValueError, match="variant"):
        A.decode_blocks_v4([], [], [], 4096, device="cpu", variant=8)
    assert set(A.KERNELS) == {"attic", "window_merge", "lane_sum"}


def test_entries_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot be "
                    "observed")
    _, totals, pieces, lits = _plans("l3", LANE_BLOCK)
    for fn in (A.decode_blocks_v4, A.decode_blocks_v9, A.decode_blocks_v10,
               A.decode_blocks_v11):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(pieces, lits, totals, LANE_BLOCK)


def test_bytes_moved_counts_live_ops_lits_and_output():
    _, totals, pieces, lits = _plans("l3", WINDOW_BLOCK)
    for variant, split in ((4, False), (6, True)):
        (ws, ops, _), _ = A.pack_blocks_v4(pieces, lits, totals,
                                           WINDOW_BLOCK, split_src=split,
                                           pad_unroll=PAD[variant])
        n_ops = sum(len(prt.window_ops(*p, int(t), split)[0]) // 4
                    for p, t in zip(pieces, totals))
        assert A.bytes_moved_window(ws, ops, lits, WINDOW_BLOCK) == (
            ws.nbytes + 16 * n_ops + sum(map(len, lits))
            + len(pieces) * WINDOW_BLOCK)
    _, totals, pieces, lits = _plans("l3", LANE_BLOCK)
    B = len(pieces)
    lit_bytes = sum(map(len, lits))
    per = kernel_attic.lane_ops_blocks(pieces, totals)
    live = sum(int((r[3] > 0).sum()) for r in per)
    nb, ts, rows, pctrl, _ = A.pack_blocks_v9(pieces, lits, totals,
                                              LANE_BLOCK)
    assert A.bytes_moved_lane(pctrl, lits, LANE_BLOCK, 9, ts, nb) == (
        ts.nbytes + nb.nbytes + 8 * live + lit_bytes + B * LANE_BLOCK)
    pctrl11, _ = A.pack_blocks_v11(pieces, lits, totals, LANE_BLOCK)
    assert A.bytes_moved_lane(pctrl11, lits, LANE_BLOCK, 11) == (
        4 * live + lit_bytes + B * LANE_BLOCK)


def test_decompress_routes_no_window_or_lane_variant():
    """As in the JAX package, ``ops.decompress`` routes none of variants
    4-11; the port's message names its entries."""
    data, arc, _ = _case("l3", 4096)
    for variant in (4, 7, 9, 11):
        with pytest.raises(NotImplementedError,
                           match="decode_blocks_v4.*decode_blocks_v11"):
            Z.ops.decompress(arc, device="cpu", use_serial=True,
                             variant=variant)
    with pytest.raises(NotImplementedError, match="decode_blocks_v9"):
        A.decode_blocks([], [], [], 4096, device="cpu", variant=9)
    plan, pieces, lits = _resolved(arc)
    assert b"".join(A.decode_blocks_v4(pieces, lits, list(plan.totals), 4096,
                                       device="cpu")) == data
    assert JB.decompress(arc) == data
