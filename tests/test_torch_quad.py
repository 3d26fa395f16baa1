"""The attic's single-plane quad-tile generations (v12, v14, v15, v16,
v17) of the PyTorch port against the JAX package: the packers
(``serial.pack_blocks_v12`` with ``quad_align=1``, ``attic_quad.
pack_blocks_v15`` with v16's ``quad_align=4`` and v17's ``base_align=32``),
the plain version ``copy_engine.quad_reference`` in modes 12, 14, 15, 16
and 17 and the entries ``attic_quad.decode_blocks_v12/v14/v15/v16/v17``
against ``tools/kernel_attic.py`` (``v12_kernel`` ... ``v17_kernel`` and
the decode entries) in interpret mode.

Inputs: archives made by ``zxc_tpu.codec.frame.compress`` from numpy data
with fixed seeds (16 and 32 KiB blocks, five blocks the last one short),
resolved as ``ops.decompress`` resolves them (``device_pure``,
``max_frag=1``), and hand-made plans (``test_torch_cuda.quad_plan``) that
reach the bodies' corners: odd tile quad counts, counts that are not
multiples of 4, ranges that end below their start, slot rows at or past
128, target rows outside the tile and sums past 255. Tolerance: exact
equality of every packed array, of the kernels' output bytes (JAX's int32
output reduced mod 256, so v17's signed int8 sums compare as bytes; max
abs err 0) and of the decoded bytes.
"""
import os
import sys

import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch.ops import attic_quad as Q, copy_engine as CE
from zxc_tpu_torch.ops import serial as S

from test_torch_jax_native import jax_native
from test_torch_serial import _case
from test_torch_attic import _resolved
from test_torch_attic_ops import _plans
from test_torch_cuda import quad_plan

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import kernel_attic  # noqa: E402

BLOCK = 16384
K_MODES = (20, 21, 23, 24)
JAX_KERNEL = {12: kernel_attic.v12_kernel, 14: kernel_attic.v14_kernel,
              15: kernel_attic.v15_kernel, 16: kernel_attic.v16_kernel,
              17: kernel_attic.v17_kernel, 20: kernel_attic.v20_kernel,
              21: kernel_attic.v21_kernel, 23: kernel_attic.v23_kernel,
              24: kernel_attic.v24_kernel}
JAX_DECODE = {12: kernel_attic.decode_blocks_v12,
              14: kernel_attic.decode_blocks_v14,
              15: kernel_attic.decode_blocks_v15,
              16: kernel_attic.decode_blocks_v16,
              17: kernel_attic.decode_blocks_v17}
@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def jax_quad(args, mode: int, K: int = 2) -> np.ndarray:
    """The JAX kernel of ``mode`` in interpret mode on one packed group:
    (B, NT*R, 128) uint8 (its int32 output mod 256)."""
    qs, qbase, pctrl, tq, lit8 = args
    m = CE.QUAD_MODES[mode]
    NT = (qs.shape[1] - 1) // 2 if m.split else qs.shape[1] - 1
    block = NT * m.rows * 128
    if mode in K_MODES:
        kern = JAX_KERNEL[mode](block, qbase.shape[1], lit8.shape[1], K, True)
    else:
        kern = JAX_KERNEL[mode](block, qbase.shape[1], lit8.shape[1], True)
    return (np.asarray(kern(*args)) & 255).astype(np.uint8)


def port_quad(args, mode: int, K: int = 2) -> np.ndarray:
    out = CE.quad(*CE.group_from_numpy(*args), mode=mode, K=K)
    assert out.dtype == torch.uint8
    return out.numpy()


def _equal(got, want):
    assert got.shape == want.shape
    assert int(np.abs(got.astype(np.int32) - want).max()) == 0


@pytest.mark.parametrize("name", ["l3", "fills", "cross"])
def test_pack_blocks_v12_every_quad_equals_jax(name):
    """``quad_align=1``, v12's and v14's packing (the serial route packs v13
    with 2)."""
    _, totals, pieces, lits = _plans(name, BLOCK)
    got = S.pack_blocks_v12(pieces, lits, totals, BLOCK)
    want = kernel_attic.pack_blocks_v12(pieces, lits, totals, BLOCK)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (np.diff(got[0], axis=1) % 2).any()      # odd tile quad counts


@pytest.mark.parametrize("quad_align,base_align", [(2, 16), (4, 16),
                                                   (2, 32)])
@pytest.mark.parametrize("name,block", [("l3", 16384), ("fills", 16384),
                                        ("cross", 16384), ("l3", 32768)])
def test_pack_blocks_v15_equals_jax(name, block, quad_align, base_align):
    _, totals, pieces, lits = _plans(name, block)
    kw = dict(quad_align=quad_align, base_align=base_align)
    got = Q.pack_blocks_v15(pieces, lits, totals, block, **kw)
    want = kernel_attic.pack_blocks_v15(pieces, lits, totals, block, **kw)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # explicit MAXQ and RL, as the JAX entries bucket them
    MAXQ, RL = got[1].shape[1] + 32, got[4].shape[1] + 100
    for x, y in zip(Q.pack_blocks_v15(pieces, lits, totals, block, MAXQ=MAXQ,
                                      RL=RL, **kw),
                    kernel_attic.pack_blocks_v15(pieces, lits, totals, block,
                                                 MAXQ=MAXQ, RL=RL, **kw)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("variant", [12, 14, 15, 16, 17])
def test_quad_reference_equals_jax_on_packed_arrays(variant):
    """Every byte of the group's tiles, the padding past totals included."""
    _, totals, pieces, lits = _plans("l3", 2 * BLOCK)
    mode, pack, _ = Q.VARIANTS[variant]
    args = pack(pieces, lits, totals, 2 * BLOCK)
    _equal(port_quad(args, mode), jax_quad(args, mode))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", [12, 14, 15, 16, 17])
def test_quad_reference_hand_made_plans_equal_jax(mode, seed):
    rows = CE.QUAD_MODES[mode].rows
    args = quad_plan(seed, 2, 2 + seed, 24, 256, mode)
    got = port_quad(args, mode)
    _equal(got, jax_quad(args, mode))
    # the plans reach the corners they are made for
    qs, _, pctrl, tq, _ = args
    d = np.diff(qs.astype(np.int64), axis=1)
    assert (d % 2).any() and (d % 4).any() and (d < 0).any()
    assert ((pctrl.view(np.uint32) >> 21) >= 128).any()
    assert ((tq < 0) | (tq >= rows)).any()
    assert got.any()


def test_quad_walks_each_body_loop():
    """One slot a quad adds 1 to every lane of tile row 0, so the row holds
    the number of quads the tile ran: v12 every quad of [q0, q1), v13 the
    pairs, v14 fours then ones (for q1 < q0 the (q1 - q0) mod 4 quads below
    q1), v16 the fours, none for q1 < q0 otherwise."""
    MAXQ, RLP = 16, 256
    G32 = 32 * -(-4 * MAXQ // 128)
    pctrl = np.full((1, G32, 128), 1 << 7, np.int32)
    pctrl[0, 0, :] = 127 << 14                  # slot 0 of each quad
    tq = np.full((1, MAXQ, 128), 1000, np.int32)   # outside any tile
    tq[:, :, 0] = 0
    lit8 = np.zeros((1, RLP, 128), np.uint8)
    lit8[0, 0] = 1
    qbase = np.zeros((1, MAXQ), np.int32)
    want = {12: [0, 0, 7, 0, 0], 14: [2, 1, 7, 1, 1], 13: [0, 0, 6, 0, 0]}
    for k, (q0, q1) in enumerate([(5, 3), (7, 4), (2, 9), (9, 2), (10, 3)]):
        qs = np.array([[q0, q1]], np.int32)
        args = (qs, qbase, pctrl, tq, lit8)
        for mode in (12, 14):
            got = port_quad(args, mode)
            assert (got[0, 0] == want[mode][k]).all()
            _equal(got, jax_quad(args, mode))
        assert (CE.v13(*CE.group_from_numpy(*args))[0, 0].numpy()
                == want[13][k]).all()
    args = (np.array([[1, 8]], np.int32), qbase, pctrl, tq, lit8)
    for mode, n in ((15, 6), (16, 4), (17, 6)):     # 7 quads
        got = port_quad(args, mode)
        assert (got[0, 0] == n).all() and not got[0, 1:].any()
        _equal(got, jax_quad(args, mode))


@pytest.mark.parametrize("variant", [12, 14, 15, 16, 17])
@pytest.mark.parametrize("level", [1, 3, 5])
def test_decode_blocks_equal_jax_and_plaintext(level, variant):
    """Five 16 KiB blocks, the last one short, in three dispatch groups."""
    data, arc, do = _case(f"l{level}", BLOCK)
    plan, pieces, lits = _resolved(arc, do)
    totals = list(plan.totals)
    assert len(totals) == 5 and totals[-1] < BLOCK
    ph = {}
    got = Q.ENTRIES[variant](pieces, lits, totals, BLOCK, device="cpu",
                                dispatch=2, _phases=ph)
    want = JAX_DECODE[variant](pieces, lits, totals, BLOCK, interpret=True)
    assert got == want
    assert b"".join(got) == data
    assert set(ph) == {"pack", "device"}


def test_decode_blocks_v12_one_launch_without_dispatch(monkeypatch):
    """``dispatch=None`` packs every block into one call, as the JAX
    entry does."""
    data, totals, pieces, lits = _plans("l3", BLOCK)
    calls = []
    real = CE.quad
    monkeypatch.setattr(CE, "quad", lambda *a, **kw: calls.append(
        kw["mode"]) or real(*a, **kw))
    assert b"".join(Q.decode_blocks_v12(pieces, lits, totals, BLOCK,
                                        device="cpu", dispatch=None)) == data
    assert calls == [12]
    calls.clear()
    Q.decode_blocks_v14(pieces, lits, totals, BLOCK, device="cpu",
                        dispatch=2)
    assert calls == [14] * -(-len(totals) // 2)


@pytest.mark.parametrize("variant", [15, 16, 17])
def test_small_blocks_take_the_v13_route(variant, monkeypatch):
    """Below 16 KiB the JAX entries decode through v13; so does the port,
    one v13 call a dispatch group and no quad call."""
    block = 8192
    data, arc, do = _case("l3", block)
    plan, pieces, lits = _resolved(arc, do)
    totals = list(plan.totals)
    calls = []
    for name in ("v13", "quad"):
        real = getattr(CE, name)
        monkeypatch.setattr(CE, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    ph = {}
    got = Q.ENTRIES[variant](pieces, lits, totals, block, device="cpu",
                                dispatch=2, _phases=ph)
    assert calls == ["v13"] * 3 and set(ph) == {"pack", "device"}
    assert got == JAX_DECODE[variant](pieces, lits, totals, block,
                                      interpret=True)
    assert b"".join(got) == data


def test_packers_raise_where_jax_asserts():
    _, totals, pieces, lits = _plans("l3", 8192)
    with pytest.raises(ValueError, match="16384"):
        Q.pack_blocks_v15(pieces, lits, totals, 8192)
    with pytest.raises(AssertionError):
        kernel_attic.pack_blocks_v15(pieces, lits, totals, 8192)
    _, totals, pieces, lits = _plans("l3", BLOCK)
    with pytest.raises(ValueError, match="MAXQ"):
        Q.pack_blocks_v15(pieces, lits, totals, BLOCK, MAXQ=1)
    with pytest.raises(AssertionError):
        kernel_attic.pack_blocks_v15(pieces, lits, totals, BLOCK, MAXQ=1)


def test_quad_checks_inputs_and_counts_no_cpu_launches():
    args = CE.group_from_numpy(*quad_plan(0, 2, 1, 24, 256, 15))
    qs, qbase, pctrl, tq, lit8 = args
    before = CE.quad.launches
    for mode in (15, 16, 17):
        CE.quad(*args, mode=mode)
    assert CE.quad.launches == before
    with pytest.raises(TypeError):              # int32 tq, never converted
        CE.quad(qs, qbase, pctrl, tq.to(torch.uint8), lit8, mode=15)
    with pytest.raises(TypeError):
        CE.quad(qs, qbase, pctrl, tq, lit8.to(torch.int32), mode=15)
    with pytest.raises(ValueError, match="quad mode"):
        CE.quad(*args, mode=13)
    with pytest.raises(ValueError, match="inconsistent"):
        CE.quad(qs, qbase[:, :4], pctrl, tq, lit8, mode=15)
    with pytest.raises(ValueError, match="cuda or cpu"):
        CE.quad(*(x.to("meta") for x in args), mode=15)
    assert CE.KERNELS["quad"] is CE.quad
    assert CE.REFERENCES["quad"] is CE.quad_reference


def test_entries_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot be "
                    "observed")
    _, totals, pieces, lits = _plans("l3", BLOCK)
    for fn in Q.ENTRIES.values():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(pieces, lits, totals, BLOCK)


def test_bytes_moved_counts_the_quads_each_mode_runs():
    """v12 runs the odd trailing quad that v13 skips: 4 bytes of qbase,
    128 int32 tq and 128 control words more (its slot reads a row that
    another quad reads too)."""
    MAXQ = 8
    pctrl = np.full((1, 32, 128), 1 << 7, np.int32)
    pctrl[0, 0, :4 * MAXQ:4] = 127 << 14               # slot 0 of each quad
    args = (np.array([[0, 3]], np.int32), np.zeros((1, MAXQ), np.int32),
            pctrl, np.zeros((1, MAXQ, 128), np.int32),
            np.zeros((1, 128, 128), np.uint8))
    v13 = CE.bytes_moved(*args, K=1, rows=32)
    assert CE.bytes_moved(*args, mode=12) == v13 + 4 + 128 * 4 + 128 * 4
    assert CE.bytes_moved(*args, mode=14) == CE.bytes_moved(*args, mode=12)
    assert v13 == 8 + 2 * (4 + 512 + 512) + 128 + 32 * 128
    _, totals, pieces, lits = _plans("l3", BLOCK)
    packed = Q.pack_blocks_v15(pieces, lits, totals, BLOCK)
    assert CE.bytes_moved(*packed, mode=15) == CE.bytes_moved(
        *packed, mode=17) > len(totals) * BLOCK


def test_decompress_names_the_quad_entries():
    """As in the JAX package, ``ops.decompress`` routes none of v12-v24;
    the port's message names the entries."""
    data, arc, _ = _case("l3", BLOCK)
    for variant in (12, 15, 20, 24):
        with pytest.raises(NotImplementedError,
                           match="decode_blocks_v12.*decode_blocks_v24"):
            Z.ops.decompress(arc, device="cpu", use_serial=True,
                             variant=variant)
