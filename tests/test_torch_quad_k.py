"""The attic's K-plane quad-tile generations (v20, v22, v21, v23, v24) of
the PyTorch port against the JAX package: the packers ``attic_quad.
pack_blocks_v20/v22/v23`` (v21 and v24 pack with ``serial.
pack_blocks_v19``), the plain version ``copy_engine.quad_reference`` in
modes 20, 21, 23 and 24 and the entries ``attic_quad.decode_blocks_v20/
v22/v21/v23/v24`` against ``tools/kernel_attic.py`` in interpret mode: the
JAX entries ``decode_blocks_v20`` and ``decode_blocks_v21``, and for v22,
v23 and v24, which have none, the packer/kernel pairs of
``tools/tpu_ab_probe.py:56-70`` built straight from ``kernel_attic``. K = 2
throughout, as the entries run.

Inputs: archives made by ``zxc_tpu.codec.frame.compress`` from numpy data
with fixed seeds (16 and 32 KiB blocks, five blocks the last one short),
resolved as ``ops.decompress`` resolves them, and hand-made plans
(``test_torch_cuda.quad_plan``) that reach the bodies' corners: odd pair
counts, ranges that end below their start (v20's either range), plane-1
words covering lanes inside v20's plane-0 range, slot rows at or past
128, target rows outside the tile and sums past 255 (far below v24's
2^24). Tolerance: exact equality of every packed array, of the kernels'
output bytes (JAX's int32 output reduced mod 256; max abs err 0) and of
the decoded bytes.
"""
import numpy as np
import pytest
import torch

from zxc_tpu_torch.ops import attic_quad as Q, copy_engine as CE
from zxc_tpu_torch.ops import serial as S

from test_torch_jax_native import jax_native
from test_torch_serial import _case
from test_torch_attic import _resolved
from test_torch_attic_ops import _plans
from test_torch_cuda import quad_plan
from test_torch_quad import _equal, jax_quad, kernel_attic, port_quad

BLOCK = 16384
K = 2
# variant -> (port packer, JAX packer, JAX kernel, quad mode), as
# tools/tpu_ab_probe.py pairs them
PAIRS = {20: (Q.pack_blocks_v20, kernel_attic.pack_blocks_v20,
              kernel_attic.v20_kernel, 20),
         22: (Q.pack_blocks_v22, kernel_attic.pack_blocks_v22,
              kernel_attic.v20_kernel, 20),
         21: (S.pack_blocks_v19, kernel_attic.pack_blocks_v19,
              kernel_attic.v21_kernel, 21),
         23: (Q.pack_blocks_v23, kernel_attic.pack_blocks_v23,
              kernel_attic.v23_kernel, 23),
         24: (S.pack_blocks_v19, kernel_attic.pack_blocks_v19,
              kernel_attic.v24_kernel, 24)}
JAX_DECODE = {20: kernel_attic.decode_blocks_v20,
              21: kernel_attic.decode_blocks_v21}


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def jax_pair_decode(variant, pieces, lits, totals, block, dispatch):
    """``tools/tpu_ab_probe.py``'s ``build`` in interpret mode: groups of
    ``dispatch`` blocks, the last padded with copies of the last block
    (totals 0), packed once for the common MAXQ and RL and again at them,
    one kernel for all groups; each block's bytes."""
    _, pack, kfn, _ = PAIRS[variant]
    nb = len(totals)
    nd = -(-nb // dispatch)
    pad = nd * dispatch - nb
    p = list(pieces) + [pieces[-1]] * pad
    lf = list(lits) + [lits[-1]] * pad
    t = list(totals) + [0] * pad
    groups = [slice(d * dispatch, (d + 1) * dispatch) for d in range(nd)]
    raw = [pack(p[sl], lf[sl], t[sl], block, quad_align=2, K=K)
           for sl in groups]
    MAXQ = max(s[1].shape[1] for s in raw)
    RL = max(s[4].shape[1] for s in raw)
    sets = [pack(p[sl], lf[sl], t[sl], block, MAXQ=MAXQ, RL=RL,
                 quad_align=2, K=K) for sl in groups]
    kern = kfn(block, MAXQ, sets[0][4].shape[1], K, True)
    outs = [np.asarray(kern(*s)) for s in sets]
    return [outs[j // dispatch][j % dispatch].reshape(-1)[:totals[j]]
            .astype(np.uint8).tobytes() for j in range(nb)]


@pytest.mark.parametrize("variant", [20, 22, 23])
@pytest.mark.parametrize("name,block", [("l3", 16384), ("fills", 16384),
                                        ("cross", 16384), ("l3", 32768)])
def test_pack_blocks_equal_jax(name, block, variant):
    _, totals, pieces, lits = _plans(name, block)
    port, jax_pack, _, _ = PAIRS[variant]
    got = port(pieces, lits, totals, block)
    want = jax_pack(pieces, lits, totals, block)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    MAXQ, RL = got[1].shape[1] + 32, got[4].shape[1] + 100
    for x, y in zip(port(pieces, lits, totals, block, MAXQ=MAXQ, RL=RL),
                    jax_pack(pieces, lits, totals, block, MAXQ=MAXQ, RL=RL)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if variant != 23:       # qs (B, 2*NST+1): start, midpoint, end
        qs = got[0].astype(np.int64)
        assert qs.shape[1] == 2 * (block // 16384) + 1
        assert (np.diff(qs, axis=1) >= 0).all()


@pytest.mark.parametrize("variant", [20, 22, 21, 23, 24])
def test_quad_reference_equals_jax_on_packed_arrays(variant):
    """Every byte of the group's tiles, the padding past totals included."""
    _, totals, pieces, lits = _plans("l3", 2 * BLOCK)
    port, _, _, mode = PAIRS[variant]
    args = port(pieces, lits, totals, 2 * BLOCK)
    _equal(port_quad(args, mode), jax_quad(args, mode))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", [20, 21, 23, 24])
def test_quad_reference_hand_made_plans_equal_jax(mode, seed):
    args = quad_plan(seed, 2, 2 + seed, 24, 256, mode)
    got = port_quad(args, mode)
    _equal(got, jax_quad(args, mode))
    qs, _, pctrl, tq, _ = args
    d = np.diff(qs.astype(np.int64), axis=1)
    assert (d % 2).any() and (d < 0).any()
    assert ((pctrl.view(np.uint32) >> 21) >= 128).any()
    assert (tq >= 128).any() and got.any()


def test_v20_plane_0_range_ignores_the_other_planes():
    """The same quads run as v20's plane-0 range (midpoint at the end) or
    as its K-plane range (midpoint at the start): plane 1 covers lanes in
    both plans, so the two outputs differ, and each equals the JAX
    kernel."""
    qs, qbase, pctrl, tq, lit8 = quad_plan(4, 2, 2, 24, 256, 20)
    qs = np.array([[0, 0, 6, 6, 12], [4, 4, 10, 10, 14]], np.int32)
    single, multi = qs.copy(), qs.copy()
    single[:, 1::2] = qs[:, 2::2]
    multi[:, 1::2] = qs[:, 0:-1:2]
    outs = []
    for q in (single, multi):
        args = (q, qbase, pctrl, tq, lit8)
        outs.append(port_quad(args, 20))
        _equal(outs[-1], jax_quad(args, 20))
    assert not np.array_equal(*outs)


@pytest.mark.parametrize("variant", [20, 22, 21, 23, 24])
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
    if variant in JAX_DECODE:
        want = JAX_DECODE[variant](pieces, lits, totals, BLOCK,
                                   interpret=True, dispatch=2)
    else:
        want = jax_pair_decode(variant, pieces, lits, totals, BLOCK, 2)
    assert got == want
    assert b"".join(got) == data
    assert set(ph) == {"pack", "device"}


@pytest.mark.parametrize("variant", [20, 21])
def test_small_blocks_take_the_v13_route(variant, monkeypatch):
    block = 8192
    data, arc, do = _case("l3", block)
    plan, pieces, lits = _resolved(arc, do)
    totals = list(plan.totals)
    calls = []
    for name in ("v13", "quad"):
        real = getattr(CE, name)
        monkeypatch.setattr(CE, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    got = Q.ENTRIES[variant](pieces, lits, totals, block, device="cpu",
                                dispatch=2)
    assert calls == ["v13"] * 3
    assert got == JAX_DECODE[variant](pieces, lits, totals, block,
                                      interpret=True)
    assert b"".join(got) == data


def test_v22_v23_v24_refuse_small_blocks_as_their_packers_assert():
    _, totals, pieces, lits = _plans("l3", 8192)
    for variant in (22, 23, 24):
        with pytest.raises(ValueError, match="16384"):
            Q.ENTRIES[variant](pieces, lits, totals, 8192, device="cpu")
        with pytest.raises(AssertionError):
            PAIRS[variant][1](pieces, lits, totals, 8192)
    _, totals, pieces, lits = _plans("l3", BLOCK)
    for pack in (Q.pack_blocks_v20, Q.pack_blocks_v22):
        with pytest.raises(ValueError, match="MAXQ"):
            pack(pieces, lits, totals, BLOCK, MAXQ=1)


def test_quad_checks_k_plane_inputs():
    args = CE.group_from_numpy(*quad_plan(0, 2, 2, 24, 256, 20))
    qs, qbase, pctrl, tq, lit8 = args
    before = CE.quad.launches
    CE.quad(*args, mode=20)
    assert CE.quad.launches == before
    with pytest.raises(ValueError, match="bad qs"):      # width 2*NST+1
        CE.quad(qs[:, :-1], qbase, pctrl, tq, lit8, mode=20)
    with pytest.raises(ValueError, match="bad qs"):
        CE.quad(*args, mode=20, K=3)
    with pytest.raises(TypeError):                       # int32 tq for v20
        CE.quad(qs, qbase, pctrl, tq.to(torch.uint8), lit8, mode=20)
    u8 = CE.group_from_numpy(*quad_plan(0, 2, 2, 24, 256, 23))
    CE.quad(*u8, mode=23)
    with pytest.raises(TypeError):                       # uint8 tq for v23
        CE.quad(*u8[:3], u8[3].to(torch.int32), u8[4], mode=23)


def test_bytes_moved_counts_planes_per_range_and_layout():
    """v20's plane-0 range reads one plane of control, its K-plane range
    K; v23's interleaved rows hold the same words as v19's plane-major
    ones."""
    MAXQ = 4
    pctrl = np.full((1, 2 * 32, 128), 1 << 7, np.int32)
    args = (np.array([[0, 2, 4]], np.int32), np.zeros((1, MAXQ), np.int32),
            pctrl, np.zeros((1, MAXQ, 128), np.int32),
            np.zeros((1, 128, 128), np.uint8))
    assert CE.bytes_moved(*args, mode=20) == (
        12 + 2 * (4 + 512 + 512) + 2 * (4 + 512 + 1024) + 128 * 128)
    _, totals, pieces, lits = _plans("l3", BLOCK)
    assert CE.bytes_moved(*Q.pack_blocks_v23(pieces, lits, totals, BLOCK),
                          mode=23) == CE.bytes_moved(
        *S.pack_blocks_v19(pieces, lits, totals, BLOCK), mode=21)
