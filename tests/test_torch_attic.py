"""The attic route of the PyTorch port against the JAX package:
``ops/attic.py`` (``pack_blocks``, the piece-serial kernel's plain
version, ``decode_blocks``) and ``ops.decompress(use_serial=True,
variant=1|2|3)`` against ``tools/kernel_attic.py``'s ``pack_blocks`` and
``decode_blocks(interpret=True, variant=v)``.

Inputs: archives made by ``zxc_tpu.codec.frame.compress`` from numpy data
with fixed seeds, resolved as ``ops.decompress`` resolves them
(``device_pure``, ``max_frag=1``), and hand-made piece plans (numpy) on
which the bodies' chunk-anchored phase and v2/v3's fill splat differ from
``lit[c + (p - s) % k]``. Tolerance: exact equality of every packed array
and of the decoded bytes (JAX's int32 output reduced mod 256), and of the
error codes.
"""
import os
import sys

import numpy as np
import pytest
import torch

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.ops import batch as JB
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch.ops import attic as A

from test_torch_jax_native import jax_native
from test_torch_serial import _case, _pdo

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import kernel_attic  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _resolved(arc, do=None):
    plan = JB.plan_frame(arc, do)
    pieces, lits = [], []
    for i in range(plan.n_blocks):
        r = jrt.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                               plan.lit[i], plan.dict_buf, device_pure=True,
                               max_frag=1)
        pieces.append(r[:4])
        lits.append(r[4])
    return plan, pieces, lits


def _fills_and_periods() -> bytes:
    return (b"\x00" * 30_000 + b"xy" * 8_000
            + b"".join(bytes(range(k)) * (2000 // k) for k in (3, 7, 13))
            + b"\xff" * 5_000)


def _archive(name: str, block: int):
    """(data, archive, decode opts) for a case of the attic tests."""
    if name == "fills":
        data = _fills_and_periods()
        return data, jframe.compress(data, EncodeOpts(
            level=4, block_size=block)), None
    if name == "cross":       # pieces straddling 1024-byte windows
        rng = np.random.default_rng(9)
        base = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
        data = base + base[100:3100] + base[:1024] + base[2000:2001] * 2000
        return data, jframe.compress(data, EncodeOpts(
            level=3, block_size=block)), None
    return _case(name, block)


CASES = [("l3", 4096), ("dict", 8192), ("fills", 4096), ("cross", 16384),
         ("l6", 8192)]


@pytest.mark.parametrize("name,block", CASES)
def test_pack_blocks_equals_jax(name, block):
    data, arc, do = _archive(name, block)
    plan, pieces, lits = _resolved(arc, do)
    (a, ashape), (b, bshape) = (
        A.pack_blocks(pieces, lits, plan.totals, block),
        kernel_attic.pack_blocks(pieces, lits, plan.totals, block))
    assert ashape == bshape
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("variant", [1, 2, 3])
@pytest.mark.parametrize("name,block", CASES)
def test_decode_blocks_equals_jax_interpret(name, block, variant):
    data, arc, do = _archive(name, block)
    plan, pieces, lits = _resolved(arc, do)
    want = kernel_attic.decode_blocks(pieces, lits, plan.totals, block,
                                      interpret=True, variant=variant)
    got = A.decode_blocks(pieces, lits, plan.totals, block, device="cpu",
                          variant=variant, dispatch=3)
    assert got == want
    assert b"".join(got) == data
    ph = {}
    out = Z.ops.decompress(arc, _pdo(do), device="cpu", use_serial=True,
                           variant=variant, dispatch=3, _phases=ph)
    assert out == data and ph["route"] == "serial"
    assert set(ph) == {"plan", "resolve", "pack", "device", "total",
                       "route"}


def _loop_oracle(pieces, lit, total, block, fill_from_s):
    """The kernel's function, byte by byte in Python."""
    po, pc, ps, pk = (np.asarray(a, np.int64) for a in pieces)
    out = np.zeros(block, np.uint8)
    for p in range(min(total, block)):
        i = int(np.searchsorted(po, p, side="right")) - 1
        if i < 0:
            continue
        k = max(int(pk[i]), 1)
        if fill_from_s and pk[i] == 1:
            out[p] = int(ps[i]) & 255
            continue
        p0 = max(int(po[i]), p // 1024 * 1024)
        d = p0 - int(ps[i])
        idx = int(pc[i]) + int(np.fmod(d, k)) + (p - p0)
        out[p] = lit[idx] if 0 <= idx < len(lit) else 0
    return out


def _hand_plan(seed: int, block: int = 8192):
    """Pieces over [0, block) whose sources stay inside a 3000-byte lit:
    periods that do not divide 1024 across window edges, s past p (a
    negative truncated phase) and fills (k = 1) whose c points at bytes
    that are not a run."""
    rng = np.random.default_rng(seed)
    cuts = np.unique(np.r_[0, rng.integers(1, block, 14), 1000, 2500])
    po = cuts.astype(np.int32)
    n = len(po)
    pk = rng.choice([1, 1, 3, 5, 7, 100, 333], n).astype(np.int32)
    pc = (pk + rng.integers(0, 800, n)).astype(np.int32)
    ps = (po + rng.integers(-400, 400, n)).astype(np.int32)
    lit = rng.integers(0, 256, 3000, dtype=np.uint8)
    return (po, pc, ps, pk), lit


@pytest.mark.parametrize("seed", range(4))
def test_hand_made_plans_equal_jax_and_oracle(seed):
    """Plans where the chunk-anchored phase and fill_from_s matter."""
    block = 8192
    plans = [_hand_plan(seed * 2 + j, block) for j in range(2)]
    pieces = [p for p, _ in plans]
    lits = [lf for _, lf in plans]
    totals = [block, block - 777]
    naive = []
    for (po, pc, ps, pk), lf in plans:
        r = np.repeat(np.arange(len(po)), np.diff(np.r_[po, block]))
        p = np.arange(block)
        naive.append(lf[pc[r] + (p - ps[r]) % pk[r]])
    for variant in (1, 2, 3):
        want = kernel_attic.decode_blocks(pieces, lits, totals, block,
                                          interpret=True, variant=variant)
        got = A.decode_blocks(pieces, lits, totals, block, device="cpu",
                              variant=variant)
        assert got == want
        for j in range(2):
            oracle = _loop_oracle(pieces[j], A.pack_blocks(
                pieces, lits, totals, block)[0][3][j].reshape(-1),
                totals[j], block, variant != 1)
            assert got[j] == oracle[:totals[j]].tobytes()
            # the chunk-anchored phase (and, for v2/v3, the fills) differ
            # from the resolver's contract on these plans
            assert got[j] != naive[j][:totals[j]].tobytes()


def test_plain_version_edges():
    """Bytes before the first piece and past totals read 0; a lit index
    outside the row reads 0; counts past pcs and totals past the block
    are clamped; fills take s & 255."""
    block = 2048
    pcs = np.zeros((2, 24, 128), np.int32)
    f = pcs.reshape(2, -1, 4)
    f[0, 0] = [100, 10 ** 6, 0, 2]        # reads past the lit row
    f[0, 1] = [1500, 0, -2, 1]            # a fill of s = -2
    f[1, :, 0] = np.arange(768) * 2       # 768 pieces, more than n says
    f[1, :, 1] = np.arange(768) % 50
    f[1, :, 2] = 7
    f[1, :, 3] = 3
    lit8 = np.random.default_rng(1).integers(0, 256, (2, 24, 128),
                                             dtype=np.uint8)
    npieces = np.array([2, 10 ** 6], np.int32)
    totals = np.array([1800, 10 ** 6], np.int32)
    t = [torch.from_numpy(a) for a in (npieces, totals, pcs, lit8)]
    for fill in (False, True):
        out = A.piece_serial(*t, block=block, fill_from_s=fill).numpy()
        assert not out[0, :1500].any() and not out[0, 1800:].any()
        if fill:
            assert (out[0, 1500:1800] == 254).all()
        for b in range(2):
            want = _loop_oracle(f[b, :min(int(npieces[b]), 768)].T,
                                lit8[b].reshape(-1),
                                min(int(totals[b]), block), block, fill)
            assert np.array_equal(out[b], want)


def test_serial_wrapper_checks_inputs():
    t = [torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
         torch.zeros((1, 24, 128), dtype=torch.int32),
         torch.zeros((1, 40, 128), dtype=torch.uint8)]
    with pytest.raises(TypeError):
        A.piece_serial(t[0], t[1], t[2].to(torch.int64), t[3], block=1024,
                 fill_from_s=True)
    with pytest.raises(ValueError):
        A.piece_serial(t[0], t[1][:0], t[2], t[3], block=1024,
                       fill_from_s=True)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.piece_serial(*meta, block=1024, fill_from_s=True)
    with pytest.raises(ValueError, match="piece starts decrease"):
        A.pack_groups([(np.array([0, 9, 5], np.int32),) * 4],
                      [np.zeros(4, np.uint8)], [10], 1024)
    with pytest.raises(NotImplementedError,
                       match="decode_blocks_v4.*attic_quad.decode_blocks_v12"):
        A.decode_blocks([], [], [], 1024, device="cpu", variant=4)


def test_bytes_moved_counts_pieces_lits_and_output():
    data, arc, do = _archive("l3", 4096)
    plan, pieces, lits = _resolved(arc, do)
    n = sum(len(p[0]) for p in pieces)
    assert A.bytes_moved(pieces, lits, 4096) == (
        8 * len(pieces) + 16 * n + sum(map(len, lits))
        + 4096 * len(pieces))


def test_attic_route_groups_and_errors():
    data, arc, do = _case("checksum", 4096)
    before = A.piece_serial.launches
    assert Z.ops.decompress(arc, _pdo(do), device="cpu", use_serial=True,
                            variant=2, dispatch=2) == data
    assert A.piece_serial.launches == before   # the plain version counts none
    groups = A.pack_groups(*_resolved(arc, do)[1:], JB.plan_frame(
        arc, do).totals, 4096, dispatch=2)
    assert len(groups) == -(-len(JB.plan_frame(arc, do).totals) // 2)
    bad = bytearray(arc)
    bad[len(bad) // 2] ^= 0x41
    with pytest.raises(Z.ZxcError) as e:
        Z.ops.decompress(bytes(bad), _pdo(DecodeOpts(checksum=True)),
                         device="cpu", use_serial=True, variant=1)
    with pytest.raises(JZxcError) as j:
        JB.plan_frame(bytes(bad), DecodeOpts(checksum=True))
    assert e.value.code == j.value.code
