"""The default device decode route of the PyTorch port against the JAX
package: the expansion (``ops/expand.py``: ``expand_kernel`` with and
without a dictionary, ``pieces_kernel``), ``decode_plan_device`` and
``ops.decompress`` on its pieces and chase routes.

The same inputs go through both packages on the CPU: archives made by
``zxc_tpu.codec.frame.compress`` from numpy data with fixed seeds, the
padded batches the JAX package's ``_pad_batch`` / ``_pad_piece_batch``
build, and crafted plans (made with numpy) that set each error bit, drop
a scatter past the block and wrap the int32 sums. Tolerance: exact
equality of bytes, totals, error bits and ``ZxcError`` codes.
"""
import os

import numpy as np
import pytest
import torch

from zxc_tpu.codec import frame as jframe
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.ops import batch as JB, expand as JE
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch.ops import batch as PB, expand as PE

from test_torch_jax_native import jax_native
from test_torch_serial import _case, _dict_case, _pdo

FUZZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fuzz_corpus")


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(jax_out, port_out):
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        p = p.numpy()
        assert j.shape == p.shape and np.array_equal(j, p)


def _expand_both(host, block, dict_buf=None, dict_len=0):
    has_dict = dict_buf is not None
    jargs, pargs = tuple(host), _t(host)
    if has_dict:
        jargs += (JE.pad_dict(dict_buf), np.int32(dict_len))
        pargs += [PE.pad_dict(dict_buf), dict_len]
    j = JE.expand_kernel(block, has_dict)(*jargs)
    p = PE.expand_kernel(block, has_dict)(*pargs)
    assert p[0].dtype == torch.uint8 and p[1].dtype == p[2].dtype \
        == torch.int32
    _equal(j, p)
    return p


# ---------------------------------------------------------------------------
# the expansion on the batches the JAX package pads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,block", [("l1", 4096), ("l5", 8192),
                                        ("raw", 16384), ("dict", 8192)])
def test_expand_and_pieces_on_jax_padded_batches(name, block):
    data, arc, do = _case(name, block)
    plan = JB.plan_frame(arc, do)
    plan.resolve()
    assert plan.all_pieces
    Bsz = JB._pow2(min(4, plan.n_blocks), lo=4)
    S, L = JB._pow2(plan.max_seq), JB._pow2(plan.max_lit)
    P = JB._pow2(plan.max_pieces)
    LP = JB._pow2(max(len(p[4]) for p in plan.pieces))
    got = []
    for base in range(0, plan.n_blocks, Bsz):
        idx = range(base, min(base + Bsz, plan.n_blocks))
        out, total, err = _expand_both(
            JB._pad_batch(plan, idx, S, L, B=Bsz), block, plan.dict_buf,
            plan.dict_len)
        assert not err.any()
        assert total.numpy()[:len(idx)].tolist() == plan.totals[base:base
                                                                + len(idx)]
        host = JB._pad_piece_batch(plan, idx, P, LP, B=Bsz)
        pout = PE.pieces_kernel(block)(*_t(host))
        assert np.array_equal(pout.numpy(),
                              np.asarray(JE.pieces_kernel(block)(*host)))
        assert torch.equal(pout, out)
        got += [out[j, :plan.totals[i]].numpy().tobytes()
                for j, i in enumerate(idx)]
    assert b"".join(got) == data


# ---------------------------------------------------------------------------
# crafted plans: error bits, dropped scatters, int32 wrap
# ---------------------------------------------------------------------------

def _plan(rows, S=8, L=64, lit_seed=0):
    """(ll, ml, off, lit, n_seq, lit_len) from rows of
    (ll list, ml list, off list, lit_len)."""
    B = len(rows)
    ll = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    off = np.ones((B, S), np.int32)
    n_seq = np.zeros(B, np.int32)
    lit_len = np.zeros(B, np.int32)
    for b, (a, m, o, n) in enumerate(rows):
        k = len(a)
        ll[b, :k] = np.array(a, np.int64).astype(np.int32)
        ml[b, :k] = np.array(m, np.int64).astype(np.int32)
        off[b, :k] = np.array(o, np.int64).astype(np.int32)
        n_seq[b] = k
        lit_len[b] = n
    lit = np.random.default_rng(lit_seed).integers(0, 256, (B, L),
                                                   dtype=np.uint8)
    return ll, ml, off, lit, n_seq, lit_len


BIG = (1 << 31) - 10

CRAFTED = {
    "valid": ([3, 0, 2], [5, 9, 6], [2, 1, 7], 6),
    "offset_out_of_window": ([3], [5], [1000], 3),                   # bit 4
    "literals_exhausted": ([10, 2], [5, 5], [1, 1], 5),              # bit 1
    "total_over_block": ([2], [300], [1], 2),                        # bit 2
    "out_start_past_block": ([1, 2, 3], [290, 5, 5], [1, 2, 3], 6),  # drop
    "ml_sums_wrap": ([1, 1, 1], [BIG, BIG, 7], [1, 2, 3], 3),
    "ll_sums_wrap": ([BIG, BIG, 2], [5, 5, 5], [1, 1, 1], 40),
    "negative_fields": ([-5, 3], [-70, 6], [-4, 0], -3),
    "no_sequences_trailing": ([], [], [], 50),
}


@pytest.mark.parametrize("has_dict", [False, True])
@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_expand_crafted_plans_equal_jax(name, has_dict):
    block = 256
    host = _plan([CRAFTED[name], CRAFTED["valid"]])
    d = np.frombuffer(b"dictionary bytes " * 9, np.uint8) if has_dict \
        else None
    out, total, err = _expand_both(host, block, d, 0 if d is None else len(d))
    want = {"offset_out_of_window": 4, "literals_exhausted": 1,
            "total_over_block": 2, "out_start_past_block": 2}.get(name)
    if want is not None:
        assert int(err[0]) & want
    if name in ("valid", "no_sequences_trailing"):
        assert int(err[0]) == 0
    assert int(err[1]) == 0


@pytest.mark.parametrize("seed", range(6))
def test_expand_random_garbage_equals_jax(seed):
    """Any int32 fields, counts past S and below 0: no index error, and
    JAX's bytes, totals and error bits."""
    rng = np.random.default_rng(seed)
    B, S, L, block = 4, 16, 32, 512
    big = rng.random() < 0.5
    hi = 1 << 31 if big else 400
    ll = rng.integers(-hi // 8 if big else 0, hi, (B, S)).astype(np.int32)
    ml = rng.integers(-hi // 8 if big else 0, hi, (B, S)).astype(np.int32)
    off = rng.integers(-3, 600, (B, S)).astype(np.int32)
    lit = rng.integers(0, 256, (B, L)).astype(np.uint8)
    n_seq = rng.integers(-2, S + 3, B).astype(np.int32)
    lit_len = rng.integers(-5, L + 40, B).astype(np.int32)
    host = (ll, ml, off, lit, n_seq, lit_len)
    _expand_both(host, block)
    d = rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8)
    _expand_both(host, block, d, int(rng.integers(-5, 400)))


@pytest.mark.parametrize("seed", range(4))
def test_pieces_crafted_plans_equal_jax(seed):
    """Piece tables out of order, past the block and below 0, k <= 0,
    counts past P and below 0, totals past the block."""
    rng = np.random.default_rng(100 + seed)
    B, P, L, block = 4, 16, 64, 512
    po = np.sort(rng.integers(0, block, (B, P)), axis=1).astype(np.int32)
    po[:, 0] = 0
    if seed % 2:
        po = rng.integers(-700, 1200, (B, P)).astype(np.int32)
    pc = rng.integers(-10 if seed else 0, 2 * L, (B, P)).astype(np.int32)
    ps = rng.integers(-1000, 1000, (B, P)).astype(np.int32)
    pk = rng.integers(-2, 40, (B, P)).astype(np.int32)
    lit = rng.integers(0, 256, (B, L)).astype(np.uint8)
    n_pieces = rng.integers(-1, P + 3, B).astype(np.int32)
    totals = rng.integers(-4, block + 50, B).astype(np.int32)
    host = (po, pc, ps, pk, lit, n_pieces, totals)
    got = PE.pieces_kernel(block)(*_t(host))
    assert np.array_equal(got.numpy(),
                          np.asarray(JE.pieces_kernel(block)(*host)))


def test_pad_dict_equals_jax():
    for d in (None, np.zeros(0, np.uint8),
              np.frombuffer(b"some dictionary", np.uint8)):
        assert np.array_equal(PE.pad_dict(d).numpy(),
                              np.asarray(JE.pad_dict(d)))


# ---------------------------------------------------------------------------
# decode_plan_device and ops.decompress against the JAX package
# ---------------------------------------------------------------------------

def _both(arc, do=None, **kw):
    """(port outcome, JAX outcome, port phases): bytes, or the ZxcError
    code."""
    ph = {}
    try:
        a = Z.ops.decompress(arc, _pdo(do), device="cpu", _phases=ph, **kw)
    except Z.ZxcError as e:
        a = e.code
    try:
        b = JB.decompress(arc, do, **kw)
    except JZxcError as e:
        b = e.code
    return a, b, ph


@pytest.mark.parametrize("level", range(1, 8))
def test_decompress_levels_with_checksums(level):
    data = _case(f"l{level}", 4096)[0]
    arc = jframe.compress(data, EncodeOpts(level=level, block_size=4096,
                                           checksum=True))
    a, b, ph = _both(arc, DecodeOpts(checksum=True))
    assert a == b == data
    assert ph["route"] == "pieces"
    assert set(ph) == {"plan", "resolve", "pad", "device", "total", "route"}


def _off1_heavy(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(60):
        parts.append(bytes([int(rng.integers(0, 256))])
                     * int(rng.integers(5, 3000)))
        parts.append(rng.integers(0, 256, int(rng.integers(0, 40)),
                                  dtype=np.uint8).tobytes())
    return b"".join(parts)


def _deep_chains(seed: int) -> bytes:
    """Each 100-byte unit is the previous one with one byte changed, so
    every match reads the match before it: chains as deep as the block."""
    rng = np.random.default_rng(seed)
    unit = bytearray(rng.integers(0, 256, 100, dtype=np.uint8).tobytes())
    out = []
    for _ in range(600):
        unit[int(rng.integers(0, 100))] = int(rng.integers(0, 256))
        out.append(bytes(unit))
    return b"".join(out)


@pytest.mark.parametrize("use_pieces", [True, False])
@pytest.mark.parametrize("kind,block", [("off1", 32768), ("deep", 16384),
                                        ("dict", 8192)])
def test_decompress_shapes_equal_jax(kind, block, use_pieces):
    do = None
    if kind == "off1":
        data = _off1_heavy(3)
        eo = EncodeOpts(level=2, block_size=block)
    elif kind == "deep":
        data = _deep_chains(4)
        eo = EncodeOpts(level=5, block_size=block)
    else:
        data, eo, do = _dict_case(block)
    arc = jframe.compress(data, eo)
    a, b, ph = _both(arc, do, use_pieces=use_pieces)
    assert a == b == data
    assert ph["route"] == ("pieces" if use_pieces else "chase")


@pytest.mark.parametrize("data", [b"", b"a", b"abc", b"0123456789",
                                  b"ab" * 40])
def test_decompress_empty_and_tiny_frames(data):
    for block in (4096, 65536):
        arc = jframe.compress(data, EncodeOpts(level=3, block_size=block))
        for kw in ({}, dict(use_pieces=False)):
            a, b, _ = _both(arc, **kw)
            assert a == b == data
        assert Z.ops.decompress(arc, device="cpu", use_serial=True) == data


def test_plan_with_one_unresolved_block_takes_the_chase_route():
    data, arc, do = _case("l3", 4096)
    plans = (PB.plan_frame(arc), JB.plan_frame(arc))
    for plan in plans:
        plan.resolve()
        assert plan.all_pieces
        plan.pieces[1] = None
        assert not plan.all_pieces
    ph = {}
    a = PB.decode_plan_device(plans[0], batch=2, device="cpu", _phases=ph)
    assert a == JB.decode_plan_device(plans[1], batch=2) == data
    assert set(ph) == {"pad", "device"}


def test_chase_size_disagreement_raises_like_jax():
    data, arc, do = _case("l3", 4096)
    codes = []
    for mod in (PB, JB):
        plan = mod.plan_frame(arc)
        plan.pieces = [None] * plan.n_blocks
        plan.totals[2] += 1
        with pytest.raises((Z.ZxcError, JZxcError)) as e:
            mod.decode_plan_device(plan, batch=4, **(
                {"device": "cpu"} if mod is PB else {}))
        codes.append((e.value.code, str(e.value)))
    assert codes[0] == codes[1]


def test_fuzz_corpus_subset_equals_jax():
    names = sorted(os.listdir(FUZZ))
    pick = np.random.default_rng(7).choice(len(names), 12, replace=False)
    for i in sorted(pick):
        with open(os.path.join(FUZZ, names[i]), "rb") as f:
            blob = f.read()
        a, b, _ = _both(blob, DecodeOpts(checksum=True))
        assert a == b, names[i]
