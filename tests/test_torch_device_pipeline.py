"""End-to-end decode pipeline of the PyTorch port against the JAX package.

The same archives (made by ``zxc_tpu.codec.frame.compress`` from numpy
data with fixed seeds) go through ``zxc_tpu.ops.device_pipeline`` (Pallas
in interpret mode) and ``zxc_tpu_torch.ops.device_pipeline`` on the CPU
(the kernels' plain versions). Tolerance: exact equality of every walk
field, every prep buffer, the decoded bytes and the fingerprints.
"""
import numpy as np
import pytest

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.ops import device_pipeline as JDP
from zxc_tpu.ops.batch import plan_frame
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.codec import frame as pframe
from zxc_tpu_torch.ops import device_pipeline as PDP

from test_torch_jax_native import jax_native



@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()

BLOCK = 16384


def _mixed_body(seed: int, size: int) -> bytes:
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 256, 997, dtype=np.uint8).tobytes()
    body = (b"text " * 5000 + seg * 40 + b"\x00" * 20000 + b"ab" * 8000
            + b"".join(bytes(range(k)) * (3000 // k) for k in (3, 7, 13))
            + rng.integers(0, 256, 60000, dtype=np.uint8).tobytes())
    return (body * (size // len(body) + 1))[:size]


def _dict_case():
    from zxc_tpu.codec import dict_train
    rng = np.random.default_rng(7)
    samples = [(b"common prefix " + rng.integers(0, 96, 300, dtype=np.uint8)
                .tobytes()) for _ in range(50)]
    d = dict_train.dict_train(samples, target_size=4096)
    data = b"".join(samples)[:60_000]
    eo = EncodeOpts(level=3, block_size=BLOCK, dict_content=d.content,
                    dict_huf=d.huf_lengths)
    return data, eo, DecodeOpts(dict_content=d.content, dict_huf=d.huf_lengths)


# ---------------------------------------------------------------------------
# host layers: encoder and runtime copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
def test_compress_equals_jax(level):
    data = _mixed_body(level, 50_000)
    for ck in (False, True):
        a = pframe.compress(data, pframe.EncodeOpts(
            level=level, block_size=BLOCK, checksum=ck))
        b = jframe.compress(data, EncodeOpts(level=level, block_size=BLOCK,
                                             checksum=ck))
        assert a == b


def test_compress_with_dictionary_equals_jax():
    data, eo, _ = _dict_case()
    a = pframe.compress(data, pframe.EncodeOpts(
        level=3, block_size=BLOCK, dict_content=eo.dict_content,
        dict_huf=eo.dict_huf, threads=2))
    assert a == jframe.compress(data, eo)


@pytest.mark.parametrize("self_ref", [False, True])
def test_resolve_pieces_and_lane_ops_equal_jax(self_ref):
    arc = jframe.compress(_mixed_body(5, BLOCK * 3),
                          EncodeOpts(level=3, block_size=BLOCK))
    plan = plan_frame(arc)
    for i in range(plan.n_blocks):
        kw = dict(device_pure=True, max_frag=1, self_ref=self_ref)
        a = prt.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                               plan.lit[i], **kw)
        b = jrt.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                               plan.lit[i], **kw)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        for x, y in zip(prt.lane_ops(*a[:4], int(plan.totals[i])),
                        jrt.lane_ops(*b[:4], int(plan.totals[i]))):
            assert np.array_equal(x, y)
    if self_ref:
        assert prt.KOUT == jrt.KOUT


# ---------------------------------------------------------------------------
# walk and prep parity
# ---------------------------------------------------------------------------

def _walk_equal(arc, opts):
    a, b = PDP.walk_frame(arc, opts), JDP.walk_frame(arc, opts)
    assert a.block_size == b.block_size
    assert a.decompressed_size == b.decompressed_size
    for f in ("pos", "typ", "comp", "dict_buf", "dict_cl"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f
    return a, b


def _assert_prep_parity(arc, opts, variant, dispatch=4):
    pw, jw = _walk_equal(arc, opts)
    pp = PDP.DevicePipeline(pw, arc, dispatch=dispatch, variant=variant)
    jp = JDP.DevicePipeline(jw, arc, dispatch=dispatch, variant=variant)
    pp.size_shapes()
    jp.size_shapes()
    assert (pp.MAXQ, pp.RLP, pp.NG32) == (jp.MAXQ, jp.RLP, jp.NG32)
    for g in range(pp.n_groups):
        got, _ = pp.prep_group(g)
        want = JDP._alloc_group(dispatch, jp.NST, jp.MAXQ, jp.NG32, jp.RLP,
                                jp.K)
        for j in range(dispatch):
            i = g * dispatch + j
            if i < jw.n_blocks:
                jp._prep_into(i, want, j, jp.MAXQ, jp.NG32, jp.RLP)
        for name in ("qs", "qbase", "pctrl", "tq", "lit8", "totals"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), \
                (g, name)


@pytest.mark.parametrize("variant", [19, 26])
@pytest.mark.parametrize("level", [1, 3, 6])
def test_prep_buffers_equal_jax(level, variant):
    arc = jframe.compress(_mixed_body(11, BLOCK * 9 - 100),
                          EncodeOpts(level=level, block_size=BLOCK))
    _assert_prep_parity(arc, None, variant)


@pytest.mark.parametrize("variant", [19, 26])
def test_prep_buffers_equal_jax_dict_and_checksum(variant):
    data, eo, do = _dict_case()
    _assert_prep_parity(jframe.compress(data, eo), do, variant)
    arc = jframe.compress(_mixed_body(12, 65536 * 2 + 7),
                          EncodeOpts(level=7, block_size=65536,
                                     checksum=True))
    _assert_prep_parity(arc, DecodeOpts(checksum=True), variant, dispatch=2)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [19, 26])
def test_e2e_equals_plaintext_and_jax(variant):
    data = _mixed_body(42, BLOCK * 7 - 77)
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    out = Z.decompress_e2e(arc, device="cpu", dispatch=4, variant=variant)
    assert out == data
    assert out == JDP.decompress_e2e(arc, dispatch=4, interpret=True,
                                     variant=variant)
    fp = Z.decompress_e2e(arc, device="cpu", dispatch=4, variant=variant,
                          _collect="fingerprint")
    assert fp == JDP.decompress_e2e(arc, dispatch=4, interpret=True,
                                    variant=variant, _collect="fingerprint")
    assert fp[2:] == (7, len(data))


def test_e2e_default_variant_and_phases():
    data = _mixed_body(46, BLOCK * 3)
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    ph = {}
    assert Z.decompress_e2e(arc, device="cpu", _phases=ph) == data
    assert set(ph) == {"walk_size", "run", "collect", "total"}
    assert Z.decompress_e2e(arc, device="cpu", variant=27) == data


def test_e2e_checksummed_l6():
    data = _mixed_body(43, BLOCK * 7 - 13)
    arc = jframe.compress(data, EncodeOpts(level=6, block_size=BLOCK,
                                           checksum=True))
    assert Z.decompress_e2e(arc, DecodeOpts(checksum=True), device="cpu",
                            dispatch=4) == data


def test_e2e_dictionary_archive():
    data, eo, do = _dict_case()
    arc = jframe.compress(data, eo)
    for variant in (19, 26):
        assert Z.decompress_e2e(arc, do, device="cpu", dispatch=2,
                                variant=variant) == data
    with pytest.raises(Z.ZxcError) as e:
        Z.decompress_e2e(arc, device="cpu")
    with pytest.raises(JZxcError) as j:
        JDP.decompress_e2e(arc, interpret=True)
    assert e.value.code == j.value.code


def test_e2e_rejects_corruption_with_jax_codes():
    data = _mixed_body(44, BLOCK * 3)
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK,
                                           checksum=True))
    bad = bytearray(arc)
    bad[60] ^= 0x20
    cases = ((bytes(bad), DecodeOpts(checksum=True)),
             (arc[:len(arc) // 2], None), (arc[:20], None),
             (b"\x00" * 64, None))
    for blob, opts in cases:
        with pytest.raises(Z.ZxcError) as e:
            Z.decompress_e2e(blob, opts, device="cpu", dispatch=4)
        with pytest.raises(JZxcError) as j:
            JDP.decompress_e2e(blob, opts, dispatch=4, interpret=True)
        assert e.value.code == j.value.code


def test_e2e_shape_overflow_retry(monkeypatch):
    """Sizing from one run-length block undersizes the word-salad blocks
    behind it (their materialized pieces need ~4x the literal rows): the
    decode must grow the shapes and retry."""
    rng = np.random.default_rng(45)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    data = (b"a" * (BLOCK * 2)
            + b"".join(rng.choice(words, 20000).tolist())[:BLOCK * 4])
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    size_shapes, grow = PDP.DevicePipeline.size_shapes, PDP.DevicePipeline.grow
    grown = []
    monkeypatch.setattr(PDP.DevicePipeline, "size_shapes",
                        lambda self: size_shapes(self, sample=1))
    monkeypatch.setattr(PDP.DevicePipeline, "grow",
                        lambda self, o: grown.append(o) or grow(self, o))
    for variant in (19, 26):
        assert Z.decompress_e2e(arc, device="cpu", dispatch=2,
                                variant=variant) == data
    assert grown


def test_pool_reuse_zeroes_stale_literal_rows():
    """With two pool slots group 2 reuses group 0's buffers (a dense block
    with many literal rows before a run-length one): its literal window
    must still equal a fresh prep of the group."""
    rng = np.random.default_rng(47)
    data = (rng.integers(0, 256, BLOCK * 2, dtype=np.uint8).tobytes()
            + _mixed_body(47, BLOCK * 3) + b"z" * BLOCK)
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    w = PDP.walk_frame(arc)
    pipe = PDP.DevicePipeline(w, arc, dispatch=2, variant=26)
    pipe.size_shapes()
    import torch

    def consume(args, tot, g, carry):
        carry.append((args[0].clone(), args[4].clone()))
        return carry

    seen = pipe.run(consume, torch.device("cpu"), pools=2, carry=[])
    assert len(seen) == pipe.n_groups == 3
    for g, (qs, lit8) in enumerate(seen):
        fresh, _ = pipe.prep_group(g)
        assert np.array_equal(qs.numpy(), fresh.qs)
        assert np.array_equal(lit8.numpy(), fresh.lit8)


def test_e2e_rejects_unsupported_arguments(tmp_path):
    arc = jframe.compress(b"x" * 1000, EncodeOpts(level=3, block_size=BLOCK))
    with pytest.raises(FileNotFoundError):
        Z.decompress_e2e(arc, device="cpu", hint=str(tmp_path / "no.zxh"))
    with pytest.raises(ValueError):
        Z.decompress_e2e(arc, device="cpu", variant=25)
    with pytest.raises(ValueError):
        Z.decompress_e2e(arc, device="cpu", _collect="arrays")
    small = jframe.compress(b"y" * 9000, EncodeOpts(level=3,
                                                    block_size=8192))
    with pytest.raises(Z.ZxcError):
        Z.decompress_e2e(small, device="cpu")


def test_e2e_empty_archive():
    arc = jframe.compress(b"", EncodeOpts(level=3, block_size=BLOCK))
    assert Z.decompress_e2e(arc, device="cpu") == b""
    assert Z.decompress_e2e(arc, device="cpu", _collect="fingerprint") == \
        (0, 0, 0, 0)
