"""Serial route of the PyTorch port against the JAX package: the section
parse (``plan_frame`` and its native parsers), the numpy packers, the v13
kernel's plain version and ``ops.decompress(use_serial=True)``.

The same archives (made by ``zxc_tpu.codec.frame.compress`` from numpy
data with fixed seeds) go through ``zxc_tpu.ops`` (Pallas in interpret
mode) and ``zxc_tpu_torch.ops`` on the CPU (the kernels' plain
versions). Tolerance: exact equality of every plan field, every packed
array, the kernels' bytes (JAX's int32 output reduced mod 256), the
decoded bytes and the error codes.
"""
import numpy as np
import pytest

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe, huffman as jhuf
from zxc_tpu.codec import block_decode as jbd
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.format import varint as jvarint
from zxc_tpu.ops import batch as JB, pallas_decode as PD
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.codec import block_decode as pbd, huffman as phuf
from zxc_tpu_torch.codec import frame as pframe
from zxc_tpu_torch.format import varint as pvarint
from zxc_tpu_torch.ops import batch as PB, copy_engine as CE, serial as S

from test_torch_cuda import random_group
from test_torch_copy_engine import _loop_oracle
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


def _pdo(do):
    return (pframe.DecodeOpts(do.checksum, do.dict_content, do.dict_huf)
            if do else None)


def _dict_case(block: int):
    from zxc_tpu.codec import dict_train
    rng = np.random.default_rng(7)
    samples = [(b"common prefix " + rng.integers(0, 96, 300, dtype=np.uint8)
                .tobytes()) for _ in range(50)]
    d = dict_train.dict_train(samples, target_size=4096)
    data = b"".join(samples)[:40_000]
    eo = EncodeOpts(level=3, block_size=block, dict_content=d.content,
                    dict_huf=d.huf_lengths)
    return data, eo, DecodeOpts(dict_content=d.content, dict_huf=d.huf_lengths)


def _case(name: str, block: int = 8192):
    """(data, archive, decode opts)."""
    if name.startswith("l"):
        data = _mixed_body(int(name[1:]), block * 5 - 99)
        return data, jframe.compress(data, EncodeOpts(
            level=int(name[1:]), block_size=block)), None
    if name == "raw":     # incompressible: RAW blocks, and a run block
        rng = np.random.default_rng(8)
        data = rng.integers(0, 256, block * 3, dtype=np.uint8).tobytes() \
            + b"q" * block
        return data, jframe.compress(data, EncodeOpts(
            level=3, block_size=block)), None
    if name == "dict":
        data, eo, do = _dict_case(block)
        return data, jframe.compress(data, eo), do
    data = _mixed_body(9, block * 4 + 5)                   # "checksum"
    return data, jframe.compress(data, EncodeOpts(
        level=6, block_size=block, checksum=True)), DecodeOpts(checksum=True)


CASES = ["l1", "l2", "l3", "l4", "l5", "l6", "l7", "raw", "dict",
         "checksum"]


# ---------------------------------------------------------------------------
# section parse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plan_frame_equals_jax(name):
    data, arc, do = _case(name)
    a, b = PB.plan_frame(arc, _pdo(do)), JB.plan_frame(arc, do)
    assert a.block_size == b.block_size
    assert a.decompressed_size == b.decompressed_size == len(data)
    assert list(a.totals) == list(b.totals)
    for f in ("ll", "ml", "off", "lit"):
        x, y = getattr(a, f), getattr(b, f)
        assert len(x) == len(y) == a.n_blocks
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v), f
    assert (a.dict_buf is None) == (b.dict_buf is None)
    if name == "raw":
        walk = Z.ops.walk_frame(arc)
        assert (walk.typ == 0).any()


def _corruptions(arc: bytes):
    bad_hdr = bytearray(arc)
    bad_hdr[20] ^= 0x10                      # first block header (CRC8)
    return [arc[:len(arc) // 2], arc[:20], b"\x00" * 64, bytes(bad_hdr),
            arc[:-12] + (len(arc) * 9).to_bytes(8, "little") + arc[-4:]]


@pytest.mark.parametrize("name", ["l3", "checksum", "dict"])
def test_plan_frame_error_codes_equal_jax(name):
    data, arc, do = _case(name)
    blobs = _corruptions(arc)
    if name == "checksum":
        flip = bytearray(arc)
        flip[len(flip) // 2] ^= 0x41
        blobs.append(bytes(flip))
    if name == "dict":                       # no dictionary, another one
        blobs = [arc]
    for blob in blobs:
        opts = ([None, DecodeOpts(dict_content=b"other dictionary " * 9)]
                if name == "dict" else [do])
        for o in opts:
            with pytest.raises(Z.ZxcError) as e:
                PB.plan_frame(blob, _pdo(o))
            with pytest.raises(JZxcError) as j:
                JB.plan_frame(blob, o)
            assert e.value.code == j.value.code


def test_section_parsers_equal_jax():
    rng = np.random.default_rng(4)
    # varint chains: valid, truncated and with out-of-spec prefixes
    for trial in range(30):
        vals = rng.integers(0, 1 << 21, 40)
        from zxc_tpu.format.varint import varint_encode
        blob = np.frombuffer(b"".join(varint_encode(int(v)) for v in vals),
                             np.uint8)
        if trial % 3 == 1:
            blob = blob[:len(blob) - 2]
        if trial % 3 == 2:
            blob = blob.copy()
            blob[rng.integers(0, len(blob))] = 0xF0
        for count in (0, 1, 39, 40, 41):
            nat, ok = prt.varint_chain(blob, count)
            ref, rok = pvarint.varint_decode_array(blob, count)
            jref, jok = jvarint.varint_decode_array(blob, count)
            assert ok == rok == jok
            assert np.array_equal(ref, jref)
            if ok:
                assert np.array_equal(nat, ref)
    # RLE literal streams
    lit = np.frombuffer(b"aaaaaaaaaaaaaabcdefg" * 50 + bytes(range(200)),
                        np.uint8)
    from zxc_tpu.codec import block_encode
    stream = np.frombuffer(block_encode.encode_rle_literals(lit), np.uint8)
    assert np.array_equal(pbd.decode_rle_literals(stream, len(lit)), lit)
    for s, n in ((stream[:-3], len(lit)), (stream, len(lit) + 1),
                 (stream[:0], 5)):
        with pytest.raises(Z.ZxcError) as e:
            pbd.decode_rle_literals(s, n)
        with pytest.raises(JZxcError) as j:
            jbd.decode_rle_literals(s, n)
        assert e.value.code == j.value.code


def test_huffman_tables_equal_jax():
    rng = np.random.default_rng(5)
    lit = rng.zipf(1.4, 20000).clip(0, 255).astype(np.uint8)
    cl = jhuf.build_code_lengths(np.bincount(lit, minlength=256), 11)
    packed = jhuf.pack_lengths(cl)
    a, b = phuf.build_tree_packed(packed), jhuf.build_tree_packed(packed)
    assert np.array_equal(a.code_len, b.code_len)
    assert np.array_equal(a.codes, b.codes)
    payload = np.frombuffer(jhuf.encode_payload(lit, b), np.uint8)
    assert np.array_equal(phuf.decode_payload(payload, len(lit), a), lit)
    sec = np.concatenate([np.frombuffer(packed, np.uint8), payload])
    assert np.array_equal(phuf.decode_section(sec, len(lit)), lit)
    with pytest.raises(Z.ZxcError) as e:
        phuf.decode_section(sec[:len(sec) // 2], len(lit))
    with pytest.raises(JZxcError) as j:
        jhuf.decode_section(sec[:len(sec) // 2], len(lit))
    assert e.value.code == j.value.code
    bad_tables = [np.zeros(256, np.uint8), np.full(256, 9, np.uint8),
                  np.r_[np.array([2], np.uint8), np.zeros(255, np.uint8)],
                  np.r_[np.array([1, 2, 3], np.uint8),
                        np.zeros(253, np.uint8)]]
    for t in bad_tables:
        with pytest.raises(Z.ZxcError) as e:
            phuf.build_tree(t)
        with pytest.raises(JZxcError) as j:
            jhuf.build_tree(t)
        assert e.value.code == j.value.code


# ---------------------------------------------------------------------------
# packers and the v13 kernel
# ---------------------------------------------------------------------------

def _resolved(arc, do=None):
    plan = PB.plan_frame(arc, _pdo(do))
    pieces, lits = PB.resolve_serial(plan)
    return plan, pieces, lits


@pytest.mark.parametrize("name,block", [("l3", 4096), ("l6", 8192),
                                        ("dict", 8192), ("l3", 16384),
                                        ("raw", 16384)])
def test_packers_equal_jax(name, block):
    data, arc, do = _case(name, block)
    plan, pieces, lits = _resolved(arc, do)
    if block < 16384:
        a = S.pack_blocks_v12(pieces, lits, plan.totals, block, quad_align=2)
        b = PD.pack_blocks_v12(pieces, lits, plan.totals, block,
                               quad_align=2)
    else:
        a = S.pack_blocks_v19(pieces, lits, plan.totals, block, K=2)
        b = PD.pack_blocks_v19(pieces, lits, plan.totals, block, K=2)
        a = S.pad_v19_set(a, a[1].shape[1] + 32, a[4].shape[1] + 128)
        b = PD.pad_v19_set(b, b[1].shape[1] + 32, b[4].shape[1] + 128)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if block < 16384:
        assert np.array_equal(S.pad_v12_set(a, 64, 512)[2],
                              PD.pad_v12_set(b, 64, 512)[2])


@pytest.mark.parametrize("name,block", [("l3", 4096), ("l5", 8192),
                                        ("l1", 16384)])
def test_v13_equals_jax_on_packed_groups(name, block):
    data, arc, do = _case(name, block)
    plan, pieces, lits = _resolved(arc, do)
    for args in S.pack_groups(pieces, lits, plan.totals, block, True, 4):
        MAXQ, RLP = args[1].shape[1], args[4].shape[1]
        jout = np.asarray(PD.v13_kernel(block, MAXQ, RLP, True)(*args))
        port = CE.v13(*CE.group_from_numpy(*args)).numpy()
        assert np.array_equal(port, jout.astype(np.uint8))


@pytest.mark.parametrize("seed", [1, 2])
def test_v13_hand_built_matches_jax_and_oracle(seed):
    args = random_group(seed, B=2, NST=3, MAXQ=10, RLP=256, K=1,
                        self_ref=False, rows=32)
    jout = np.asarray(PD.v13_kernel(3 * 4096, 10, 256, True)(*args))
    assert jout.max() > 255            # the adds really collide and wrap
    port = CE.v13(*CE.group_from_numpy(*args)).numpy()
    assert np.array_equal(port, jout.astype(np.uint8))
    want = _loop_oracle(*args[:3], args[3].astype(np.int64), args[4], 1,
                        False, rows=32)
    assert np.array_equal(port, (want & 255).astype(np.uint8))


def test_v13_garbage_control_matches_oracle():
    args = random_group(3, B=2, NST=2, MAXQ=6, RLP=128, K=1,
                        self_ref=False, garbage=True, rows=32)
    port = CE.v13(*CE.group_from_numpy(*args)).numpy()
    want = _loop_oracle(*args[:3], args[3].astype(np.int64), args[4], 1,
                        False, rows=32)
    assert np.array_equal(port, (want & 255).astype(np.uint8))
    assert port.any()


def test_v13_wrapper_rejects_bad_inputs():
    qs, qbase, pctrl, tq, lit8 = CE.group_from_numpy(*random_group(
        4, B=1, NST=1, MAXQ=4, RLP=128, K=1, self_ref=False, rows=32))
    import torch
    with pytest.raises(TypeError):
        CE.v13(qs, qbase, pctrl, tq.to(torch.uint8), lit8)
    with pytest.raises(ValueError):
        CE.v13(qs, qbase, pctrl[:, :8], tq, lit8)


# ---------------------------------------------------------------------------
# ops.decompress(use_serial=True)
# ---------------------------------------------------------------------------

def _jax_serial(plan_j, block, variant):
    pieces, lits = [], []
    for i in range(plan_j.n_blocks):
        r = jrt.resolve_pieces(plan_j.ll[i], plan_j.ml[i], plan_j.off[i],
                               plan_j.lit[i], plan_j.dict_buf,
                               device_pure=True, max_frag=1)
        pieces.append(r[:4])
        lits.append(r[4])
    fn = PD.decode_blocks_v13 if variant == 13 else PD.decode_blocks_v19
    return b"".join(fn(pieces, lits, list(plan_j.totals), block,
                       interpret=True, dispatch=4))


@pytest.mark.parametrize("block", [4096, 8192, 16384])
@pytest.mark.parametrize("name", ["l3", "dict", "checksum"])
def test_serial_decompress_equals_jax_and_plaintext(name, block):
    data, arc, do = _case(name, block)
    ph = {}
    out = Z.ops.decompress(arc, _pdo(do), device="cpu", use_serial=True,
                           dispatch=4, _phases=ph)
    assert out == data
    assert set(ph) == {"plan", "resolve", "pack", "device", "total",
                       "route"} and ph["route"] == "serial"
    variant = 13 if block < 16384 else 19
    assert out == _jax_serial(JB.plan_frame(arc, do), block, variant)
    if block == 16384:       # v13 on request at 16 KiB too
        assert Z.ops.decompress(arc, _pdo(do), device="cpu", use_serial=True,
                                variant=13, dispatch=4) == data


def test_serial_empty_and_errors():
    arc = jframe.compress(b"", EncodeOpts(level=3, block_size=4096))
    assert Z.ops.decompress(arc, device="cpu", use_serial=True) == b""
    data, arc, do = _case("checksum", 4096)
    bad = bytearray(arc)
    bad[len(bad) // 2] ^= 0x41
    with pytest.raises(Z.ZxcError) as e:
        Z.ops.decompress(bytes(bad), _pdo(do), device="cpu", use_serial=True)
    with pytest.raises(JZxcError) as j:
        JB.plan_frame(bytes(bad), do)
    assert e.value.code == j.value.code


def test_serial_routes_not_ported_raise(monkeypatch):
    """The expansion route (use_serial=False), device entropy (the chase
    route) and the serial route's fall-through past the piece budget
    equal the JAX package; attic variants past 3 still raise."""
    data, arc, _ = _case("l3", 4096)
    ph = {}
    assert Z.ops.decompress(arc, device="cpu", use_serial=False,
                            _phases=ph) == JB.decompress(arc) == data
    assert ph["route"] == "pieces"
    ph = {}
    assert Z.ops.decompress(arc, device="cpu", device_entropy=True,
                            _phases=ph) \
        == JB.decompress(arc, device_entropy=True) == data
    assert ph["route"] == "chase"
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        Z.ops.decompress(arc, device="cpu", use_serial=True, variant=21)
    # a block over the resolver's piece budget: the serial route falls
    # through to the expansion route (the chase, as no block has pieces)
    for mod in (prt, jrt):
        monkeypatch.setattr(mod, "resolve_pieces", lambda *a, **k: None)
    ph = {}
    assert Z.ops.decompress(arc, device="cpu", use_serial=True,
                            _phases=ph) == data
    assert ph["route"] == "chase"
    assert JB.decompress(arc, use_serial=True) == data
