"""The port's host block encoder and compression context against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through
``zxc_tpu.codec.block_encode`` / ``zxc_tpu.context.Cctx`` (with its native
library, got through ``jax_native``) and their counterparts in the port:
``encode_chunk`` from plaintext at levels 1-7, with and without a
dictionary and checksum, the branches of the level 6-7 parse (the
re-priced level-7 DP, the 8-bit-offset DP, level 6's deepening),
``Cctx.compress_block`` and ``Cctx.compress`` (seekable too), the native
matcher and parser bindings and the Huffman nudge. ``compress_device``'s
archives stay the JAX package's. Tolerance: exact equality everywhere.
"""
import numpy as np
import pytest

from zxc_tpu import context as jctx, ops as jops, runtime as jrt
from zxc_tpu.codec import block_encode as jbe, huffman as jhuf
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import constants as C, runtime as prt
from zxc_tpu_torch.codec import block_encode as pbe, huffman as phuf
from zxc_tpu_torch.format import headers as phdr
from zxc_tpu_torch.ops import encode as PE

from test_torch_jax_native import jax_native


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()
    assert jrt.available()


def _words(seed: int, n: int) -> bytes:
    """Word soup with repeats at many distances (offsets past 256), runs
    and a few random bytes: takes the level-7 re-priced DP and the
    8-bit-offset DP."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(300)]
    out = bytearray()
    while len(out) < n:
        r = rng.random()
        if r < 0.03:
            out += bytes([rng.integers(0, 256)]) * int(rng.integers(4, 300))
        elif r < 0.06:
            out += rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
        else:
            out += vocab[int(rng.zipf(1.3)) % len(vocab)] + b" "
    return bytes(out[:n])


def _corpus(name: str) -> bytes:
    rng = np.random.default_rng(5)
    n = 32768
    if name == "words":
        return _words(1, n)
    if name == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if name == "code":
        # a payload over 45% of the block at level 6: the deepening pass
        return (rng.integers(0, 256, n, dtype=np.uint8)
                & rng.integers(0, 256, n, dtype=np.uint8)
                & rng.integers(0, 256, n, dtype=np.uint8)).tobytes()
    if name == "near":
        return b"".join(rng.integers(0, 256, 8, dtype=np.uint8).tobytes() * 3
                        for _ in range(1400))[:n]
    assert name == "runs"
    return b"A" * 9000 + b"B" * 100 + _words(2, 12000) + b"C" * 4000


CORPORA = ["words", "random", "code", "near", "runs"]


def _dict_case(kind: str):
    """(body, content, 128-byte table or None). ``fitted``: a table fitted
    to a match-free literal soup, which wins the literal auction (enc_lit
    3); ``rows``: rows that match the dictionary content, no table."""
    content = (b"wire-format golden dictionary seed: common prefixes "
               b"<row id='000000'><field>abcdefgh</field></row>\n" * 12)[:1024]
    rng = np.random.default_rng(12)
    if kind == "fitted":
        letters = np.frombuffer(b"etaoinshrdlu zxcfmt", np.uint8)
        probs = 1.0 / np.arange(1, len(letters) + 1) ** 0.8
        soup = rng.choice(letters, size=3000, p=probs / probs.sum()).tobytes()
        cl = jhuf.build_code_lengths(np.bincount(np.frombuffer(
            soup, np.uint8), minlength=256), 8)
        return (soup * 3)[:8192], content, jhuf.pack_lengths(cl)
    rows = b"".join(b"<row id='%06d'><field>%s</field></row>\n"
                    % (int(i), bytes(rng.integers(97, 105, 8)
                                     .astype(np.uint8)))
                    for i in rng.integers(0, 10 ** 6, 300))
    return rows[:12000], content, None


def _enc_lit(block: bytes):
    bh = phdr.read_block_header(block, 0)
    if bh.block_type != C.BLOCK_GLO:
        return None
    return phdr.read_gnr_header(block[C.BLOCK_HEADER_SIZE:],
                                C.GLO_SECTIONS)[0].enc_lit


def _err(fn):
    try:
        fn()
    except (JZxcError, Z.ZxcError) as e:
        return e.code
    raise AssertionError("no ZxcError raised")


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("corpus", CORPORA)
def test_encode_chunk_equals_jax(corpus, level, checksum):
    arr = np.frombuffer(_corpus(corpus), np.uint8)
    got = pbe.encode_chunk(arr, level, None, checksum)
    assert got == jbe.encode_chunk(arr, level, None, checksum)
    assert Z.Dctx().decompress_block(
        got[:len(got) - 4 * checksum], len(arr)) == arr.tobytes()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("kind", ["fitted", "rows"])
def test_encode_chunk_dict_equals_jax(kind, level, checksum):
    body, content, huf = _dict_case(kind)
    arr = np.frombuffer(body, np.uint8)
    cnt = np.frombuffer(content, np.uint8)
    got = pbe.encode_chunk(arr, level, pbe.DictState(cnt, huf), checksum)
    assert got == jbe.encode_chunk(arr, level, jbe.DictState(cnt, huf),
                                   checksum)
    if kind == "fitted" and level >= 2:
        # the shared table wins the literal auction at every GLO level
        assert _enc_lit(got) == C.ENC_HUFFMAN_DICT
    dctx = Z.Dctx().attach_dict(content, huf)
    assert dctx.decompress_block(got[:len(got) - 4 * checksum],
                                 len(arr)) == body


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(prt, name)

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)
    monkeypatch.setattr(prt, name, spy)
    return calls


@pytest.mark.parametrize("level", [6, 7])
def test_only8_candidate_equals_jax(monkeypatch, level):
    """Offsets past 256 in the DP's parse: the 8-bit-offset DP competes,
    and at level 7 the parse re-priced with the token tree too."""
    arr = np.frombuffer(_corpus("words"), np.uint8)
    calls = _spy(monkeypatch, "optimal_parse")
    got = pbe.encode_chunk(arr, level)
    assert any(kw.get("only8") for kw in calls)
    assert any(kw.get("tok_cost16") is not None
               for kw in calls) == (level == 7)
    assert got == jbe.encode_chunk(arr, level)


def test_level6_deepening_equals_jax(monkeypatch):
    """A payload over 45% of the block reruns the level-6 parse at 3x the
    chain depth."""
    arr = np.frombuffer(_corpus("code"), np.uint8)
    probes = []
    orig = pbe._build_sequences

    def spy(*a, **kw):
        probes.append(kw.get("probes"))
        return orig(*a, **kw)
    monkeypatch.setattr(pbe, "_build_sequences", spy)
    got = pbe.encode_chunk(arr, 6, None, True)
    assert probes == [None, 3 * Z.codec.frame.level_params(6).n_candidates]
    assert got[:1] == bytes([C.BLOCK_GLO])
    assert got == jbe.encode_chunk(arr, 6, None, True)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
def test_cctx_compress_block_equals_jax(level):
    body, content, huf = _dict_case("fitted")
    body = body + _corpus("words")[:8192]
    for attach in (False, True):
        p = Z.Cctx(level=level, block_size=16384, checksum=True)
        j = jctx.Cctx(level=level, block_size=16384, checksum=True)
        if attach:
            p.attach_dict(content, huf)
            j.attach_dict(content, huf)
        assert p.compress_block(body) == j.compress_block(body)
        lv = 8 - level
        assert p.compress_block(body, lv) == j.compress_block(body, lv)


@pytest.mark.parametrize("seekable", [False, True])
@pytest.mark.parametrize("level", [2, 6])
def test_cctx_compress_equals_jax(level, seekable):
    data = _corpus("words") + _corpus("near") + _corpus("runs")
    body, content, huf = _dict_case("fitted")
    for attach in (False, True):
        p = Z.Cctx(level=level, block_size=16384, checksum=True,
                   seekable=seekable)
        j = jctx.Cctx(level=level, block_size=16384, checksum=True,
                      seekable=seekable)
        if attach:
            p.attach_dict(content, huf)
            j.attach_dict(content, huf)
        arc = p.compress(data)
        assert arc == j.compress(data)
        assert p.compress(data, level=7) == j.compress(data, level=7)
        assert Z.is_seekable(arc) == seekable
        opts = Z.DecodeOpts(checksum=True, dict_content=content if attach
                            else None, dict_huf=huf if attach else None)
        assert Z.decompress(arc, opts) == data


def test_cctx_errors_equal_jax():
    for lv in (0, 8):
        assert _err(lambda: Z.Cctx(level=lv)) == _err(
            lambda: jctx.Cctx(level=lv)) == Z.ERROR_BAD_LEVEL
        assert _err(lambda: Z.Cctx().compress(b"x", level=lv)) == _err(
            lambda: jctx.Cctx().compress(b"x", level=lv))
    big = b"d" * (C.DICT_SIZE_MAX + 1)
    assert _err(lambda: Z.Cctx().attach_dict(big)) == _err(
        lambda: jctx.Cctx().attach_dict(big)) == Z.ERROR_DICT_TOO_LARGE
    over = b"x" * 4097
    assert _err(lambda: Z.Cctx(block_size=4096).compress_block(over)) == \
        _err(lambda: jctx.Cctx(block_size=4096).compress_block(over))


def test_native_bindings_equal_jax():
    """The matcher, parser and fused emitter wrappers return the JAX
    package's arrays and bytes."""
    arr = np.frombuffer(_corpus("words"), np.uint8)
    body, content, huf = _dict_case("rows")
    full = np.frombuffer(content + body, np.uint8)
    cl = jhuf.build_code_lengths(np.bincount(arr, minlength=256) + 1, 8)
    for data, start in ((arr, 0), (full, len(content))):
        for args in ((5, False, 32, 1, 5, 4), (12, True, 96, 1, 0, 2)):
            for a, b in zip(prt.find_parse(data, start, *args),
                            jrt.find_parse(data, start, *args)):
                assert np.array_equal(a, b) and a.dtype == b.dtype
            assert prt.encode_ghi(data, start, *args) == \
                jrt.encode_ghi(data, start, *args)
            assert prt.encode_glo(data, start, *args, dict_cl=cl) == \
                jrt.encode_glo(data, start, *args, dict_cl=cl)
        lens, offs = prt.find_matches(data, start, 64)
        jl, jo = jrt.find_matches(data, start, 64)
        assert np.array_equal(lens, jl) and np.array_equal(offs, jo)
        for lazy in (False, True):
            for a, b in zip(prt.lazy_parse(lens, offs, lazy),
                            jrt.lazy_parse(lens, offs, lazy)):
                assert np.array_equal(a, b)
        blk = data[start:]
        cost = np.full(256, 7, np.uint16)
        tok16 = np.arange(16, dtype=np.uint16) % 7 + 3
        for kw in ({}, {"only8": True}, {"tok_cost16": tok16}):
            for a, b in zip(prt.optimal_parse(lens, offs, blk, cost, 5, **kw),
                            jrt.optimal_parse(lens, offs, blk, cost, 5,
                                              **kw)):
                assert np.array_equal(a, b)


def test_nudge_equals_jax():
    rng = np.random.default_rng(9)
    for alpha in (3, 40, 256):
        freq = np.zeros(256, np.int64)
        freq[:alpha] = rng.zipf(1.4, alpha)
        for cap in (8, 11):
            cl = phuf.build_code_lengths(freq, cap)
            assert phuf.encoded_bits(freq, cl) == jhuf.encoded_bits(freq, cl)
            assert np.array_equal(phuf.nudge_code_lengths(freq, cl, cap),
                                  jhuf.nudge_code_lengths(freq, cl, cap))


@pytest.mark.parametrize("checksum", [False, True])
def test_compress_device_archives_unchanged(checksum):
    """The device encoder's host emitter takes ``encode_chunk``'s new
    signature: its archives stay the JAX package's."""
    data = _corpus("words")[:20000] + _corpus("runs")[:12000]
    arc = PE.compress_device(data, level=3, block_size=16384, device="cpu",
                             checksum=checksum)
    assert arc == jops.compress_device(data, level=3, block_size=16384,
                                       checksum=checksum)
    assert Z.decompress(arc, Z.DecodeOpts(checksum=checksum)) == data
