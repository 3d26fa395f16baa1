"""The port's push streams (``codec.pstream``) against the JAX package's,
on the CPU: the cases of ``tests/test_pstream.py`` held against the JAX
package's bytes, outputs a call at a time and error codes. One-byte
pushes, drain windows of 7 and 13, resume after a drained window,
truncation, sticky errors, input after the end, SEK passthrough, the
dictionary refused and empty input. Tolerance: exact equality.
"""
import numpy as np
import pytest

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe, pstream as jps
from zxc_tpu.codec.frame import EncodeOpts as JEncodeOpts
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch.codec import frame, pstream
from zxc_tpu_torch.codec.frame import DecodeOpts, EncodeOpts

from test_torch_jax_native import jax_native


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()
    assert jrt.available()


def _data(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 200, 677, dtype=np.uint8).tobytes()
    return (seg * (n // len(seg) + 1))[:n]


def _code(fn):
    try:
        fn()
    except (JZxcError, Z.ZxcError) as e:
        return e.code
    raise AssertionError("no ZxcError raised")


def _push(mod, data, chunk, drain, **kw):
    """CStream output a call at a time: pushes of ``chunk`` bytes into
    windows of ``drain``, then end() until finished."""
    cs = mod.CStream(**kw)
    outs = []
    for pos in range(0, len(data), chunk):
        produced, consumed = cs.compress(data[pos:pos + chunk], drain)
        assert consumed == len(data[pos:pos + chunk])
        outs.append(produced)
    while True:
        produced, _ = cs.compress(b"", drain)
        if not produced:
            break
        outs.append(produced)
    while not cs.finished:
        outs.append(cs.end(drain))
    return outs


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
def test_stream_compress_equals_jax_and_oneshot(level):
    data = _data(60_000, seed=level)
    got = pstream.stream_compress(data, level=level, block_size=8192,
                                  checksum=True)
    assert got == jps.stream_compress(data, level=level, block_size=8192,
                                      checksum=True)
    assert got == frame.compress(data, EncodeOpts(level=level,
                                                  block_size=8192,
                                                  checksum=True))
    assert got == Z.stream_compress(data, level, 8192, True)


def test_cstream_one_byte_pushes():
    data = _data(5000, seed=1)
    kw = dict(level=2, block_size=4096, checksum=True)
    outs = _push(pstream, data, 1, 1 << 30, **kw)
    assert outs == _push(jps, data, 1, 1 << 30, **kw)
    cs, jcs = pstream.CStream(**kw), jps.CStream(**kw)
    for i in range(len(data)):
        assert cs.compress(data[i:i + 1], 1 << 30) == \
            jcs.compress(data[i:i + 1], 1 << 30)
    tail = []
    while not cs.finished:
        tail.append(cs.end(7))   # drain windows of 7
        assert tail[-1] == jcs.end(7)
    assert jcs.finished
    arc = b"".join(outs)
    assert frame.decompress(arc, DecodeOpts(checksum=True)) == data


@pytest.mark.parametrize("drain", [7, 13])
def test_cstream_tiny_drain_windows(drain):
    data = _data(30_000, seed=2)
    kw = dict(level=1, block_size=4096)
    outs = _push(pstream, data, len(data), drain, **kw)
    assert outs == _push(jps, data, len(data), drain, **kw)
    assert all(len(o) <= drain for o in outs)
    assert frame.decompress(b"".join(outs)) == data


def test_cstream_resume_after_a_drained_window():
    """Nothing drained (a window of 0), then a push and drains of 999."""
    data = _data(40_000, seed=10)
    runs = []
    for mod in (pstream, jps):
        cs = mod.CStream(level=3, block_size=4096, checksum=True,
                         seekable=True)
        outs = [cs.compress(data[:25_000], 0)]
        outs.append(cs.compress(data[25_000:], 999))
        while not cs.finished:
            outs.append(cs.end(999))
        runs.append(outs)
    assert runs[0] == runs[1]
    assert runs[0][0] == (b"", 25_000)
    arc = b"".join(o if isinstance(o, bytes) else o[0] for o in runs[0])
    assert Z.is_seekable(arc)
    assert frame.decompress(arc, DecodeOpts(checksum=True)) == data


def _pull(mod, archive, chunk, drain, checksum):
    ds = mod.DStream(checksum)
    outs = []
    for pos in range(0, len(archive), chunk):
        outs.append(ds.decompress(archive[pos:pos + chunk], drain))
    while True:
        produced, n = ds.decompress(b"", drain)
        outs.append((produced, n))
        if not produced:
            break
    return outs, ds.finished


@pytest.mark.parametrize("chunk", [1, 7, 4096, None])
def test_dstream_roundtrip_chunked(chunk):
    data = _data(200_000, seed=3)
    archive = frame.compress(data, EncodeOpts(level=3, block_size=16384,
                                              checksum=True))
    chunk = chunk or len(archive)
    got, done = _pull(pstream, archive, chunk, 1 << 30, True)
    assert (got, done) == _pull(jps, archive, chunk, 1 << 30, True)
    assert done and b"".join(p for p, _ in got) == data


def test_dstream_drain_resume():
    data = _data(50_000, seed=4)
    archive = frame.compress(data, EncodeOpts(level=2, block_size=8192))
    runs = []
    for mod in (pstream, jps):
        ds = mod.DStream()
        outs = [ds.decompress(archive, 0)]          # feed all, drain nothing
        while True:
            produced, _ = ds.decompress(b"", 999)
            if not produced:
                break
            outs.append(produced)
        runs.append((outs, ds.finished))
    assert runs[0] == runs[1]
    assert runs[0][1] and b"".join(runs[0][0][1:]) == data


def test_dstream_truncation_detected():
    data = _data(20_000, seed=5)
    archive = frame.compress(data, EncodeOpts(level=1, block_size=4096))
    ds, jds = pstream.DStream(), jps.DStream()
    half = archive[:len(archive) // 2]
    assert ds.decompress(half, 1 << 30) == jds.decompress(half, 1 << 30)
    assert not ds.finished and not jds.finished
    for cut in (len(archive) - 4, len(archive) // 2, 10, 0):
        a = archive[:cut]
        assert _code(lambda: pstream.stream_decompress(a)) == \
            _code(lambda: jps.stream_decompress(a))


def test_dstream_seekable_passthrough():
    data = _data(60_000, seed=6)
    archive = frame.compress(data, EncodeOpts(level=3, block_size=4096,
                                              seekable=True, checksum=True))
    for chunk in (1333, 1 << 16):
        got = pstream.stream_decompress(archive, checksum=True, chunk=chunk)
        assert got == jps.stream_decompress(archive, checksum=True,
                                            chunk=chunk) == data
    assert Z.stream_decompress(archive, True) == data


@pytest.mark.parametrize("where", [40, "footer", "global"])
def test_dstream_sticky_error(where):
    """A corrupt payload byte, footer size or global hash: the same code,
    and every later call raises it again."""
    data = _data(20_000, seed=8)
    archive = bytearray(frame.compress(data, EncodeOpts(
        level=1, block_size=4096, checksum=True)))
    if where == "footer":
        archive[-12] ^= 0x01
    elif where == "global":
        archive[-1] ^= 0x01
    else:
        archive[where] ^= 0xFF
    codes = []
    for mod in (pstream, jps):
        ds = mod.DStream(checksum=True)
        first = _code(lambda: ds.decompress(bytes(archive), 1 << 30))
        again = _code(lambda: ds.decompress(b"more", 1 << 30))
        codes.append((first, again))
    assert codes[0] == codes[1] and codes[0][0] == codes[0][1]


def test_dstream_input_after_end_rejected():
    data = _data(5000, seed=9)
    archive = frame.compress(data, EncodeOpts(level=1, block_size=4096))
    codes = []
    for mod in (pstream, jps):
        ds = mod.DStream()
        ds.decompress(archive, 1 << 30)
        codes.append(_code(lambda: ds.decompress(b"extra", 1 << 30)))
    assert codes[0] == codes[1] == Z.ERROR_CORRUPT_DATA


def test_cstream_errors_equal_jax():
    for make in (lambda m: m.CStream(dict_content=b"dict bytes"),
                 lambda m: m.DStream(dict_content=b"dict bytes")):
        assert _code(lambda: make(pstream)) == _code(lambda: make(jps))
    # a block size off the powers of two: the JAX package raises numpy's
    # ValueError from its constants, the port ZxcError(BAD_BLOCK_SIZE)
    with pytest.raises(ValueError):
        jps.CStream(block_size=5000)
    assert _code(lambda: pstream.CStream(block_size=5000)) == \
        Z.ERROR_BAD_BLOCK_SIZE
    codes = []
    for mod in (pstream, jps):
        cs = mod.CStream()
        cs.end(1 << 30)
        codes.append(_code(lambda: cs.compress(b"late", 1 << 30)))
    assert codes[0] == codes[1] == Z.ERROR_BAD_HEADER
    # a dictionary frame is refused by the push decoder
    arc = frame.compress(b"abc" * 2000, EncodeOpts(
        block_size=4096, dict_content=b"some dictionary bytes"))
    assert arc == jframe.compress(b"abc" * 2000, JEncodeOpts(
        block_size=4096, dict_content=b"some dictionary bytes"))
    assert _code(lambda: pstream.stream_decompress(arc)) == \
        _code(lambda: jps.stream_decompress(arc)) == Z.ERROR_DICT_REQUIRED


def test_cstream_empty_input():
    outs = []
    for mod in (pstream, jps):
        cs = mod.CStream(level=3)
        assert cs.recommended_in_size() == C_BLOCK
        out = bytearray()
        while not cs.finished:
            out += cs.end(1 << 30)
        outs.append(bytes(out))
    assert outs[0] == outs[1]
    assert frame.decompress(outs[0]) == b""
    assert pstream.stream_decompress(outs[0]) == b""
    ds, jds = pstream.DStream(), jps.DStream()
    assert ds.recommended_out_size() == jds.recommended_out_size()
    assert ds.recommended_in_size() == jds.recommended_in_size()


C_BLOCK = Z.constants.BLOCK_SIZE_DEFAULT
