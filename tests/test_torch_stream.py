"""The port's multi-threaded file pipeline (``codec.stream``) and in-place
decode (``codec.frame.decompress_inplace``) against the JAX package's, on
the CPU: archives at 1 and 4 threads equal to the JAX package's and to the
one-shot encoder (a cold process too), decoded bytes, progress call lists,
``stream_get_decompressed_size``, ``compress_file`` / ``decompress_file``,
truncation and corruption codes, and the in-place decode into the one
bytearray with its ``DST_TOO_SMALL`` and bound-0 cases. Tolerance: exact
equality.
"""
import ctypes
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe, stream as jstream
from zxc_tpu.codec.frame import DecodeOpts as JDecodeOpts
from zxc_tpu.codec.frame import EncodeOpts as JEncodeOpts
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime
from zxc_tpu_torch.codec import frame, stream
from zxc_tpu_torch.codec.frame import DecodeOpts, EncodeOpts

from test_torch_jax_native import jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()
    assert jrt.available()


def _data(n=300_000, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 256, 1511, dtype=np.uint8).tobytes()
    words = rng.integers(97, 105, n // 3, dtype=np.uint8).tobytes()
    return ((seg * (n // len(seg) + 1))[:n - len(words)] + words)


def _dict():
    content = (b"<row id='000000'><field>abcdefgh</field></row>\n" * 30)
    return content[:1200]


def _code(fn):
    try:
        fn()
    except (JZxcError, Z.ZxcError) as e:
        return e.code
    raise AssertionError("no ZxcError raised")


def _both_opts(**kw):
    return EncodeOpts(**kw), JEncodeOpts(**kw)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", ["l3-checksum", "l6-seekable", "l2-dict"])
def test_stream_compress_equals_jax_and_oneshot(case, threads):
    data = _data(seed=len(case))
    kw = {"l3-checksum": dict(level=3, block_size=16384, checksum=True),
          "l6-seekable": dict(level=6, block_size=32768, seekable=True,
                              checksum=True),
          "l2-dict": dict(level=2, block_size=16384,
                          dict_content=_dict())}[case]
    popts, jopts = _both_opts(**kw)
    comp = io.BytesIO()
    n = stream.stream_compress(io.BytesIO(data), comp, popts, threads)
    assert n == comp.tell()
    jcomp = io.BytesIO()
    jstream.stream_compress(io.BytesIO(data), jcomp, jopts, threads)
    assert comp.getvalue() == jcomp.getvalue() == frame.compress(data, popts)
    dopts = DecodeOpts(checksum=True, dict_content=kw.get("dict_content"))
    out = io.BytesIO()
    produced = stream.stream_decompress(io.BytesIO(comp.getvalue()), out,
                                        dopts, threads)
    assert produced == len(data) and out.getvalue() == data


def test_threads_write_the_same_bytes_from_a_cold_process(tmp_path):
    """Four workers race the first use of a native library that is not
    built yet (a fresh build directory): the archive must equal the one
    thread's."""
    data = _data(200_000, seed=31)
    opts = EncodeOpts(level=1, block_size=16384, checksum=True)
    want = io.BytesIO()
    stream.stream_compress(io.BytesIO(data), want, opts, 1)
    script = (
        "import io, sys\n"
        "sys.path.insert(0, %r)\n"
        "from zxc_tpu_torch import buildlib\n"
        "buildlib.BUILD_DIR = %r\n"
        "from zxc_tpu_torch.codec import stream\n"
        "from zxc_tpu_torch.codec.frame import EncodeOpts\n"
        "buf = io.BytesIO()\n"
        "stream.stream_compress(io.BytesIO(sys.stdin.buffer.read()), buf,\n"
        "    EncodeOpts(level=1, block_size=16384, checksum=True), 4)\n"
        "sys.stdout.buffer.write(buf.getvalue())\n"
        % (ROOT, str(tmp_path / "build")))
    r = subprocess.run([sys.executable, "-c", script], input=data,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert list((tmp_path / "build").glob("libzxchost-*.so"))
    assert r.stdout == want.getvalue()


@pytest.mark.parametrize("threads", [1, 4])
def test_progress_calls_equal_jax(threads):
    data = _data(100_000, seed=11)
    popts, jopts = _both_opts(level=2, block_size=16384)
    calls, jcalls = [], []
    buf, jbuf = io.BytesIO(), io.BytesIO()
    stream.stream_compress(io.BytesIO(data), buf, popts, threads,
                           progress=lambda d, t: calls.append((d, t)),
                           total_bytes=len(data))
    jstream.stream_compress(io.BytesIO(data), jbuf, jopts, threads,
                            progress=lambda d, t: jcalls.append((d, t)),
                            total_bytes=len(data))
    assert calls == jcalls and buf.getvalue() == jbuf.getvalue()
    assert len(calls) == -(-len(data) // 16384) and calls[-1][0] == len(data)
    dcalls, jdcalls = [], []
    out = io.BytesIO()
    stream.stream_decompress(io.BytesIO(buf.getvalue()), out, None, threads,
                             progress=lambda d, t: dcalls.append((d, t)),
                             total_bytes=7)
    jstream.stream_decompress(io.BytesIO(buf.getvalue()), io.BytesIO(), None,
                              threads,
                              progress=lambda d, t: jdcalls.append((d, t)),
                              total_bytes=7)
    assert dcalls == jdcalls and dcalls[-1] == (len(data), 7)
    assert out.getvalue() == data


def test_stream_get_decompressed_size_equals_jax():
    data = _data(50_000, seed=3)
    arc = frame.compress(data, EncodeOpts(level=1))
    f = io.BytesIO(arc)
    f.seek(5)
    assert stream.stream_get_decompressed_size(f) == len(data)
    assert f.tell() == 5
    assert Z.stream_get_decompressed_size(io.BytesIO(arc)) == \
        jstream.stream_get_decompressed_size(io.BytesIO(arc))
    assert _code(lambda: stream.stream_get_decompressed_size(
        io.BytesIO(arc[:20]))) == _code(
        lambda: jstream.stream_get_decompressed_size(io.BytesIO(arc[:20])))


@pytest.mark.parametrize("threads", [1, 2])
def test_truncation_and_corruption_codes_equal_jax(threads):
    data = _data(100_000, seed=4)
    arc = frame.compress(data, EncodeOpts(level=1, block_size=16384,
                                          checksum=True))
    assert arc == jframe.compress(data, JEncodeOpts(level=1,
                                                    block_size=16384,
                                                    checksum=True))
    bad = bytearray(arc)
    bad[60] ^= 0x20
    foot = bytearray(arc)
    foot[-12] ^= 0x01
    cases = [(arc[:cut], False) for cut in (len(arc) // 2, len(arc) - 4,
                                            len(arc) - 13, 17, 3)]
    cases += [(bytes(bad), True), (bytes(foot), False)]
    for a, ck in cases:
        got = _code(lambda: stream.stream_decompress(
            io.BytesIO(a), io.BytesIO(), DecodeOpts(checksum=ck), threads))
        want = _code(lambda: jstream.stream_decompress(
            io.BytesIO(a), io.BytesIO(), JDecodeOpts(checksum=ck), threads))
        assert got == want
    dict_arc = frame.compress(data, EncodeOpts(dict_content=_dict()))
    for opts in (None, DecodeOpts(dict_content=b"another dictionary")):
        jopts = None if opts is None else JDecodeOpts(
            dict_content=opts.dict_content)
        assert _code(lambda: stream.stream_decompress(
            io.BytesIO(dict_arc), io.BytesIO(), opts)) == _code(
            lambda: jstream.stream_decompress(io.BytesIO(dict_arc),
                                              io.BytesIO(), jopts))


def test_compress_file_and_decompress_file_equal_jax(tmp_path):
    data = _data(120_000, seed=7)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    popts, jopts = _both_opts(level=3, block_size=16384, checksum=True)
    n = Z.compress_file(str(src), str(tmp_path / "p.zxc"), popts, 2)
    jstream.compress_file(str(src), str(tmp_path / "j.zxc"), jopts, 2)
    assert (tmp_path / "p.zxc").read_bytes() == \
        (tmp_path / "j.zxc").read_bytes()
    assert n == os.path.getsize(tmp_path / "p.zxc")
    assert Z.decompress_file(str(tmp_path / "p.zxc"), str(tmp_path / "out"),
                             DecodeOpts(checksum=True), 2) == len(data)
    assert (tmp_path / "out").read_bytes() == data


def test_decompress_inplace_in_the_same_bytearray(monkeypatch):
    """One native call, reading the archive at the bytearray's own
    flush-right address and writing at its start, with the buffer's export
    held through the call; every out-of-place decoder raises here."""
    def out_of_place(*a, **k):
        raise AssertionError("out-of-place decode")

    monkeypatch.setattr(frame, "decompress", out_of_place)
    monkeypatch.setattr(runtime, "decompress_frame", out_of_place)
    monkeypatch.setattr(runtime, "decode_block", out_of_place)
    native = runtime.lib().zxch_decompress_frame
    calls = []

    def spy(src, comp_size, *rest):
        n = len(buf)
        addr = ctypes.addressof((ctypes.c_uint8 * n).from_buffer(buf))
        try:
            buf.extend(b"\0")
        except BufferError:
            resized = False
        else:
            resized = True
            del buf[n:]
        calls.append((src - addr, comp_size, rest[-2] - addr, rest[-1],
                      resized))
        if resized:  # the decoder would write into a freed buffer
            raise AssertionError("bytearray export not held")
        return native(src, comp_size, *rest)

    monkeypatch.setattr(runtime.lib(), "zxch_decompress_frame", spy)
    data = _data(150_000, seed=5)
    for kw in (dict(level=3, block_size=16384, checksum=True),
               dict(level=6, block_size=4096, seekable=True),
               dict(level=2, block_size=16384, dict_content=_dict())):
        arc = frame.compress(data, EncodeOpts(**kw))
        bound = Z.decompress_inplace_bound(arc)
        assert bound == jframe.decompress_inplace_bound(arc) >= len(data)
        buf = bytearray(bound)
        buf[bound - len(arc):] = arc
        calls.clear()
        opts = DecodeOpts(checksum=True, dict_content=kw.get("dict_content"))
        assert Z.decompress_inplace(buf, len(arc), opts) == len(data)
        # src = base + len(buf) - comp_size, dst = base, capacity = len(buf)
        assert calls == [(bound - len(arc), len(arc), 0, bound, False)]
        assert len(buf) == bound
        assert bytes(buf[:len(data)]) == data


def test_decompress_inplace_errors_equal_jax():
    data = _data(60_000, seed=6)
    arc = frame.compress(data, EncodeOpts(level=3, block_size=16384,
                                          checksum=True))

    def both(make, comp_size, opts=None, jopts=None):
        buf, jbuf = make(), make()
        return (_code(lambda: frame.decompress_inplace(buf, comp_size, opts)),
                _code(lambda: jframe.decompress_inplace(jbuf, comp_size,
                                                        jopts)))

    def flush_right(n, a=arc):
        def make():
            buf = bytearray(n)
            buf[n - len(a):] = a
            return buf
        return make

    # no margin
    got, want = both(flush_right(len(data) + 16), len(arc))
    assert got == want == Z.ERROR_DST_TOO_SMALL
    # one byte short of the bound
    got, want = both(flush_right(Z.decompress_inplace_bound(arc) - 1),
                     len(arc))
    assert got == want == Z.ERROR_DST_TOO_SMALL
    # comp_size past the buffer, and below header + footer
    bound = Z.decompress_inplace_bound(arc)
    assert both(flush_right(bound), bound + 1) == (Z.ERROR_SRC_TOO_SMALL,) * 2
    assert both(flush_right(bound), 20) == (Z.ERROR_SRC_TOO_SMALL,) * 2
    # a flipped payload byte with checksums on
    bad = bytearray(arc)
    bad[60] ^= 0x20
    got, want = both(flush_right(bound, bytes(bad)), len(arc),
                     DecodeOpts(checksum=True), JDecodeOpts(checksum=True))
    assert got == want == Z.ERROR_BAD_CHECKSUM
    # a dictionary frame without its dictionary
    darc = frame.compress(data, EncodeOpts(dict_content=_dict()))
    dbound = Z.decompress_inplace_bound(darc)
    assert both(flush_right(dbound, darc), len(darc)) == \
        (Z.ERROR_DICT_REQUIRED,) * 2
    # bound 0 on what is not an archive
    for junk in (b"not an archive at all!", b"", arc[:10]):
        assert Z.decompress_inplace_bound(junk) == \
            jframe.decompress_inplace_bound(junk) == 0
