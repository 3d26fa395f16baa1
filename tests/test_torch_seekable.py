"""Seekable archives in the PyTorch port against the JAX package:
``zxc_tpu_torch.codec.seekable`` (``Seekable``, ``is_seekable``) against
``zxc_tpu.codec.seekable`` on archives made with ``seekable=True`` by
``zxc_tpu.codec.frame.compress`` from numpy data with fixed seeds.

Every query (header, sizes, SEK entries and offsets, block and range
lookups), every decode (``decompress_block``, ``decompress_range``,
``decompress_range_mt`` and ``decompress_range_device`` on the CPU) and
the error codes of a corrupt SEK table, a truncated archive, a flipped
payload byte and a missing or wrong dictionary. Tolerance: exact
equality of values, bytes and ``ZxcError`` codes.
"""
import numpy as np
import pytest

from zxc_tpu.codec import frame as jframe, seekable as JS
from zxc_tpu.codec.frame import EncodeOpts
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch.codec import seekable as PS

from test_torch_jax_native import jax_native
from test_torch_serial import _dict_case, _mixed_body


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _outcome(fn):
    try:
        return fn()
    except (Z.ZxcError, JZxcError) as e:
        return ("ZxcError", e.code)


def _pair(arc):
    """(port, JAX) Seekable of ``arc``, or their equal error codes."""
    a = _outcome(lambda: PS.Seekable.open_bytes(arc))
    b = _outcome(lambda: JS.Seekable.open_bytes(arc))
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert a == b
        return None
    return a, b


def _archive(name: str):
    if name == "dict":
        data, eo, do = _dict_case(4096)
        eo.seekable = True
        return data, jframe.compress(data, eo), do
    block = {"l1": 4096, "l3": 8192, "l5": 16384, "checksum": 4096}[name]
    data = _mixed_body(int(name[1:]) if name[1:].isdigit() else 9,
                       block * 6 - 333)
    return data, jframe.compress(data, EncodeOpts(
        level=int(name[1:]) if name[1:].isdigit() else 6, block_size=block,
        checksum=name == "checksum", seekable=True)), None


NAMES = ["l1", "l3", "l5", "checksum", "dict"]


def _attach(pair, do):
    if do is not None:
        for s in pair:
            s.set_dict(do.dict_content, do.dict_huf)


@pytest.mark.parametrize("name", NAMES)
def test_queries_equal_jax(name):
    data, arc, do = _archive(name)
    p, j = _pair(arc)
    assert PS.is_seekable(arc) and JS.is_seekable(arc)
    assert vars(p.header) == vars(j.header)
    for attr in ("decompressed_size", "global_hash", "block_size",
                 "num_blocks", "seek_entries"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert np.array_equal(p.comp_offsets, j.comp_offsets)
    n = p.num_blocks
    for i in (-1, 0, 1, n - 1, n, n + 5):
        for q in ("block_comp_size", "block_decomp_size"):
            assert _outcome(lambda: getattr(p, q)(i)) == \
                _outcome(lambda: getattr(j, q)(i))
    for off in (-1, 0, 1, p.block_size, len(data) - 1, len(data)):
        assert _outcome(lambda: p.block_of(off)) == \
            _outcome(lambda: j.block_of(off))
        for length in (-1, 0, 1, 5000, len(data)):
            assert _outcome(lambda: p.block_range(off, length)) == \
                _outcome(lambda: j.block_range(off, length))


@pytest.mark.parametrize("name", NAMES)
def test_decodes_equal_jax(name):
    data, arc, do = _archive(name)
    p, j = _pair(arc)
    _attach((p, j), do)
    for i in range(p.num_blocks):
        for v in (False, True):
            assert p.decompress_block(i, v) == j.decompress_block(i, v) \
                == data[i * p.block_size:(i + 1) * p.block_size]
    bs = p.block_size
    for off, length in ((0, len(data)), (bs - 7, 2 * bs + 20), (5, 1),
                        (len(data) - 3, 3), (100, 0)):
        want = data[off:off + length]
        assert p.decompress_range(off, length) == \
            j.decompress_range(off, length) == want
        assert p.decompress_range(off, length, True) == want
        assert p.decompress_range_mt(off, length, n_threads=3) == \
            j.decompress_range_mt(off, length, n_threads=3) == want
        assert p.decompress_range_device(off, length, device="cpu",
                                         batch=2) == \
            j.decompress_range_device(off, length, batch=2) == want


def test_empty_archive():
    arc = jframe.compress(b"", EncodeOpts(level=3, block_size=4096,
                                          seekable=True))
    p, j = _pair(arc)
    assert p.num_blocks == j.num_blocks == 0
    assert p.decompress_range(0, 0) == b""
    assert p.decompress_range_device(0, 0, device="cpu") == b""
    assert _outcome(lambda: p.block_of(0)) == _outcome(lambda: j.block_of(0))


def test_not_seekable_and_truncated():
    data, arc, _ = _archive("l3")
    plain = jframe.compress(data, EncodeOpts(level=3, block_size=8192))
    assert not PS.is_seekable(plain) and not JS.is_seekable(plain)
    assert _pair(plain) is None
    for cut in (len(arc) // 2, len(arc) - 1, 30, 10):
        assert not PS.is_seekable(arc[:cut])
        assert _pair(arc[:cut]) is None


def test_corrupt_sek_table_and_payload():
    data, arc, _ = _archive("checksum")
    p, _ = _pair(arc)
    n = p.num_blocks
    sek = len(arc) - 12 - n * 4           # the first SEK entry (footer 12)
    blobs = []
    for value in (3, 1 << 30, p.seek_entries[0] + 1, p.seek_entries[0] - 1):
        bad = bytearray(arc)
        bad[sek:sek + 4] = int(value).to_bytes(4, "little")
        blobs.append(bytes(bad))
    bad_hdr = bytearray(arc)
    bad_hdr[sek - 8] ^= 0x01                # the SEK block header
    blobs.append(bytes(bad_hdr))
    flip = bytearray(arc)
    flip[60] ^= 0x20                        # a payload byte of block 0
    blobs.append(bytes(flip))
    for blob in blobs:
        pair = _pair(blob)
        if pair is None:
            continue
        p, j = pair
        for call in (lambda s: s.decompress_block(0, True),
                     lambda s: s.decompress_range(0, len(data), True),
                     lambda s: s.decompress_range_mt(0, len(data), True, 2),
                     lambda s: s.decompress_range(0, len(data))):
            assert _outcome(lambda: call(p)) == _outcome(lambda: call(j))
        dev = _outcome(lambda: p.decompress_range_device(0, len(data),
                                                         device="cpu"))
        assert dev == _outcome(lambda: j.decompress_range_device(
            0, len(data)))


def test_dictionary_required_and_mismatch():
    data, arc, do = _archive("dict")
    for attach in (None, b"another dictionary " * 10):
        p, j = _pair(arc)
        if attach:
            p.set_dict(attach)
            j.set_dict(attach)
        for call in (lambda s: s.decompress_block(0),
                     lambda s: s.decompress_range(0, 10)):
            a, b = _outcome(lambda: call(p)), _outcome(lambda: call(j))
            assert a == b and isinstance(a, tuple)
        assert _outcome(lambda: p.decompress_range_device(
            0, 10, device="cpu")) == _outcome(
            lambda: j.decompress_range_device(0, 10))


def test_open_file(tmp_path):
    data, arc, _ = _archive("l1")
    path = tmp_path / "a.zxc"
    path.write_bytes(arc)
    p = PS.Seekable.open_file(str(path))
    try:
        assert p.decompress_range(1000, 9000) == data[1000:10000]
    finally:
        p.close()
    (tmp_path / "b.zxc").write_bytes(arc[:20])
    with pytest.raises(Z.ZxcError) as e:
        PS.Seekable.open_file(str(tmp_path / "b.zxc"))
    with pytest.raises(JZxcError) as j:
        JS.Seekable.open_file(str(tmp_path / "b.zxc"))
    assert e.value.code == j.value.code
