"""The NumPy reference decoder on the frozen encoder's archives: levels 1,
3 and 7, with and without checksums, RAW, GLO and GHI blocks, raw, RLE
and PivCo literal sections; the control differs; corrupt archives are
rejected."""
import struct

import numpy as np
import pytest

from bench_port.harness import corpus, frozen
from bench_port.reference import zxc_numpy as R

PLAIN = corpus.gen_chunk(1 << 20, (2**31 + 21, 0, 0))
# a run of noise long enough that a 64 KiB block of it is stored RAW, and
# a long run of one byte for an RLE literal section
NOISE = np.random.default_rng(3).integers(0, 256, 150_000,
                                          dtype=np.uint8).tobytes()
DATA = PLAIN[:400_000] + NOISE + b"a" * 70_000 + PLAIN[400_000:]


def _lit_encodings(arc: bytes, fr) -> set:
    out = set()
    for b in fr.blocks:
        if b.kind == R.GLO:
            out.add(arc[b.start + 8])
    return out


SEEN = {"kinds": set(), "lit": set()}


@pytest.mark.parametrize("level", [1, 3, 7])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("block_size", [65536, 524288])
def test_reference_decodes_frozen_archives(level, checksum, block_size):
    arc = frozen.compress(DATA, level, block_size, checksum, 2)
    assert R.decode_frame(arc) == DATA
    fr = R.walk_frame(arc)
    assert fr.has_checksum == checksum and fr.plain_size == len(DATA)
    SEEN["kinds"] |= {b.kind for b in fr.blocks}
    SEEN["lit"] |= _lit_encodings(arc, fr)
    assert frozen.decompress(arc, len(DATA), 2) == DATA


def test_reference_saw_every_block_and_literal_kind():
    for level in (1, 3, 7):
        arc = frozen.compress(DATA, level, 65536, True, 2)
        fr = R.walk_frame(arc)
        SEEN["kinds"] |= {b.kind for b in fr.blocks}
        SEEN["lit"] |= _lit_encodings(arc, fr)
    assert {R.RAW, R.GLO, R.GHI} <= SEEN["kinds"]
    assert {0, 1, 2} <= SEEN["lit"]     # raw, RLE, PivCo literal sections


def test_control_breaks_overlapping_matches():
    arc = frozen.compress(DATA, 3, 65536, False, 2)
    ctl = R.decode_frame(arc, overlap=False)
    assert len(ctl) == len(DATA) and ctl != DATA
    diff = np.frombuffer(ctl, np.uint8) != np.frombuffer(DATA, np.uint8)
    assert diff.sum() > 1000


def test_rapidhash_matches_the_frozen_library():
    import ctypes
    L = frozen.lib()
    L.zxch_rapidhash64.restype = ctypes.c_uint64
    L.zxch_rapidhash64.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_uint64]
    for n in (0, 1, 3, 4, 7, 8, 15, 16, 17, 33, 49, 65, 81, 97, 112, 113,
              224, 225, 1000, 65536):
        buf = np.frombuffer(DATA[:n], np.uint8) if n else np.zeros(1,
                                                                   np.uint8)
        want = L.zxch_rapidhash64(buf.ctypes.data_as(ctypes.c_void_p), n, 0)
        assert R.rapidhash64(DATA[:n]) == want, n


def _flip(arc: bytes, at: int) -> bytes:
    b = bytearray(arc)
    b[at] ^= 0x40
    return bytes(b)


def test_corrupt_archives_are_rejected():
    arc = frozen.compress(DATA, 3, 65536, True, 2)
    fr = R.walk_frame(arc)
    blk = fr.blocks[1]
    with pytest.raises(R.FrameError):        # payload byte: checksum
        R.decode_frame(_flip(arc, blk.start + blk.size // 2))
    with pytest.raises(R.FrameError):        # block header check
        R.walk_frame(_flip(arc, blk.start - 5))
    with pytest.raises(R.FrameError):        # file header check
        R.walk_frame(_flip(arc, 5))
    bad = bytearray(arc)
    struct.pack_into("<Q", bad, len(bad) - 12, len(DATA) + 65536)
    with pytest.raises(R.FrameError):        # footer size
        R.decode_frame(bytes(bad))
    with pytest.raises(R.FrameError):
        R.walk_frame(arc[:-20])
