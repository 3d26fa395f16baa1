"""Level 7 of the port's device encoder on the CPU: every position's best
candidate from the device matcher, then the host level-7 pipeline of a
dispatch group's blocks in one native call on host threads
(``runtime.opt_group``), beside the next group's match.

Held against two references: the benchmark's plain reference
(``bench_port/reference/opt_parse.py``: a plain-torch best-of-K matcher
and the level-7 parse in NumPy), block by block, on every device-encode
route; and, given the same candidates, the JAX package's host level-7
pipeline (its ``_first_pass_costs``, ``runtime.optimal_parse`` passes and
``_token_costs``, then its ``_glo_payload`` auction). The matchers at 128
candidates a position are held against the JAX package's. Tolerance:
exact equality everywhere.
"""
import functools

import numpy as np
import pytest
import torch

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import block_encode as jbe
from zxc_tpu.ops import encode as JE

import zxc_tpu_torch as Z
from zxc_tpu_torch import profiling
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.codec import block_encode as pbe
from zxc_tpu_torch.errors import ZxcError
from zxc_tpu_torch.ops import encode as PE, encode_kernels as EK

from bench_port.reference import opt_parse as OP, zxc_numpy as R

from test_torch_jax_native import jax_native

K = 128


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _words(seed: int, n: int) -> bytes:
    """Word soup with repeats at many distances (offsets past 256 too),
    runs and a few random bytes."""
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


def _runs(n: int) -> bytes:
    """Long runs and long periodic stretches: lengths far past the LCP
    cap, at offset 1 and at other offsets."""
    unit = (b"A" * 9000 + b"B" * 100 + b"A" * 3000 + b"abcdefg" * 2000
            + _words(4, 3000) + b"xyz" * 700)
    return (unit * (n // len(unit) + 1))[:n]


def corpus(name: str, n: int) -> bytes:
    rng = np.random.default_rng(17)
    if name == "words":
        return _words(7, n)
    if name == "runs":
        return _runs(n)
    if name == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    txt = _words(3, n // 2)
    return (txt[:n // 4] + rng.integers(0, 256, n // 4,
                                        dtype=np.uint8).tobytes()
            + txt)[:n]


CORPORA = ["words", "mix", "runs", "random"]


@functools.lru_cache(maxsize=None)
def _data(name: str, block_size: int) -> bytes:
    """Two full blocks and a tail block."""
    return corpus(name, 2 * block_size + 3001)


@functools.lru_cache(maxsize=None)
def _ref_cands(name: str, block_size: int) -> tuple:
    """The plain reference's candidates of every block of ``_data``."""
    data = _data(name, block_size)
    out = []
    for s in range(0, len(data), block_size):
        arr = np.frombuffer(data, np.uint8, min(block_size, len(data) - s),
                            s)
        lens, offs = OP.best_candidates(torch.from_numpy(arr.copy()))
        out.append((arr, lens.numpy(), offs.numpy()))
    return tuple(out)


def _ref_blocks(name: str, block_size: int, checksum: bool) -> list:
    return [OP.encode_block(arr, lens, offs, checksum)
            for arr, lens, offs in _ref_cands(name, block_size)]


def _blocks(arc: bytes) -> list:
    fr = R.walk_frame(arc)
    tail = 4 if fr.has_checksum else 0
    return [arc[b.start - R.BLOCK_HEADER:b.start + b.size + tail]
            for b in fr.blocks]


# ---------------------------------------------------------------------------
# compress_device, encode_chunk_device against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("block_size", [16384, 65536])
@pytest.mark.parametrize("name", CORPORA)
def test_compress_device_l7_equals_reference(name, block_size, checksum):
    data = _data(name, block_size)
    arc = PE.compress_device(data, level=7, block_size=block_size,
                             device="cpu", checksum=checksum)
    assert _blocks(arc) == _ref_blocks(name, block_size, checksum)
    assert Z.codec.frame.decompress(
        arc, Z.DecodeOpts(checksum=checksum)) == data


@pytest.mark.parametrize("name", CORPORA)
def test_encode_chunk_device_l7_equals_reference(name):
    arr, lens, offs = _ref_cands(name, 16384)[0]
    got = PE.encode_chunk_device(arr, 7, "cpu", checksum=True)
    assert got == OP.encode_block(arr, lens, offs, True)


@pytest.mark.parametrize("how", ["block_over_64k", "env"])
def test_compress_device_l7_xla_matcher_equals_reference(how, monkeypatch):
    """The XLA matcher compares its candidates at the LCP cap, so level 7
    makes the same blocks on both matchers."""
    if how == "env":
        monkeypatch.setenv("ZXC_DEVICE_MATCHER", "xla")
        block_size, data = 16384, _data("runs", 16384)
    else:
        block_size, data = 131072, _runs(140_000)
    arc = PE.compress_device(data, level=7, block_size=block_size,
                             device="cpu")
    assert _blocks(arc) == OP.encode(data, block_size, False)


def test_compress_device_l7_is_smaller_than_the_lazy_parse():
    """The DP and its auction against the lazy parse of the same
    candidates (the route level 7 took before it had the DP)."""
    data = _data("words", 65536)
    arc = PE.compress_device(data, level=7, block_size=65536, device="cpu")
    lazy = 0
    for arr, lens, offs in _ref_cands("words", 65536):
        seqs = prt.lazy_parse(lens, offs, True)
        lazy += len(pbe.encode_chunk_plain(
            arr, 7, sequences=tuple(a.astype(np.int64) for a in seqs)))
    assert len(arc) < lazy


# ---------------------------------------------------------------------------
# the native entry against the JAX package's host pipeline
# ---------------------------------------------------------------------------

def _jax_level7(arr, lens, offs, checksum: bool, monkeypatch) -> bytes:
    """The JAX package's host level-7 block with its matcher replaced by
    the given candidates."""
    with monkeypatch.context() as m:
        m.setattr(jrt, "find_matches",
                  lambda full, start, k: (np.asarray(lens, np.int32),
                                          np.asarray(offs, np.int32)))
        return jbe.encode_chunk(arr, 7, None, checksum)


def _packed(lens, offs) -> np.ndarray:
    """Candidates packed as the readback packs them (``pack_cands``)."""
    return PE.pack_cands(torch.from_numpy(np.asarray(lens, np.int64)),
                         torch.from_numpy(np.asarray(offs, np.int64))
                         ).int().numpy()


def _opt(arr, checksum, lens, offs, threads=1):
    """The native entry on one block."""
    (blk,), stages, counts = prt.opt_group(arr, len(arr), checksum,
                                           _packed(lens, offs), EK.CAP,
                                           threads)
    return blk, stages[0], counts[0]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("name", CORPORA)
def test_opt_block_equals_jax_host_pipeline(name, checksum, monkeypatch):
    """Given the reference's exact candidates (capped as the readback caps
    them, extended in the call), the JAX package's block."""
    arr, lens, offs = _ref_cands(name, 16384)[0]
    want = _jax_level7(arr, lens, offs, checksum, monkeypatch)
    blk, stages, counts = _opt(arr, checksum, lens, offs)
    assert blk == want
    assert stages.shape == (6,) and (stages >= 0).all()
    assert stages[3] == 0          # no all-literal candidate at level 7
    assert 1 <= counts[0] <= 3
    assert counts[1] == int((lens > EK.CAP).sum())


@pytest.mark.parametrize("name", ["words", "runs"])
def test_opt_block_on_lcp_candidates_equals_jax(name, monkeypatch):
    """The LCP matcher's candidates, capped at 256, through the entry's
    cap extension: the JAX package's block on the exact lengths."""
    arr, lens, offs = _ref_cands(name, 65536)[0]
    clens, coffs = PE.find_matches_device_lcp(torch.from_numpy(arr.copy()),
                                              K)
    assert np.array_equal(coffs.numpy(), offs)
    assert np.array_equal(clens.clamp(max=EK.CAP).numpy(),
                          np.minimum(lens, EK.CAP))
    blk, _, _ = _opt(arr, True, clens.numpy(), coffs.numpy())
    assert blk == _jax_level7(arr, lens, offs, True, monkeypatch)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cap_extension_equals_exact_extension(seed, monkeypatch):
    """On run-heavy data every length at the cap comes out exact: the
    block from capped lengths is the JAX package's block from exact ones,
    and the count of lengths past the cap is theirs."""
    data = _runs(20000 + 977 * seed)
    arr = np.frombuffer(data, np.uint8)
    lens, offs = (t.numpy() for t in OP.best_candidates(
        torch.from_numpy(arr.copy())))
    assert (lens > 4 * EK.CAP).sum() > 1000
    blk, _, counts = _opt(arr, False, lens, offs)
    assert blk == _jax_level7(arr, lens, offs, False, monkeypatch)
    assert counts[1] == int((lens > EK.CAP).sum())


@pytest.mark.parametrize("pos,length,off,code", [
    (95, 9, 1, -8), (10, 6, 11, -9), (10, 6, 12, -9)])
def test_opt_group_refuses_bad_candidates(pos, length, off, code):
    arr = np.zeros(100, np.uint8)
    lens = np.zeros(100, np.int32)
    offs = np.ones(100, np.int32)
    lens[pos], offs[pos] = length, off
    with pytest.raises(ZxcError) as e:
        _opt(arr, False, lens, offs)
    assert e.value.code == code
    with pytest.raises(ValueError):
        prt.opt_group(arr, 100, False, _packed(lens, offs)[:50], EK.CAP, 1)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_opt_group_equals_block_by_block(threads):
    """A group's blocks on any number of threads, the tail block shorter,
    equal each block on its own."""
    data = _data("mix", 16384)
    arr = np.frombuffer(data, np.uint8)
    cands = _ref_cands("mix", 16384)
    packed = np.concatenate([_packed(l, o) for _, l, o in cands])
    blocks, stages, counts = prt.opt_group(arr, 16384, True, packed,
                                           EK.CAP, threads)
    assert blocks == [_opt(a, True, l, o)[0] for a, l, o in cands]
    assert stages.shape == (3, 6) and counts.shape == (3, 2)


def test_opt_block_on_tiny_and_incompressible_blocks():
    for n in (1, 5, 6, 300):
        arr = np.frombuffer(_words(n, n), np.uint8)
        lens, offs = (t.numpy() for t in OP.best_candidates(
            torch.from_numpy(arr.copy())))
        blk, _, _ = _opt(arr, True, lens, offs)
        assert blk == OP.encode_block(arr, lens, offs, True)
    arr = np.random.default_rng(2).integers(0, 256, 5000).astype(np.uint8)
    blk, _, _ = _opt(arr, False, np.zeros(5000, np.int32),
                     np.ones(5000, np.int32))
    assert blk[0] == R.RAW and blk[8:] == arr.tobytes()


# ---------------------------------------------------------------------------
# the matchers at 128 candidates a position
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CORPORA)
def test_lcp_matcher_at_k128_equals_jax(name):
    arr = np.frombuffer(corpus(name, 6000), np.uint8)
    jl, jo = JE.find_matches_device_lcp(arr, K, interpret=True)
    pl, po = PE.find_matches_device_lcp(torch.from_numpy(arr.copy()), K)
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(po.numpy(), np.asarray(jo))


@pytest.mark.parametrize("name", CORPORA)
def test_xla_matcher_at_k128_equals_jax(name):
    arr = np.frombuffer(corpus(name, 6000), np.uint8)
    jl, jo = JE.find_matches_device(arr, K)
    pl, po = PE.find_matches_device(torch.from_numpy(arr.copy()), K)
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(po.numpy(), np.asarray(jo))


@pytest.mark.parametrize("name", CORPORA)
def test_matchers_at_the_cap_equal_the_reference(name):
    """The XLA matcher compared at the cap is the reference's matcher; the
    LCP matcher's lengths are its lengths capped."""
    arr = np.frombuffer(corpus(name, 20000), np.uint8)
    t = torch.from_numpy(arr.copy())
    rl, ro = (a.numpy() for a in OP.best_candidates(t))
    xl, xo = PE.find_matches_device(t, K, EK.CAP)
    assert np.array_equal(xl.numpy(), rl) and np.array_equal(xo.numpy(), ro)
    ll, lo = PE.find_matches_device_lcp(t, K)
    assert np.array_equal(ll.clamp(max=EK.CAP).numpy(),
                          np.minimum(rl, EK.CAP))
    assert np.array_equal(lo.numpy(), ro)


# ---------------------------------------------------------------------------
# the pool, its spans and counters
# ---------------------------------------------------------------------------

def test_compress_device_l7_phases():
    """Level 7's ``_phases``: ``PHASES`` but ``emit``, and
    ``OPT_PHASES``; the readback four bytes a position; every block by
    the native entry; the stage clocks one call a block."""
    data = _data("words", 16384)
    ph: dict = {}
    with profiling.collect_phases() as col:
        arc = PE.compress_device(data, level=7, block_size=16384,
                                 device="cpu", checksum=True, _phases=ph)
    assert not col.seconds and not col.counters
    assert set(ph) == (set(PE.PHASES) - {"emit"}) | set(PE.OPT_PHASES)
    assert ph["d2h_bytes"] == 4 * len(data)
    assert ph["emit.native_bytes"] == len(data)
    n_blocks = len(R.walk_frame(arc).blocks)
    assert n_blocks <= ph["opt.parses"] <= 3 * n_blocks
    assert ph["opt.extended"] == sum(int((lens > EK.CAP).sum())
                                     for _, lens, _ in
                                     _ref_cands("words", 16384))
    with profiling.collect_phases() as col:
        PE.compress_device(data, level=7, block_size=16384, device="cpu")
    for k in pbe.OPT_STAGES:
        assert col.counts[k] == n_blocks
    assert col.counts["opt.wait"] >= 1
    assert col.counts["group"] == col.counts["parse.readback"] == n_blocks


def test_opt_pipe_keeps_block_order_and_raises(monkeypatch):
    """Groups come back in order with one group or more in flight, and a
    group that fails raises in the caller."""
    data = _data("mix", 16384) * 2
    for depth in (0, 1, 3):
        monkeypatch.setattr(PE, "OPT_DEPTH", depth)
        arc = PE.compress_device(data, level=7, block_size=16384,
                                 device="cpu")
        assert Z.decompress(arc) == data
        assert _blocks(arc)[:2] == _ref_blocks("mix", 16384, False)[:2]
    real = pbe.encode_group_opt

    def fails(arr, *a, **kw):
        if len(arr) < 16384:
            raise RuntimeError("the tail block fails")
        return real(arr, *a, **kw)

    monkeypatch.setattr(pbe, "encode_group_opt", fails)
    with pytest.raises(RuntimeError, match="tail block fails"):
        PE.compress_device(data, level=7, block_size=16384, device="cpu")


def test_compress_device_l7_of_nothing():
    arc = PE.compress_device(b"", level=7, device="cpu", checksum=True)
    assert Z.decompress(arc) == b""


def test_levels_below_7_record_no_opt_phases():
    ph: dict = {}
    PE.compress_device(_data("words", 16384), level=6, block_size=16384,
                       device="cpu", _phases=ph)
    assert set(ph) == set(PE.PHASES)
