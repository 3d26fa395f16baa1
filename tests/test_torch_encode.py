"""Device encode of the PyTorch port against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function and its counterpart in the port: the LCP kernel
(``zxc_tpu.ops.pallas_encode.lcp_pairs`` in interpret mode) and the parse
walk (``parse_compact_walk(interpret=True)``) against the port's plain
versions, the two matchers, the parse and compaction, the host emitter
(``encode_chunk`` on given sequences, with its Huffman, RLE, varint and
header writers) and the whole ``compress_device``, whose archives must
also decode through the port. Tolerance: exact equality everywhere.
"""
import os

import numpy as np
import pytest
import torch

from zxc_tpu import ops as jops
from zxc_tpu import runtime as jrt
from zxc_tpu.codec import block_encode as jbe, huffman as jhuf
from zxc_tpu.errors import ZxcError as JZxcError
from zxc_tpu.format import headers as jhdr, varint as jvar
from zxc_tpu.ops import encode as JE, pallas_encode as JPE

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.codec import block_encode as pbe, huffman as phuf
from zxc_tpu_torch.constants import BLOCK_GLO, BLOCK_RAW
from zxc_tpu_torch.errors import ZxcError
from zxc_tpu_torch.format import headers as phdr, varint as pvar
from zxc_tpu_torch.ops import encode as PE, encode_kernels as EK

from test_torch_jax_native import jax_native


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _corpora():
    """The corpora of tests/test_device_encode.py."""
    rng = np.random.default_rng(17)
    txt = (b"the quick brown fox jumps over the lazy dog. " * 800)[:30000]
    return {
        "text": txt,
        "mix": txt[:12000] + rng.integers(0, 256, 6000,
                                          dtype=np.uint8).tobytes() + txt[:6000],
        "runs": b"A" * 9000 + b"B" * 100 + b"A" * 3000,
        "random": rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
    }


CORPORA = ["text", "mix", "runs", "random"]


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# varint, headers, runtime bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000,
                                   0x1FFFFF])
def test_varint_encode_equals_jax(value):
    assert pvar.varint_encode(value) == jvar.varint_encode(value)


def test_varint_encode_refuses_22_bits():
    with pytest.raises(Z.ZxcError) as e:
        pvar.varint_encode(0x200000)
    with pytest.raises(JZxcError) as j:
        jvar.varint_encode(0x200000)
    assert e.value.code == j.value.code


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("block_size", [4096, 65536, 1 << 21])
def test_file_header_and_footer_equal_jax(block_size, checksum):
    for dict_id in (0, 0x1234ABCD):
        assert (phdr.write_file_header(block_size, checksum, dict_id)
                == jhdr.write_file_header(block_size, checksum, dict_id))
    assert (phdr.write_file_footer(123456789, 0xDEADBEEF, checksum)
            == jhdr.write_file_footer(123456789, 0xDEADBEEF, checksum))


@pytest.mark.parametrize("btype", [0, 1, 2, 255])
def test_block_header_equals_jax(btype):
    for size in (0, 1, 65536, (1 << 32) - 1):
        assert (phdr.write_block_header(btype, size)
                == jhdr.write_block_header(btype, size))
        assert phdr.read_block_header(
            phdr.write_block_header(btype, size)).comp_size == size


def test_gnr_header_equals_jax():
    descs = [(5, 7), (0, 0), ((1 << 32) - 1, 3), (9, (1 << 32) - 1)]
    p = phdr.write_gnr_header(phdr.GnrHeader(3, 4, 2, 0, 0, 1), descs)
    assert p == jhdr.write_gnr_header(jhdr.GnrHeader(3, 4, 2, 0, 0, 1),
                                      descs)
    gh, back = phdr.read_gnr_header(p, 4)
    assert back == descs and gh.n_literals == 4


def _lits(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:
        return rng.zipf(1.4, n).clip(0, 255).astype(np.uint8)
    if kind == 1:
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == 2:
        return np.repeat(rng.integers(0, 8, n // 50 + 1), 50)[:n].astype(
            np.uint8)
    return rng.choice(np.array([3, 200], np.uint8), n)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_runtime_encoders_equal_jax(seed):
    lit = _lits(seed, 5000 + 977 * seed)
    freq = np.bincount(lit, minlength=256)
    for max_len in (8, 11):
        cl = prt.code_lengths(freq, max_len)
        assert np.array_equal(cl, jrt.code_lengths(freq, max_len))
        assert prt.pivco_encode(lit, cl) == jrt.pivco_encode(lit, cl)
    assert prt.rle_encode_lit(lit) == jrt.rle_encode_lit(lit)
    assert prt.code_lengths(freq[:255], 8) is None
    assert prt.code_lengths(freq, 16) is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_rle_literals_native_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    parts = [np.full(int(rng.integers(1, 400)), rng.integers(0, 256),
                     np.uint8) if rng.random() < 0.5
             else rng.integers(0, 256, int(rng.integers(1, 300))).astype(
                 np.uint8) for _ in range(40)]
    lit = np.concatenate(parts)
    out = pbe.encode_rle_literals(lit)
    assert out == pbe.encode_rle_literals_numpy(lit)
    assert out == jbe.encode_rle_literals(lit)
    assert pbe.encode_rle_literals(lit[:0]) == b""


# ---------------------------------------------------------------------------
# Huffman encode half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [8, 11])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_huffman_encode_half_equals_jax(seed, max_len):
    lit = _lits(seed, 4000 + 1000 * seed)
    freq = np.bincount(lit, minlength=256)
    cl = phuf.build_code_lengths(freq, max_len)
    assert np.array_equal(cl, jhuf.build_code_lengths(freq, max_len))
    assert phuf.pack_lengths(cl) == jhuf.pack_lengths(cl)
    pt, jt = phuf.build_tree(cl), jhuf.build_tree(cl)
    for f in ("child", "sym", "bfs", "lvl_start", "flat_d", "covered",
              "codes", "code_len", "path"):
        assert np.array_equal(getattr(pt, f), getattr(jt, f)), f
    assert pt.max_depth == jt.max_depth
    pay = phuf.encode_payload(lit, pt)
    assert pay == jhuf.encode_payload(lit, jt)
    assert pay == phuf.encode_payload_numpy(lit, pt)
    assert np.array_equal(phuf.node_counts(pt, freq),
                          jhuf.node_counts(jt, freq))
    for reuse in (False, True):
        size = phuf.calc_size(freq, pt, with_header=True, reuse=reuse)
        assert size == jhuf.calc_size(freq, jt, with_header=True)
        assert size == 128 + len(pay)
    assert np.array_equal(phuf.decode_payload(
        np.frombuffer(pay, np.uint8), len(lit), pt), lit)


def test_build_code_lengths_edges_equal_jax():
    f = np.zeros(256, np.int64)
    assert phuf.build_code_lengths(f, 8) is None
    assert jhuf.build_code_lengths(f, 8) is None
    f[77] = 5
    assert np.array_equal(phuf.build_code_lengths(f, 8),
                          jhuf.build_code_lengths(f, 8))
    f[:] = 1
    with pytest.raises(Z.ZxcError) as e:
        phuf.build_code_lengths(f, 7)
    with pytest.raises(JZxcError) as j:
        jhuf.build_code_lengths(f, 7)
    assert e.value.code == j.value.code


# ---------------------------------------------------------------------------
# the LCP kernel's plain version and the parse walk's
# ---------------------------------------------------------------------------

def _lcp_case(kind: str, n: int, seed: int):
    """A block and ascending (p, c) pairs, p dense (the JAX kernel's p
    window spans a few rows per quad): c = p - 1, a periodic lag, a random
    earlier position, or p itself near the end (pairs running past n)."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        data = np.frombuffer(_words(seed, n), np.uint8)
    elif kind == "runs":
        data = np.repeat(rng.integers(0, 3, n // 700 + 1), 700)[:n].astype(
            np.uint8)
    else:
        data = rng.integers(0, 256, n).astype(np.uint8)
    npairs = min(3000, 4 * n)
    p = np.minimum(rng.integers(1, max(n // npairs, 1) + 1, npairs).cumsum()
                   + 1, n - 1)
    p = np.sort(np.maximum(p, 1))
    lag = rng.choice([1, 7, 300, 0], npairs)
    rnd = (rng.random(npairs) * p).astype(np.int64)
    c = np.where(lag == 0, rnd, np.maximum(p - lag, 0))
    return data, p.astype(np.int64), c.astype(np.int64)


@pytest.mark.parametrize("kind", ["text", "runs", "random"])
@pytest.mark.parametrize("n", [12, 4096, 16384, 65536])
def test_lcp_reference_equals_jax_kernel(n, kind):
    data, p, c = _lcp_case(kind, n, n + len(kind))
    want = JPE.lcp_pairs(data, p, c, interpret=True)
    got = EK.lcp_pairs(data, p, c, device="cpu")
    assert np.array_equal(got, want)
    if kind == "runs" and n >= 4096:
        assert (want >= EK.CAP).any()      # runs longer than the cap


def _lcp_oracle(data, pc):
    n = len(data)
    w = pc.astype(np.int64) & 0xFFFFFFFF
    p, c = w >> 16, w & 0xFFFF

    def z(x):
        return int(data[x]) if 0 <= x < n else 0
    out = []
    for a, b in zip(p.tolist(), c.tolist()):
        m = EK.CAP
        for i in range(EK.CAP):
            if z(a + i) != z(b + i):
                m = i
                break
        out.append(m)
    return np.array(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcp_reference_on_garbage_pairs(seed):
    """Any int32 word is a pair: p = w >> 16 (logical, so up to 65535),
    c = the low 16 bits; positions at or past n read 0."""
    rng = np.random.default_rng(seed)
    n = [5, 300, 4093][seed]
    data = np.repeat(rng.integers(0, 3, n // 5 + 1), 5)[:n].astype(np.uint8)
    p = rng.integers(0, n + 400, (2, 500))
    c = rng.integers(0, n + 400, (2, 500))
    c[:, ::5] = p[:, ::5]                                 # p == c: all 256
    c[:, 1::5] = p[:, 1::5] + 1                           # p < c
    pc = EK.pack_pairs(_t(p), _t(c)).numpy()
    pc[:, 2::5] = rng.integers(-2**31, 2**31, (2, 100))   # any word
    blk = _t(np.stack([data, data[::-1]]))
    got = EK.lcp(blk, _t(pc))
    assert got.dtype == torch.int32 and EK.lcp.launches == 0
    assert np.array_equal(got[0].numpy(), _lcp_oracle(data, pc[0]))
    assert np.array_equal(got[1].numpy(), _lcp_oracle(data[::-1], pc[1]))


def test_pack_pairs_keeps_positions_past_32767():
    p = torch.tensor([0, 1, 32767, 32768, 65535, 65535])
    c = torch.tensor([0, 65535, 5, 32767, 0, 65534])
    pc = EK.pack_pairs(p, c)
    assert pc.dtype == torch.int32
    assert pc.tolist() == [int(np.uint32(a << 16 | b).astype(np.int32))
                           for a, b in zip(p.tolist(), c.tolist())]
    up, uc = EK.unpack_pairs(pc)
    assert torch.equal(up, p) and torch.equal(uc, c)
    with pytest.raises(ValueError, match="65536"):
        EK.lcp_pairs(np.zeros(70000, np.uint8), [65536], [0], device="cpu")


def _lens_offs(n: int, seed: int):
    arr = np.frombuffer(_words(seed, n), np.uint8)
    lens, offs = jbe.find_matches(arr, 0, 4)
    return lens.astype(np.int32), offs.astype(np.int32)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n", [2048, 65536])
def test_parse_walk_equals_jax_kernel(n, lazy):
    lens, offs = _lens_offs(n, n // 1024)
    a = JE.parse_compact_walk(lens, offs, lazy, interpret=True)
    k = int(a[0])
    step = PE.walk_steps(_t(lens), lazy)
    nseq, pos = EK.parse_walk_reference(step[None])
    assert int(nseq[0]) == k
    assert np.array_equal(pos[0, :k].numpy(), np.asarray(a[1])[:k])
    b = PE.parse_compact_walk(_t(lens), _t(offs), lazy)
    assert int(b[0]) == k
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert EK.walk_chain(step[None])[0] >= k


def _walk_oracle(step: np.ndarray, cap: int):
    P = len(step)
    pos = np.zeros(cap, np.int64)
    p = j = 0
    while p < P:
        s = int(step[p])
        if s > 1:
            pos[min(j, cap - 1)] = p
            j += 1
        p += min(max(s, 1), P)
    return j, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_walk_on_garbage_steps(seed):
    rng = np.random.default_rng(seed)
    P = [1, 700, 5000][seed]
    step = rng.integers(-3, 9, (3, P))
    step[1] = rng.integers(-5, 3 * P, P)
    step[2] = 2                         # more records than pos holds
    nseq, pos = EK.parse_walk(_t(step.astype(np.int32)))
    assert EK.parse_walk.launches == 0
    cap = P // 5 + 1
    assert pos.shape == (3, cap)
    for b in range(3):
        j, want = _walk_oracle(step[b], cap)
        assert int(nseq[b]) == j and np.array_equal(pos[b].numpy(), want)
    assert EK.walk_defined(nseq, cap).sum(dim=1).tolist() == [
        min(int(k), cap) for k in nseq]
    assert EK.walk_bytes_moved(step.astype(np.int32)) == (
        4 * int(EK.walk_chain(step.astype(np.int32)).sum()) + 12
        + 4 * sum(min(int(k), cap) for k in nseq))


def test_lcp_bytes_moved_counts_blocks_pairs_and_results():
    # each block once, a packed 4-byte pair word in and a 4-byte result out
    assert EK.lcp_bytes_moved(16, 65536, 327660) == (
        16 * 65536 + 16 * 327660 * 8) == 42_989_056


def test_wrappers_refuse_bad_input():
    blk = torch.zeros((1, 64), dtype=torch.uint8)
    p = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        EK.lcp(blk, p.long())
    with pytest.raises(ValueError):
        EK.lcp(blk, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        EK.lcp(blk, p, n=65)
    with pytest.raises(ValueError, match="cuda or cpu"):
        EK.lcp(blk.to("meta"), p.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        EK.parse_walk(p.to("meta"))
    with pytest.raises(TypeError):
        EK.parse_walk(p[0])


# ---------------------------------------------------------------------------
# matchers and parse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 5])
@pytest.mark.parametrize("name", CORPORA)
def test_lcp_matcher_equals_jax(name, K):
    arr = np.frombuffer(_corpora()[name], np.uint8)
    jl, jo = JE.find_matches_device_lcp(arr, K, interpret=True)
    pl, po = PE.find_matches_device_lcp(_t(arr), K)
    assert pl.dtype == po.dtype == torch.int32
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(po.numpy(), np.asarray(jo))


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("name", CORPORA)
def test_xla_matcher_equals_jax(name, K):
    arr = np.frombuffer(_corpora()[name], np.uint8)
    jl, jo = JE.find_matches_device(arr, K)
    pl, po = PE.find_matches_device(_t(arr), K)
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(po.numpy(), np.asarray(jo))


def _periodic(n: int, seed: int, seg: int) -> np.ndarray:
    """Stretches of up to ``seg`` bytes, each one pattern of period 2, 3,
    7, 45, 300 or 1000 repeated, between a few random bytes: matches as
    long as a stretch at many distinct lags."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        per = int(rng.choice([2, 3, 7, 45, 300, 1000]))
        pat = rng.integers(0, 256, per).astype(np.uint8).tobytes()
        ln = int(rng.integers(seg // 2, seg))
        out += (pat * (ln // per + 1))[:ln]
        out += rng.integers(0, 256, int(rng.integers(1, 64))).astype(
            np.uint8).tobytes()
    return np.frombuffer(bytes(out[:n]), np.uint8)


def test_xla_matcher_equals_jax_at_512k_on_periodic_data():
    """The library's default block size, where ``compress_device`` takes
    the XLA matcher: matches of up to 4 KiB at many lags, so the port's
    extension resolves thousands of pairs by their lag's run."""
    arr = _periodic(512 << 10, 5, 4096)
    jl, jo = JE.find_matches_device(arr, 5)
    pl, po = PE.find_matches_device(_t(arr), 5)
    assert int(pl.max()) > 2000
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(po.numpy(), np.asarray(jo))


@pytest.mark.parametrize("kind", ["whole", "stretches", "words"])
def test_extend_exact_equals_the_straight_rounds(kind, monkeypatch):
    """``_extend_exact`` against the JAX loop ported as it is, where the
    JAX matcher itself is too slow on the CPU: one period over the whole
    block (every match runs to its end)."""
    if kind == "whole":
        arr = np.frombuffer((b"0123456789abcdefghij" * 100)[:1900],
                            np.uint8)
    elif kind == "stretches":
        arr = _periodic(20000, 2, 2000)
    else:
        arr = np.frombuffer(_words(3, 5000) * 3, np.uint8)
    got = PE.find_matches_device(_t(arr), 2)
    monkeypatch.setattr(PE, "_extend_exact", PE._extend_rounds)
    want = PE.find_matches_device(_t(arr), 2)
    assert int(got[0].max()) > 16 * 4 + 8
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_lcp_matcher_batch_equals_one_block_at_a_time():
    blocks = np.stack([np.frombuffer(_words(s, 5000), np.uint8)
                       for s in range(3)])
    bl, bo = PE.find_matches_device_lcp_batch(_t(blocks), 5)
    for j in range(3):
        l1, o1 = PE.find_matches_device_lcp(_t(blocks[j]), 5)
        assert torch.equal(bl[j], l1) and torch.equal(bo[j], o1)


@pytest.mark.parametrize("n", [0, 3, 5])
def test_matchers_on_tiny_blocks(n):
    arr = np.arange(n, dtype=np.uint8)
    for fn in (PE.find_matches_device, PE.find_matches_device_lcp):
        lens, offs = fn(_t(arr), 4)
        assert lens.shape == (n,) and not lens.any() and (offs == 1).all()


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("name", CORPORA)
def test_parse_equals_jax(name, lazy):
    arr = np.frombuffer(_corpora()[name], np.uint8)
    jl, jo = (a.astype(np.int32) for a in jbe.find_matches(arr, 0, 4))
    want = JE.parse_compact_device(jl, jo, lazy)
    assert np.array_equal(PE.parse_device(_t(jl), _t(jo), lazy).numpy(),
                          np.asarray(JE.parse_device(jl, jo, lazy)))
    dev = PE.parse_compact_device(_t(jl), _t(jo), lazy)
    walk = PE.parse_compact_walk(_t(jl), _t(jo), lazy)
    k = int(want[0])
    assert int(dev[0]) == int(walk[0]) == k
    for w, d, x in zip(want[1:], dev[1:], walk[1:]):
        assert np.array_equal(d.numpy(), np.asarray(w))
        assert np.array_equal(x[:k].numpy(), np.asarray(w)[:k])


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_capped_host_equals_jax(seed):
    arr = np.frombuffer(b"x" * 100 + (b"abcdefg" * 2000)[:9000 + seed]
                        + _words(seed, 3000), np.uint8)
    jl, jo = (np.asarray(a) for a in JE.find_matches_device_lcp(
        arr, 4, interpret=True))
    k, pos, lns, off = (np.asarray(a) for a in JE.parse_compact_device(
        jl, jo, False))
    seqs = tuple(a[:int(k)].astype(np.int64) for a in (pos, lns, off))
    assert (seqs[1] >= EK.CAP).any()
    want = JE._extend_capped_host(arr, *seqs)
    got = PE._extend_capped_host(arr, *seqs)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    # the native emitter's extension: GHI (level 1) writes every sequence
    # as it is, GLO (level 3) through its streams
    for level in (1, 3):
        native, _ = prt.emit_block(arr, level, False, *seqs, cap_len=EK.CAP)
        assert native == pbe.encode_chunk_plain(arr, level, sequences=got)


# ---------------------------------------------------------------------------
# host emitter
# ---------------------------------------------------------------------------

def _host_seqs(arr: np.ndarray, level: int):
    p = jbe.level_params(level)
    lens, offs = jbe.find_matches(arr, 0, min(p.n_candidates, 8))
    return jbe.parse_sequences(lens, offs, p.lazy, p.min_emit)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("corpus", ["words", "mix", "runs", "random"])
def test_encode_chunk_on_sequences_equals_jax(corpus, level, checksum):
    data = (_words(level, 20000) if corpus == "words"
            else _corpora()[corpus])
    arr = np.frombuffer(data, np.uint8)
    seqs = _host_seqs(arr, level)
    got = pbe.encode_chunk(arr, level, None, checksum, sequences=seqs)
    assert got == jbe.encode_chunk(arr, level, None, checksum,
                                   sequences=seqs)


def _native_plain_jax(arr, level, checksum, seqs, cap_len=0):
    """The native block emitter's block, checked against the Python
    emitters' and the JAX package's on the same (extended) sequences."""
    got, stages = prt.emit_block(arr, level, checksum, *seqs,
                                 cap_len=cap_len)
    ext = PE._extend_capped_host(arr, *seqs) if cap_len else seqs
    assert got == pbe.encode_chunk_plain(arr, level, None, checksum,
                                         sequences=ext)
    assert got == jbe.encode_chunk(arr, level, None, checksum,
                                   sequences=ext)
    assert stages.shape == (4,) and (stages >= 0).all()
    return got


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("corpus", ["words", "mix", "runs", "random"])
def test_native_block_emitter_equals_python_and_jax(corpus, level,
                                                    checksum):
    data = (_words(level, 20000) if corpus == "words"
            else _corpora()[corpus])
    arr = np.frombuffer(data, np.uint8)
    blk = _native_plain_jax(arr, level, checksum, _host_seqs(arr, level))
    assert pbe.encode_chunk(arr, level, None, checksum,
                            sequences=_host_seqs(arr, level)) == blk


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_block_emitter_on_capped_sequences(seed, level):
    """The LCP matcher's sequences, capped at 256, extended in the call."""
    arr = np.frombuffer(b"x" * 100 + (b"abcdefg" * 2000)[:9000 + seed]
                        + _words(seed, 3000), np.uint8)
    lens, offs = PE.find_matches_device_lcp(_t(arr), 4)
    k, pos, lns, off = PE.parse_compact_walk(lens, offs, False)
    seqs = tuple(a[:int(k)].numpy().astype(np.int64)
                 for a in (pos, lns, off))
    assert (seqs[1] >= EK.CAP).any()
    _native_plain_jax(arr, level, True, seqs, cap_len=EK.CAP)
    assert (pbe.encode_chunk(arr, level, checksum=True, sequences=seqs,
                             cap_len=EK.CAP)
            == prt.emit_block(arr, level, True, *seqs, cap_len=EK.CAP)[0])


_NO_SEQS = tuple(np.zeros(0, np.int64) for _ in range(3))


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("corpus", ["text", "random"])
def test_native_block_emitter_without_sequences(corpus, level):
    """An empty sequence list: all literals, Huffman-coded in a GLO block
    (text), or RAW where nothing wins over the plaintext (random
    bytes)."""
    arr = np.frombuffer(_corpora()[corpus][:9000], np.uint8)
    blk = _native_plain_jax(arr, level, True, _NO_SEQS)
    assert phdr.read_block_header(blk).block_type == (
        BLOCK_RAW if corpus == "random" else BLOCK_GLO)


@pytest.mark.parametrize("level", [1, 3, 6])
def test_native_block_emitter_falls_back_to_raw(level):
    """Sequences that cost more than they save: the block goes RAW."""
    rng = np.random.default_rng(level)
    arr = rng.integers(0, 256, 6000).astype(np.uint8)
    arr[3000:3006] = arr[1000:1006]
    seqs = (np.array([3000]), np.array([6]), np.array([2000]))
    blk = _native_plain_jax(arr, level, False, seqs)
    assert phdr.read_block_header(blk).block_type == BLOCK_RAW
    assert blk[8:] == arr.tobytes()


@pytest.mark.parametrize("level", [1, 3, 7])
@pytest.mark.parametrize("tail", [1, 5, 4099])
def test_native_block_emitter_on_tail_blocks(tail, level):
    arr = np.frombuffer(_words(tail, tail), np.uint8)
    _native_plain_jax(arr, level, True, _host_seqs(arr, level))


@pytest.mark.parametrize("level", [6, 7])
def test_native_block_emitter_on_tokens_of_one_value(level):
    """Every sequence the same token byte (runs of one length after one
    literal): the level-7 token section is a Huffman code of one symbol,
    one bit a token."""
    rng = np.random.default_rng(5)
    arr = np.repeat(rng.permutation(256).astype(np.uint8), 40)
    seqs = _host_seqs(arr, level)
    toks = (np.minimum(seqs[0] - np.concatenate(
        [[0], (seqs[0] + seqs[1])[:-1]]), 15) << 4) | np.minimum(
        seqs[1] - 5, 15)
    assert len(np.unique(toks)) == 1 and len(toks) >= 139
    _native_plain_jax(arr, level, False, seqs)


@pytest.mark.parametrize("bad,code", [
    ((np.array([10, 8]), np.array([6, 6]), np.array([1, 1])), -8),
    ((np.array([10]), np.array([4]), np.array([1])), -8),
    ((np.array([95]), np.array([6]), np.array([1])), -8),
    ((np.array([10]), np.array([6]), np.array([11])), -9),
    ((np.array([10]), np.array([6]), np.array([0])), -9),
])
def test_native_block_emitter_refuses_bad_sequences(bad, code):
    arr = np.zeros(100, np.uint8)
    with pytest.raises(ZxcError) as e:
        prt.emit_block(arr, 3, False, *bad)
    assert e.value.code == code
    with pytest.raises(ValueError):
        pbe.encode_chunk(arr, 3, pbe.DictState(arr[:0]), sequences=bad,
                         cap_len=EK.CAP)


def test_extras_stream_equals_varints_one_by_one():
    rng = np.random.default_rng(4)
    ll = rng.integers(0, 70000, 500) * (rng.random(500) < 0.3)
    mlb = rng.integers(0, 70000, 500) * (rng.random(500) < 0.3)
    for llm, mlm in ((15, 15), (255, 255)):
        vals = []
        for a, b in zip(ll.tolist(), mlb.tolist()):
            if a >= llm:
                vals.append(a - llm)
            if b >= mlm:
                vals.append(b - mlm)
        got = pbe._extras_stream(ll, mlb, llm, mlm)
        assert got == pbe._emit_extras(vals)
        assert got == jbe._extras_stream(ll, mlb, llm, mlm)


@pytest.mark.parametrize("name", ["words", "random"])
def test_hufflit_candidate_equals_jax(name):
    rng = np.random.default_rng(9)
    arr = (np.frombuffer(_words(9, 8000), np.uint8) if name == "words"
           else rng.integers(0, 256, 8000).astype(np.uint8))
    for budget in (100, 4000, 9000):
        assert (pbe.encode_block_hufflit(arr, budget)
                == jbe.encode_block_hufflit(arr, budget))


# ---------------------------------------------------------------------------
# compress_device
# ---------------------------------------------------------------------------

def _mixed(n: int) -> bytes:
    c = _corpora()
    return (_words(1, n // 2) + c["mix"] + c["runs"])[:n]


def _same_archive(data: bytes, **kw) -> bytes:
    arc = PE.compress_device(data, device="cpu", **kw)
    assert arc == jops.compress_device(data, **kw)
    assert Z.codec.frame.decompress(arc) == data
    return arc


@pytest.mark.parametrize("block_size", [16384, 65536])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_compress_device_equals_jax(level, block_size):
    _same_archive(_mixed(45000), level=level, block_size=block_size,
                  checksum=True)


@pytest.mark.parametrize("level", [6, 7])
def test_compress_device_ultra_levels_equal_jax(level):
    _same_archive(_words(level, 4096), level=level, block_size=4096)


def test_compress_device_xla_matcher_blocks_equal_jax():
    """Blocks over 64 KiB take the XLA matcher in both packages."""
    _same_archive(_mixed(100_000), level=3, block_size=128 << 10)


def test_compress_device_xla_matcher_by_env_equals_jax(monkeypatch):
    monkeypatch.setenv("ZXC_DEVICE_MATCHER", "xla")
    _same_archive(_mixed(20000), level=2, block_size=16384, checksum=True)


def test_compress_device_empty_and_incompressible():
    arc = _same_archive(b"", level=3)
    assert Z.codec.frame.decompress(arc) == b""
    rnd = np.random.default_rng(0).integers(0, 256, 40000,
                                            dtype=np.uint8).tobytes()
    arc = _same_archive(rnd, level=3, block_size=16384)
    assert len(arc) < len(rnd) + 16384


@pytest.mark.parametrize("tail", [1, 5, 4099])
def test_compress_device_tail_block_equals_jax(tail):
    _same_archive(_words(tail, 2 * 4096 + tail), level=3, block_size=4096)


def test_compress_device_decodes_through_decompress_e2e():
    data = _mixed(40000)
    arc = PE.compress_device(data, level=3, block_size=16384, device="cpu")
    assert Z.decompress_e2e(arc, device="cpu") == data
    assert Z.ops.decompress(arc, device="cpu") == data


def test_compress_device_launches_nothing_on_the_cpu():
    before = (EK.lcp.launches, EK.parse_walk.launches)
    ph = {}
    PE.compress_device(_mixed(20000), level=3, block_size=4096,
                       device="cpu", _phases=ph)
    assert (EK.lcp.launches, EK.parse_walk.launches) == before
    assert set(ph) == {"frame", "match", "parse", "parse.issue",
                       "parse.readback", "emit", "emit.cap", "emit.streams",
                       "emit.literals", "emit.hufflit", "d2h_bytes",
                       "emit.native_bytes"}


def test_compress_device_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot "
                    "be observed")
    for call in (lambda: PE.compress_device(b"abc" * 100),
                 lambda: PE.compress_device(b"abc" * 100, device="cuda"),
                 lambda: EK.lcp_pairs(np.zeros(8, np.uint8), [1], [0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="cuda or cpu"):
        PE.compress_device(b"abc", device="meta")
    with pytest.raises(ValueError):
        PE.compress_device(b"abc", block_size=5000, device="cpu")
    assert os.environ.get("ZXC_DEVICE_MATCHER", "lcp") == "lcp"
