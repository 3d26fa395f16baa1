"""The device entropy decode of the PyTorch port against the JAX package:
``ops/pivco_device.py`` (``plan_section``, ``pad_plans``,
``route_sections`` against JAX's ``routing_kernel``,
``decode_sections_device``), the deferred section parse
(``codec/block_decode.py``: ``DeferredSection``, ``parse_block(...,
defer_entropy=True)``), ``plan_frame(defer_entropy=True)`` with its
padding and guards, and ``ops.decompress(device_entropy=True)``.

The same inputs go through both packages on the CPU: sections encoded
from seeded numpy data with every tree shape of
``tests/test_pivco_device.py`` (deep skewed trees, flat roots, leaf pairs,
one-symbol codes, the full alphabet, a mixed batch), the same padded
arrays, and archives made by the port's native encoder (equal to the JAX
package's) at levels 3, 6 and 7, with a trained dictionary for the shared
table (enc_lit 3). Tolerance: byte equality (0) of every plan field,
padded array and decoded byte, and equal ``ZxcError`` codes on malformed
sections and corrupt archives.

Two JAX tests have no counterpart here: ``test_conformance_corpus_sections``
and ``test_decompress_device_entropy_reference_archive`` (and
``test_conformance_valid_device_entropy``) read the conformance vectors or
build the reference C encoder from the reference tree, which this
repository does not hold; the port's archives come from its own encoder
instead.
"""
import dataclasses

import numpy as np
import pytest
import torch

from zxc_tpu.codec import block_decode as jbd, frame as jframe
from zxc_tpu.codec import huffman as jh
from zxc_tpu.codec.frame import DecodeOpts, EncodeOpts
from zxc_tpu.ops import batch as JB, pivco_device as JPV
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import constants as C
from zxc_tpu_torch.codec import block_decode as pbd, huffman as ph
from zxc_tpu_torch.format import headers
from zxc_tpu_torch.ops import batch as PB, pivco_device as PPV

from test_torch_jax_native import jax_native


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _shape_data(name: str) -> list[np.ndarray]:
    """The sections of one tree shape (``tests/test_pivco_device.py``)."""
    if name == "skewed":
        rng = np.random.default_rng(0)
        return [np.clip(rng.zipf(1.3, 20000), 1, 250).astype(np.uint8)]
    if name.startswith("flat"):
        k = int(name[4:])
        return [np.tile(np.arange(1 << k, dtype=np.uint8), 700)]
    if name == "leaf_pairs":
        rng = np.random.default_rng(1)
        return [np.where(rng.random(30000) < 0.85, rng.integers(0, 2, 30000),
                         rng.integers(0, 256, 30000)).astype(np.uint8)]
    if name == "single":
        return [np.full(1000, 42, np.uint8), np.full(1, 7, np.uint8)]
    if name == "full":
        rng = np.random.default_rng(2)
        return [rng.integers(0, 256, 65536, dtype=np.uint8)]
    assert name == "mixed"
    rng = np.random.default_rng(3)
    return [np.clip(rng.zipf(1.5, 5000), 1, 255).astype(np.uint8),
            np.tile(np.arange(16, dtype=np.uint8), 100),
            np.full(333, 9, np.uint8),
            rng.integers(0, 256, 60000, dtype=np.uint8),
            np.where(rng.random(8192) < 0.9, 65, rng.integers(0, 256, 8192)
                     ).astype(np.uint8)]


SHAPES = ["skewed", "flat2", "flat3", "flat4", "flat6", "leaf_pairs",
          "single", "full", "mixed"]


def _sections_of(datas):
    """(payloads, ns, JAX trees, port trees) of sections encoded from
    ``datas``; both packages' encoders give the same payload bytes."""
    pays, ns, jts, pts = [], [], [], []
    for d in datas:
        cl = jh.build_code_lengths(np.bincount(d, minlength=256), jh.MAX_LEN)
        jt, pt = jh.build_tree(cl), ph.build_tree(cl)
        pay = np.frombuffer(jh.encode_payload(d, jt), np.uint8)
        assert ph.encode_payload(d, pt) == pay.tobytes()
        pays.append(pay)
        ns.append(len(d))
        jts.append(jt)
        pts.append(pt)
    return pays, ns, jts, pts


def _sections(name: str):
    datas = _shape_data(name)
    return (datas, *_sections_of(datas))


def _plan_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", SHAPES)
def test_plan_section_and_pad_plans_equal_jax(name):
    _, pays, ns, jts, pts = _sections(name)
    jplans = [JPV.plan_section(p, n, t) for p, n, t in zip(pays, ns, jts)]
    pplans = [PPV.plan_section(p, n, t) for p, n, t in zip(pays, ns, pts)]
    for a, b in zip(jplans, pplans):
        _plan_equal(a, b)
    for L in (None, 1 << 17):
        ja, *jrest = JPV.pad_plans(pays, jplans, L=L)
        pa, *prest = PPV.pad_plans(pays, pplans, L=L)
        assert jrest == prest
        for x, y in zip(ja, pa):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", SHAPES)
def test_route_sections_equals_jax_routing_kernel(name):
    datas, pays, ns, jts, _ = _sections(name)
    plans = [JPV.plan_section(p, n, t) for p, n, t in zip(pays, ns, jts)]
    args, L, RSEC, FLAT, rounds = JPV.pad_plans(pays, plans)
    rounds = max(rounds, jh.MAX_LEN + 1)
    want = np.asarray(JPV.routing_kernel(L, RSEC, FLAT, rounds)(*args))
    got = PPV.route_sections(*(torch.from_numpy(a) for a in args), L=L,
                             rounds=rounds)
    assert got.dtype == torch.uint8 and got.shape == (len(plans), L)
    assert np.array_equal(got.numpy(), want)
    for j, d in enumerate(datas):
        assert np.array_equal(want[j, :len(d)], d)
        assert not want[j, len(d):].any()     # padding lanes read 0


@pytest.mark.parametrize("name", SHAPES)
def test_decode_sections_device_equals_jax(name):
    datas, pays, ns, jts, pts = _sections(name)
    got = PPV.decode_sections_device(pays, ns, pts, device="cpu")
    want = JPV.decode_sections_device(pays, ns, jts)
    assert len(got) == len(want) == len(datas)
    for g, w, d, p, n, t in zip(got, want, datas, pays, ns, pts):
        assert g.dtype == np.uint8 and np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, d)
        assert np.array_equal(g, ph.decode_payload(p, n, t))
    assert PPV.decode_sections_device([], [], [], device="cpu") == []


def test_route_sections_on_out_of_range_tables_equals_jax():
    """Random tables inside the ranges JAX's packed words hold (node ids
    below 512, types 0-3, run offsets up to 2 RSEC, flat bases either side
    of the table, depths 0-11, any symbol): the port's gathers take JAX's
    clamps and index normalisation, and never index out of range."""
    L, RSEC, FLAT, B = 512, 64, 32, 4
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        tab = lambda lo, hi: rng.integers(lo, hi, (B, PPV.NN)).astype(np.int32)
        args = (rng.integers(0, 256, (B, RSEC), dtype=np.uint8),
                tab(0, PPV.NN), tab(0, PPV.NN), tab(0, 2 * RSEC), tab(0, 4),
                tab(-1000, 1000), tab(-FLAT, 2 * FLAT), tab(0, 12),
                rng.integers(0, 256, (B, FLAT), dtype=np.uint8),
                rng.integers(0, L + 1, B).astype(np.int32))
        want = np.asarray(JPV.routing_kernel(L, RSEC, FLAT, 12)(*args))
        got = PPV.route_sections(*(torch.from_numpy(a) for a in args), L=L,
                                 rounds=12)
        assert np.array_equal(got.numpy(), want)


def _err(call):
    try:
        call()
    except (JZxcError, Z.ZxcError) as e:
        return e.code, str(e)
    return None


def _malformed(name: str):
    """(payload, n, JAX tree, port tree) of one malformed section."""
    d = np.clip(np.random.default_rng(4).zipf(1.4, 4000), 1, 200
                ).astype(np.uint8)
    (pay, pay1), (n, n1), (jt, jt1), (pt, pt1) = _sections_of(
        [d, np.full(1000, 42, np.uint8)])
    if name == "truncated run":
        return pay[:len(pay) // 4], n, jt, pt
    if name == "count lies":
        return pay, 3 * n, jt, pt
    if name == "absent right child":    # a one-symbol code: no right child
        return np.full_like(pay1, 0xFF), n1, jt1, pt1
    if name == "absent left child":     # its children swapped
        swap = lambda t: dataclasses.replace(t, child=t.child[:, ::-1].copy())
        return np.zeros_like(pay1), n1, swap(jt1), swap(pt1)
    if name == "node overflow":
        big = lambda t: dataclasses.replace(
            t, sym=np.full(PPV.NN + 1, -1, t.sym.dtype))
        return pay, n, big(jt), big(pt)
    assert name == "empty section"
    return pay, 0, jt, pt


@pytest.mark.parametrize("name", ["truncated run", "count lies",
                                  "absent right child", "absent left child",
                                  "node overflow", "empty section"])
def test_malformed_sections_raise_as_jax_does(name):
    p, n, jt, pt = _malformed(name)
    want = _err(lambda: JPV.plan_section(p, n, jt))
    assert want is not None
    assert _err(lambda: PPV.plan_section(p, n, pt)) == want
    assert _err(lambda: PPV.decode_sections_device(
        [p], [n], [pt], device="cpu")) == want


def _glo_blocks(arc: bytes):
    """(GnrHeader, descriptors, payload) of every GLO block of ``arc``
    (the port's header readers)."""
    fh = headers.read_file_header(arc)
    pos = C.FILE_HEADER_SIZE
    out = []
    while pos + C.BLOCK_HEADER_SIZE <= len(arc):
        bh = headers.read_block_header(arc, pos)
        if bh.block_type == C.BLOCK_EOF:
            break
        start = pos + C.BLOCK_HEADER_SIZE
        payload = np.frombuffer(arc[start:start + bh.comp_size], np.uint8)
        pos = start + bh.comp_size + (C.BLOCK_CHECKSUM_SIZE
                                      if fh.has_checksum else 0)
        if bh.block_type == C.BLOCK_GLO:
            nd = C.GNR_HEADER_SIZE + C.GLO_SECTIONS * C.SECTION_DESC_SIZE
            gh, descs = headers.read_gnr_header(payload[:nd].tobytes(),
                                                C.GLO_SECTIONS)
            out.append((gh, descs, payload))
    return out


@pytest.mark.parametrize("level", [6, 7])
def test_sections_of_the_ports_own_archives(level):
    rng = np.random.default_rng(5)
    body = np.clip(rng.zipf(1.6, 60000), 1, 255).astype(np.uint8).tobytes()
    arc = Z.compress(body, Z.EncodeOpts(level=level, block_size=16384))
    assert arc == jframe.compress(body, EncodeOpts(level=level,
                                                   block_size=16384))
    pays, ns, pts, jts = [], [], [], []
    for gh, descs, payload in _glo_blocks(arc):
        sz_lit, raw_lit = descs[0]
        if gh.enc_lit != C.ENC_HUFFMAN or not raw_lit:
            continue
        p = C.GNR_HEADER_SIZE + C.GLO_SECTIONS * C.SECTION_DESC_SIZE
        lit = payload[p:p + sz_lit]
        packed = bytes(lit[:C.HUF_TABLE_SIZE])
        pays.append(lit[C.HUF_TABLE_SIZE:])
        ns.append(raw_lit)
        pts.append(ph.build_tree_packed(packed))
        jts.append(jh.build_tree_packed(packed))
    assert pays, f"level {level} archive had no PivCo literal section"
    got = PPV.decode_sections_device(pays, ns, pts, device="cpu")
    want = JPV.decode_sections_device(pays, ns, jts)
    for g, w, p, n, t in zip(got, want, pays, ns, pts):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, ph.decode_payload(p, n, t))


def _entropy_body():
    rng = np.random.default_rng(6)
    return (np.clip(rng.zipf(1.6, 120000), 1, 255).astype(np.uint8).tobytes()
            + b"repetitive words flow " * 3000
            + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes())


def test_parse_block_defers_as_jax_does():
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=7, block_size=16384))
    deferred = 0
    for gh, descs, payload in _glo_blocks(arc):
        a = jbd.parse_block(C.BLOCK_GLO, payload, 16384, None, True)
        b = pbd.parse_block(C.BLOCK_GLO, payload, 16384, None, True)
        host = pbd.parse_block(C.BLOCK_GLO, payload, 16384)[3]
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
        if isinstance(b[3], pbd.DeferredSection):
            assert isinstance(a[3], jbd.DeferredSection)
            assert np.array_equal(a[3].payload, b[3].payload)
            assert a[3].n == b[3].n == len(b[3]) == len(host)
            assert np.array_equal(a[3].tree.code_len, b[3].tree.code_len)
            assert np.array_equal(b[3].decode(), a[3].decode())
            assert np.array_equal(b[3].decode(), host)
            deferred += 1
        else:
            assert np.array_equal(a[3], b[3]) and np.array_equal(b[3], host)
    assert deferred
    # a PivCo section shorter than its lengths header
    stream = np.zeros(C.HUF_TABLE_SIZE - 1, np.uint8)
    want = _err(lambda: jbd._decode_literal_section(
        C.ENC_HUFFMAN, stream, 10, 16384, None, True))
    assert want is not None
    assert _err(lambda: pbd._decode_literal_section(
        C.ENC_HUFFMAN, stream, 10, 16384, None, True)) == want


def _deferred_plans(arc, do=None):
    pdo = (Z.DecodeOpts(do.checksum, do.dict_content, do.dict_huf)
           if do else None)
    return (JB.plan_frame(arc, do, defer_entropy=True),
            PB.plan_frame(arc, pdo, defer_entropy=True))


@pytest.mark.parametrize("block", [4096, 16384])
def test_plan_frame_defers_and_pads_as_jax_does(block):
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=3, block_size=block))
    jp, pp = _deferred_plans(arc)
    assert pp.deferred and jp.n_blocks == pp.n_blocks
    for f in ("ll", "ml", "off"):
        for x, y in zip(getattr(jp, f), getattr(pp, f)):
            assert np.array_equal(x, y)
    assert jp.totals == pp.totals and jp.max_lit == pp.max_lit
    for x, y in zip(jp.lit, pp.lit):
        assert isinstance(x, jbd.DeferredSection) == isinstance(
            y, pbd.DeferredSection)
        if isinstance(y, pbd.DeferredSection):
            assert np.array_equal(x.payload, y.payload) and x.n == y.n
        else:
            assert np.array_equal(x, y)
    S, L = PB._pow2(pp.max_seq), PB._pow2(pp.max_lit)
    idx = range(0, min(8, pp.n_blocks))
    for x, y in zip(JB._pad_batch(jp, idx, S, L, B=8),
                    PB._pad_batch(pp, idx, S, L, B=8)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the resolvers never see a deferred section
    for plan in (jp, pp):
        plan.resolve()
        assert plan.pieces == [None] * plan.n_blocks
    with pytest.raises(ValueError, match="defer_entropy"):
        PB.resolve_serial(pp)
    assert PB.decode_plan_device(pp, batch=8, device="cpu") \
        == JB.decode_plan_device(jp, batch=8) == body


@pytest.mark.parametrize("level,block", [(3, 4096), (3, 16384), (7, 4096),
                                         (7, 16384)])
def test_decompress_device_entropy_equals_jax(level, block):
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=level, block_size=block,
                                        checksum=True))
    assert any(gh.enc_lit == C.ENC_HUFFMAN for gh, _, _ in _glo_blocks(arc))
    ph_ = {}
    got = Z.ops.decompress(arc, Z.DecodeOpts(checksum=True), device="cpu",
                           device_entropy=True, _phases=ph_)
    assert got == JB.decompress(arc, DecodeOpts(checksum=True),
                                device_entropy=True) == body
    assert ph_["route"] == "chase" and ph_["entropy_sections"] > 0
    n_sec = sum(1 for gh, d, _ in _glo_blocks(arc)
                if gh.enc_lit == C.ENC_HUFFMAN and d[0][1])
    assert ph_["entropy_sections"] == n_sec
    assert ph_["entropy_symbols"] == sum(
        d[0][1] for gh, d, _ in _glo_blocks(arc)
        if gh.enc_lit == C.ENC_HUFFMAN)
    assert ph_["entropy"] >= 0


def test_device_entropy_forces_the_chase_route():
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=3, block_size=8192))
    for kw in (dict(use_serial=True), dict(use_serial=True, variant=21),
               dict(use_pieces=True)):
        ph_ = {}
        assert Z.ops.decompress(arc, device="cpu", device_entropy=True,
                                _phases=ph_, **kw) == body
        assert ph_["route"] == "chase" and ph_["entropy_sections"] > 0
        jkw = {k: v for k, v in kw.items() if k != "variant"}
        assert JB.decompress(arc, device_entropy=True, **jkw) == body


def _dict_case(kind: str):
    """(body, content, 128-byte table, block). ``trained``: the JAX
    test's dictionary from ``train_dict`` / ``train_dict_huf``, whose
    smoothed table gives all 256 bytes 8-bit codes, so the inline table
    wins every block (enc_lit 2). ``fitted``: a table fitted to a
    match-free literal soup (as ``tests/test_golden.py`` builds its
    dictionary case), which wins the literal auction (enc_lit 3)."""
    from zxc_tpu.codec.dict_train import train_dict, train_dict_huf
    if kind == "trained":
        rng = np.random.default_rng(7)
        samples = [(b"GET /api/v1/resource HTTP/1.1 host: example "
                    + np.clip(rng.zipf(1.7, 900), 1, 127).astype(np.uint8)
                    .tobytes()) for _ in range(24)]
        content = train_dict(samples, 1024)
        return (samples[3] + samples[11] + samples[19], content,
                train_dict_huf(samples, content), 16384)
    rng = np.random.default_rng(12)
    letters = np.frombuffer(b"etaoinshrdlu zxcfmt", np.uint8)
    probs = 1.0 / np.arange(1, len(letters) + 1) ** 0.8
    soup = rng.choice(letters, size=3000, p=probs / probs.sum()).tobytes()
    content = (b"wire-format golden dictionary seed: common prefixes "
               b"<row id='000000'><field>abcdefgh</field></row>\n" * 12)[:1024]
    cl = jh.build_code_lengths(np.bincount(np.frombuffer(soup, np.uint8),
                                           minlength=256), 8)
    return soup * 3, content, jh.pack_lengths(cl), 4096


@pytest.mark.parametrize("kind", ["trained", "fitted"])
def test_decompress_device_entropy_dict(kind):
    """A dictionary archive through the device route; ``fitted`` takes
    the shared table (enc_lit 3), deferred with the dictionary's tree."""
    body, content, huf, block = _dict_case(kind)
    arc = Z.compress(body, Z.EncodeOpts(level=6, block_size=block,
                                        dict_content=content, dict_huf=huf))
    enc = [gh.enc_lit for gh, _, _ in _glo_blocks(arc)]
    assert (C.ENC_HUFFMAN_DICT in enc) == (kind == "fitted")
    do = DecodeOpts(dict_content=content, dict_huf=huf)
    jp, pp = _deferred_plans(arc, do)
    if kind == "fitted":
        dict_tree = ph.build_tree_packed(bytes(huf))
        assert any(isinstance(l, pbd.DeferredSection) and l.tree is dict_tree
                   for l in pp.lit)
    for x, y in zip(jp.lit, pp.lit):
        if isinstance(y, pbd.DeferredSection):
            assert np.array_equal(x.payload, y.payload) and x.n == y.n
    ph_ = {}
    got = Z.ops.decompress(arc, Z.DecodeOpts(dict_content=content,
                                             dict_huf=huf),
                           device="cpu", device_entropy=True, _phases=ph_)
    assert got == JB.decompress(arc, do, device_entropy=True) == body
    assert ph_["entropy_sections"] == enc.count(C.ENC_HUFFMAN) \
        + enc.count(C.ENC_HUFFMAN_DICT)


def test_corrupt_archives_raise_as_jax_does():
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=7, block_size=16384,
                                        checksum=True))
    bad = bytearray(arc)
    bad[len(bad) // 2] ^= 0x41
    cases = [(bytes(bad), True), (arc[:len(arc) // 2], False),
             (arc[:len(arc) - 3], False)]
    for a, ck in cases:
        want = _err(lambda: JB.decompress(a, DecodeOpts(checksum=ck),
                                          device_entropy=True))
        assert want is not None
        assert _err(lambda: Z.ops.decompress(
            a, Z.DecodeOpts(checksum=ck), device="cpu",
            device_entropy=True))[0] == want[0]


def test_flipped_section_bytes_without_checksums_match_jax():
    """Bytes flipped inside a PivCo literal section (no checksum to catch
    them): both packages decode the same bytes or raise the same code, at
    plan time or from the expansion; neither falls back to the host."""
    body = _entropy_body()
    arc = Z.compress(body, Z.EncodeOpts(level=7, block_size=16384))
    nd = C.GNR_HEADER_SIZE + C.GLO_SECTIONS * C.SECTION_DESC_SIZE
    pos = C.FILE_HEADER_SIZE
    while True:     # the first PivCo literal section's node runs
        bh = headers.read_block_header(arc, pos)
        start = pos + C.BLOCK_HEADER_SIZE
        pos = start + bh.comp_size
        if bh.block_type != C.BLOCK_GLO:
            continue
        gh, descs = headers.read_gnr_header(arc[start:start + nd],
                                            C.GLO_SECTIONS)
        if gh.enc_lit == C.ENC_HUFFMAN:
            off = start + nd + C.HUF_TABLE_SIZE
            size = descs[0][0] - C.HUF_TABLE_SIZE
            break
    rng = np.random.default_rng(11)
    for k in range(6):
        bad = bytearray(arc)
        bad[off + int(rng.integers(0, size))] ^= 1 << int(rng.integers(0, 8))
        bad = bytes(bad)
        try:
            want = JB.decompress(bad, device_entropy=True)
        except JZxcError as e:
            want = e.code
        try:
            got = Z.ops.decompress(bad, device="cpu", device_entropy=True)
        except Z.ZxcError as e:
            got = e.code
        assert got == want, k


def test_no_cuda_means_the_entropy_route_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot be "
                    "observed")
    arc = Z.compress(_entropy_body(), Z.EncodeOpts(level=3,
                                                   block_size=16384))
    with pytest.raises(RuntimeError, match="CUDA"):
        Z.ops.decompress(arc, device_entropy=True)
    _, pays, ns, _, pts = _sections("flat3")
    with pytest.raises(RuntimeError, match="CUDA"):
        PPV.decode_sections_device(pays, ns, pts)
