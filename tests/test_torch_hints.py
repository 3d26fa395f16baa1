"""Hint path of the PyTorch port against the JAX package: the ``.zxh``
files, the v27 kernel's plain version and ``decompress_e2e(hint=)``.

The same archives (made by ``zxc_tpu.codec.frame.compress`` from numpy
data with fixed seeds) and the same hint files go through
``zxc_tpu.ops`` (Pallas in interpret mode) and ``zxc_tpu_torch`` on the
CPU (the kernels' plain versions). Tolerance: exact equality of every
hint array, every shipped buffer, the kernels' bytes (JAX's int32 output
reduced mod 256), the decoded bytes and the fingerprints.
"""
import struct

import numpy as np
import pytest
import torch

from zxc_tpu import runtime as jrt
from zxc_tpu.codec import frame as jframe
from zxc_tpu.codec.frame import EncodeOpts, DecodeOpts
from zxc_tpu.format import hashes as jhashes
from zxc_tpu.ops import device_pipeline as JDP, hints as JH
from zxc_tpu.ops import pallas_decode as PD
from zxc_tpu.errors import ZxcError as JZxcError

import zxc_tpu_torch as Z
from zxc_tpu_torch import runtime as prt
from zxc_tpu_torch.codec import frame as pframe
from zxc_tpu_torch.ops import copy_engine as CE, device_pipeline as PDP
from zxc_tpu_torch.ops import hints as PH

from test_torch_cuda import random_group, flat_group
from test_torch_copy_engine import _loop_oracle
from test_torch_jax_native import jax_native

BLOCK = 16384


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


def _case(name):
    """(data, archive, decode opts) of a named corpus."""
    if name == "dict":
        data, eo, do = _dict_case()
        return data, jframe.compress(data, eo), do
    if name == "checksum":
        data = _mixed_body(31, BLOCK * 6 - 123)
        return data, jframe.compress(data, EncodeOpts(
            level=5, block_size=BLOCK, checksum=True)), \
            DecodeOpts(checksum=True)
    if name == "64k":
        data = _mixed_body(32, 65536 * 2 + 4321)
        return data, jframe.compress(data, EncodeOpts(
            level=3, block_size=65536)), None
    data = _mixed_body(30, BLOCK * 7 - 55)      # 7 blocks: a ragged tail
    return data, jframe.compress(data, EncodeOpts(level=3,
                                                  block_size=BLOCK)), None


_ARRAYS = ("totals", "litlen", "litrows", "plan_off", "qs", "qbase", "tq",
           "pctrl", "plans")


# ---------------------------------------------------------------------------
# host layers: rapidhash64, host frame decode, the .zxh files
# ---------------------------------------------------------------------------

def test_native_rapidhash64_equals_jax():
    rng = np.random.default_rng(1)
    for n in (0, 3, 8, 16, 17, 100, 112, 113, 4096, 70001):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert prt.rapidhash64(blob) == jhashes.rapidhash64(blob)
        assert prt.rapidhash64(np.frombuffer(blob, np.uint8)) == \
            jhashes.rapidhash64(blob)


@pytest.mark.parametrize("name", ["plain", "dict", "checksum"])
def test_host_frame_decode_equals_jax(name):
    data, arc, do = _case(name)
    assert pframe.get_decompressed_size(arc) == \
        jframe.get_decompressed_size(arc) == len(data)
    pdo = (pframe.DecodeOpts(do.checksum, do.dict_content, do.dict_huf)
           if do else None)
    for threads in (1, 3):
        assert pframe.decompress(arc, pdo, threads=threads) == data
    out = np.zeros(len(data) + 7, np.uint8)
    assert pframe.decompress(arc, pdo, out=out) == len(data)
    assert out[:len(data)].tobytes() == data
    blobs = [arc[:len(arc) // 2], arc[:20]]
    if name == "checksum":   # without checksums a flip may decode
        bad = bytearray(arc)
        bad[len(bad) // 2] ^= 0x5A
        blobs.append(bytes(bad))
    for blob in blobs:
        with pytest.raises(Z.ZxcError) as e:
            pframe.decompress(blob, pframe.DecodeOpts(checksum=True,
                              dict_content=pdo.dict_content if pdo else None,
                              dict_huf=pdo.dict_huf if pdo else None))
        with pytest.raises(JZxcError) as j:
            jframe.decompress(blob, DecodeOpts(checksum=True,
                              dict_content=do.dict_content if do else None,
                              dict_huf=do.dict_huf if do else None))
        assert e.value.code == j.value.code


@pytest.mark.parametrize("variant", [19, 26])
@pytest.mark.parametrize("name", ["plain", "dict"])
def test_jax_hints_load_in_port_and_port_hints_in_jax(tmp_path, name,
                                                      variant):
    data, arc, do = _case(name)
    jpath = JH.write_hints(arc, str(tmp_path / "j.zxh"), do, variant=variant)
    ppath = PH.write_hints(arc, str(tmp_path / "p.zxh"), do, variant=variant)
    jj, pp = JH.HintFile(jpath, arc), PH.HintFile(ppath, arc)
    pj, jp = PH.HintFile(jpath, arc), JH.HintFile(ppath, arc)
    assert pp.geo.variant == variant
    for a, b in ((pj, jj), (jp, jj), (pp, jj)):
        assert vars(a.geo) == vars(b.geo)
        for f in _ARRAYS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f
    for B in (4, 16):
        for x, y in zip(pp.flat_geometry(B), jj.flat_geometry(B)):
            assert np.array_equal(x, y)


def test_port_hint_body_carries_checksums(tmp_path):
    data, arc, _ = _case("plain")
    path = PH.write_hints(arc, str(tmp_path / "p.zxh"))
    raw = open(path, "rb").read()
    body = raw[PH.HEADER_SIZE:]
    assert struct.unpack_from("<I", raw, 12)[0] & PH.FLAG_BODY_ZXC
    assert jframe.headers.read_file_header(body).has_checksum
    jpath = JH.write_hints(arc, str(tmp_path / "j.zxh"))
    jbody = open(jpath, "rb").read()[JH.HEADER_SIZE:]
    assert not jframe.headers.read_file_header(jbody).has_checksum
    # the same bytes inside
    assert jframe.decompress(body) == jframe.decompress(jbody)


def _rewrite_body(path: str, out: str, edit) -> None:
    """A copy of the hint at ``path`` whose decoded body is changed by
    ``edit(hint_fields, body_bytearray)`` and re-framed so that its header
    and body hash stay valid."""
    raw = open(path, "rb").read()
    f = list(PH._HDR.unpack(raw[:PH.HEADER_SIZE]))
    body = bytearray(jframe.decompress(raw[PH.HEADER_SIZE:]))
    edit(f, body)
    comp = jframe.compress(bytes(body), EncodeOpts(level=1,
                                                   block_size=1 << 20))
    f[13] = jhashes.rapidhash64(comp[:4096]) ^ len(comp)
    with open(out, "wb") as fo:
        fo.write(PH._HDR.pack(*f) + comp)


def _poke(field: str, value: int, index: int = 0):
    """An edit that sets element ``index`` of one body array."""
    def edit(f, body):
        nb, K, MAXQ, NG32, NST = f[6], f[7], f[9], f[10], f[12]
        sizes = {"totals": 8 * nb, "litlen": 8 * nb, "litrows": 8 * nb,
                 "plan_off": 8 * (nb + 1), "qs": 4 * nb * (NST + 1),
                 "qbase": 4 * nb * MAXQ}
        off = 0
        for name, size in sizes.items():
            if name == field:
                width = 8 if name in ("totals", "litlen", "litrows",
                                      "plan_off") else 4
                at = off + width * index
                body[at:at + width] = value.to_bytes(width, "little",
                                                     signed=True)
                return
            off += size
        raise KeyError(field)
    return edit


@pytest.mark.parametrize("variant", [19, 26])
def test_loader_rejects_what_jax_accepts(tmp_path, variant):
    """qbase is bounded unmasked by the window a quad may read: the JAX
    loader masks bit 24 and lets the (1<<24)|64 flip through."""
    data, arc, _ = _case("plain")
    path = JH.write_hints(arc, str(tmp_path / "a.zxh"), variant=variant)
    h = PH.HintFile(path, arc)
    hi = h.geo.RLP - 128 + (BLOCK // 128 if variant == 26 else 0)
    assert int(np.asarray(h.qbase).max()) <= hi
    flip = str(tmp_path / "flip.zxh")
    _rewrite_body(path, flip, _poke("qbase", (1 << 24) | 64))
    JH.HintFile(flip, arc)
    for bad in ((1 << 24) | 64, -16, hi + 1):
        _rewrite_body(path, flip, _poke("qbase", bad, index=1))
        with pytest.raises(Z.ZxcError, match="qbase"):
            PH.HintFile(flip, arc)
        with pytest.raises(Z.ZxcError):
            Z.decompress_e2e(arc, device="cpu", hint=flip, dispatch=4)
    _rewrite_body(path, flip, _poke("qbase", hi, index=1))
    PH.HintFile(flip, arc)       # the edge itself is a valid window
    _rewrite_body(path, flip, _poke("litrows", int(h.litrows[0]) + 1))
    with pytest.raises(Z.ZxcError, match="litrows"):
        PH.HintFile(flip, arc)


def test_loader_rejects_corrupt_files(tmp_path):
    data, arc, _ = _case("plain")
    other = jframe.compress(data[:BLOCK * 3], EncodeOpts(level=3,
                                                         block_size=BLOCK))
    path = PH.write_hints(arc, str(tmp_path / "a.zxh"))
    raw = open(path, "rb").read()
    cases = {"other archive": (path, other)}
    for name, blob in (("truncated", raw[:len(raw) // 2]),
                       ("header only", raw[:PH.HEADER_SIZE - 1]),
                       ("empty", b""),
                       ("magic", b"X" + raw[1:]),
                       ("body byte", raw[:300] + bytes([raw[300] ^ 1])
                        + raw[301:])):
        p = str(tmp_path / f"{name}.zxh")
        open(p, "wb").write(blob)
        cases[name] = (p, arc)
    for name, (p, a) in cases.items():
        with pytest.raises(Z.ZxcError):
            PH.HintFile(p, a)
        with pytest.raises(Z.ZxcError):
            Z.decompress_e2e(a, device="cpu", hint=p)


# ---------------------------------------------------------------------------
# v27: the plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _jax_v27(args, block, RLP, K=2):
    qs, qbase, loff, pctrl, tq, flat = args
    kern = PD.v27_kernel(block, qbase.shape[1], RLP, flat.shape[0], K, True)
    return np.asarray(kern(qs, qbase, loff, pctrl, tq, flat))


@pytest.mark.parametrize("name", ["plain", "64k", "dict"])
def test_v27_equals_jax_on_shipped_groups(tmp_path, name):
    data, arc, do = _case(name)
    pdo = (pframe.DecodeOpts(do.checksum, do.dict_content, do.dict_huf)
           if do else None)
    path = PH.write_hints(arc, str(tmp_path / "a.zxh"), pdo)
    hint = PH.HintFile(path, arc)
    walk = PDP.walk_frame(arc, pdo)
    pipe = PDP.DevicePipeline(walk, arc, dispatch=4, variant=None, hint=hint)
    assert pipe.variant == 27
    jhint = JH.HintFile(path, arc)
    jw = JDP.walk_frame(arc, do)
    jloff, jlr32, rows_tot = jhint.flat_geometry(4)
    for g in range(pipe.n_groups):
        buf, args = pipe.prep_group(g)
        # the flat buffer as the JAX pipeline's batch replay builds it
        jflat = np.zeros((rows_tot, 128), np.uint8)
        i0, i1 = 4 * g, min(4 * g + 4, walk.n_blocks)
        assert jrt.v19_lit8_load_batch(
            np.frombuffer(arc, np.uint8), jw.pos, jw.comp, jw.typ, i0, i1, 1,
            jw.block_size, jhint.plans, np.asarray(jhint.plan_off),
            np.asarray(jhint.litlen), jflat, jloff, jhint.geo.RLP,
            zrows=jlr32, dict_buf=jw.dict_buf, dict_cl=jw.dict_cl) == 0
        assert np.array_equal(args[5].numpy(), jflat)
        np_args = tuple(t.numpy() for t in args)
        jout = _jax_v27(np_args, walk.block_size, pipe.RLP, pipe.K)
        port = CE.v27(*args, RLP=pipe.RLP, K=pipe.K)
        assert np.array_equal(port.numpy(), jout.astype(np.uint8))
        flat = port.numpy().reshape(4, -1)
        got = b"".join(flat[j, :buf.totals[j]].tobytes()
                       for j in range(i1 - i0))
        assert got == data[i0 * walk.block_size:i0 * walk.block_size
                           + len(got)]


@pytest.mark.parametrize("seed", [3, 4])
def test_v27_hand_built_odd_litrows(seed):
    """Random flat layouts with odd litrows: windows reach into the next
    block's rows, exactly as the JAX kernel's fixed RLP-row DMA does. Small
    literal values keep every tile sum <= 255 (the JAX kernel's bf16
    window rows are exact there)."""
    group = random_group(seed, B=3, NST=2, MAXQ=8, RLP=128, K=2,
                         self_ref=True, lit_max=3)
    args, RLP = flat_group(seed, group)
    t = CE.group_from_numpy(*args)
    port = CE.v27(*t, RLP=RLP).numpy()
    jout = _jax_v27(args, 2 * 16384, RLP)
    assert np.array_equal(port, jout.astype(np.uint8))
    win = CE.flat_windows(t[2], t[5], RLP).numpy()
    want = _loop_oracle(args[0], args[1], args[3], args[4], win, 2, True)
    assert np.array_equal(port, (want & 255).astype(np.uint8))
    assert (np.asarray(args[1]) >= RLP).any()     # own-output windows too


def test_v27_garbage_loff_reads_zero_rows():
    group = random_group(9, B=4, NST=2, MAXQ=8, RLP=128, K=2, self_ref=True)
    args, RLP = flat_group(9, group, garbage=True)
    args = list(args)
    args[2][:2] = (-40, args[5].shape[0] - 10)   # negative and past the end
    t = CE.group_from_numpy(*args)
    win = CE.flat_windows(t[2], t[5], RLP).numpy()
    assert not win[0].any() and not win[1, 10:].any()
    want = _loop_oracle(args[0], args[1], args[3], args[4], win, 2, True)
    assert np.array_equal(CE.v27(*t, RLP=RLP).numpy(),
                          (want & 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# decompress_e2e(hint=) against the JAX package and the plaintext
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "dict", "checksum"])
@pytest.mark.parametrize("variant", [27, 26, 19])
def test_hint_e2e_equals_jax_and_plaintext(tmp_path, name, variant):
    data, arc, do = _case(name)
    pdo = (pframe.DecodeOpts(do.checksum, do.dict_content, do.dict_huf)
           if do else None)
    path = PH.write_hints(arc, str(tmp_path / "a.zxh"), pdo,
                          variant=19 if variant == 19 else 26)
    kw = dict(dispatch=4, variant=None if variant == 27 else variant)
    out = Z.decompress_e2e(arc, pdo, device="cpu", hint=path, **kw)
    assert out == data
    jkw = dict(dispatch=4, variant=27 if variant == 27 else variant,
               interpret=True)
    assert out == JDP.decompress_e2e(arc, do, hint=path, **jkw)
    fp = Z.decompress_e2e(arc, pdo, device="cpu", hint=path,
                          _collect="fingerprint", **kw)
    assert fp == JDP.decompress_e2e(arc, do, hint=path,
                                    _collect="fingerprint", **jkw)
    assert fp == Z.decompress_e2e(arc, pdo, device="cpu", dispatch=4,
                                  _collect="fingerprint")


def test_v26_hint_sizing_covers_every_window(tmp_path):
    """Blocks with few literal rows: the JAX package's v26 sizing (RLP
    from litrows only) leaves quad windows past RLP and its write_hints
    fails; the port's sizes RLP to the highest window and decodes."""
    data, arc, do = _case("checksum")
    with pytest.raises(JZxcError) as j:
        JH.write_hints(arc, str(tmp_path / "j.zxh"), do)
    assert j.value.code == -10
    pdo = pframe.DecodeOpts(checksum=True)
    path = PH.write_hints(arc, str(tmp_path / "p.zxh"), pdo)
    h = PH.HintFile(path, arc)
    assert h.geo.RLP % 32 == 0 and h.litrows.max() + 1 < h.geo.RLP
    assert Z.decompress_e2e(arc, pdo, device="cpu", hint=h) == data
    JH.HintFile(path, arc)       # the JAX package loads it


def test_hint_variant_rules(tmp_path):
    data, arc, _ = _case("plain")
    p26 = PH.write_hints(arc, str(tmp_path / "a26.zxh"))
    p19 = PH.write_hints(arc, str(tmp_path / "a19.zxh"), variant=19)
    w = PDP.walk_frame(arc)
    h26, h19 = PH.HintFile(p26, arc), PH.HintFile(p19, arc)
    assert h26.geo.RLP % 32 == 0
    picks = {(h26, None): 27, (h26, 27): 27, (h26, 26): 26,
             (h19, None): 19, (h19, 27): 19, (h19, 19): 19}
    for (h, v), want in picks.items():
        assert PDP.DevicePipeline(w, arc, variant=v, hint=h).variant == want
    for h, v in ((h26, 19), (h19, 26)):
        with pytest.raises(ValueError, match="cannot run"):
            Z.decompress_e2e(arc, device="cpu", hint=h, variant=v)
    with pytest.raises(ValueError):
        PH.write_hints(arc, str(tmp_path / "x.zxh"), variant=27)
    # a hint of a frame with another block size does not fit the frame
    arc64 = jframe.compress(data, EncodeOpts(level=3, block_size=65536))
    h = PH.HintFile(p26, arc)
    with pytest.raises(Z.ZxcError, match="geometry"):
        PDP.DevicePipeline(PDP.walk_frame(arc64), arc64, hint=h)


def test_hint_device_pages_are_cached_and_padded(tmp_path):
    data, arc, _ = _case("plain")                # 7 blocks
    h = PH.HintFile(PH.write_hints(arc, str(tmp_path / "a.zxh")), arc)
    a = h.device_ctrl(1, 4, "cpu")
    assert all(x is y for x, y in zip(a, h.device_ctrl(1, 4, "cpu")))
    qs, qbase, pctrl, tq = a
    assert np.array_equal(qs[:3].numpy(), h.qs[4:7])
    assert not qs[3].any()                        # padding: no quads
    assert (pctrl[3] == 1 << 7).all()
    loff = h.device_loff(1, 4, "cpu")
    assert loff.dtype == torch.int32
    assert np.array_equal(loff[:3].numpy(), h.flat_geometry(4)[0][4:7])
    assert loff[3] == 0
    # the pages are copies, not views of the file's arrays
    qs[0, 0] = 99
    assert h.qs[4, 0] == 0
    h.release_device()
    assert h.device_ctrl(1, 4, "cpu")[0][0, 0] == 0


def test_hint_pool_reuse_zeroes_stale_rows(tmp_path):
    """With two pool slots group 2 reuses group 0's buffers: the per-block
    lit8 (v26 hint) and the flat buffer (v27) must equal a fresh prep."""
    rng = np.random.default_rng(47)
    data = (rng.integers(0, 256, BLOCK * 2, dtype=np.uint8).tobytes()
            + _mixed_body(47, BLOCK * 3) + b"z" * BLOCK)
    arc = jframe.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    h = PH.HintFile(PH.write_hints(arc, str(tmp_path / "a.zxh")), arc)
    w = PDP.walk_frame(arc)
    for variant in (26, 27):
        pipe = PDP.DevicePipeline(w, arc, dispatch=2, variant=variant,
                                  hint=h)

        def consume(args, tot, g, carry):
            carry.append(args[-1].clone())
            return carry

        seen = pipe.run(consume, torch.device("cpu"), pools=2, carry=[])
        assert len(seen) == 3
        for g, lit in enumerate(seen):
            assert torch.equal(lit, pipe.prep_group(g)[1][-1])
