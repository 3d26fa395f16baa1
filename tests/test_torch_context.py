"""The rest of the port's device surface against the JAX package:
``Dctx`` (``zxc_tpu_torch/context.py``), the phase collector and trace
(``zxc_tpu_torch/profiling.py``) and the compile-and-run check
``zxc_tpu_torch/entry.py`` against ``__graft_entry__.entry``.

The same archives (the port's native encoder, equal to the JAX
package's, from seeded numpy data) and the same example batch go through
both packages on the CPU. Tolerance: exact equality of the decoded bytes
and of the expansion's output, totals and error bits.
"""
import glob
import json

import numpy as np
import pytest
import torch

from zxc_tpu import Dctx as JDctx, ops as jops, profiling as jprof
from zxc_tpu.codec.dict_train import dict_train
from zxc_tpu.errors import ZxcError as JZxcError

import __graft_entry__ as graft
import zxc_tpu_torch as Z
from zxc_tpu_torch import constants as C, entry, profiling
from zxc_tpu_torch.format import headers

from test_torch_jax_native import jax_native
from test_torch_pivco_device import _entropy_body


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _dict_case():
    rng = np.random.default_rng(21)
    samples = [(b"common prefix " + rng.integers(0, 96, 300, dtype=np.uint8)
                .tobytes()) for _ in range(50)]
    d = dict_train(samples, target_size=4096)
    return b"".join(samples)[:40_000], d.content, d.huf_lengths


@pytest.mark.parametrize("case", ["plain", "checksum", "dict"])
def test_dctx_equals_jax(case):
    content = huf = None
    if case == "dict":
        data, content, huf = _dict_case()
    else:
        data = _entropy_body()
    ck = case == "checksum"
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=8192,
                                        checksum=ck, dict_content=content,
                                        dict_huf=huf))
    ctxs = [JDctx(checksum=ck, device=True), Z.Dctx(checksum=ck,
                                                    device="cpu"),
            Z.Dctx(checksum=ck, device=False)]
    if content is not None:
        for c in ctxs:
            assert c.attach_dict(content, huf) is c
    outs = [c.decompress(arc) for c in ctxs]
    assert outs[0] == outs[1] == outs[2] == data
    # a sticky context decodes again, and its single-block API equals JAX's
    assert ctxs[1].decompress(arc) == data
    block = _first_block(arc)
    want = ctxs[0].decompress_block(block, 8192)
    assert ctxs[1].decompress_block(block, 8192) == want \
        == ctxs[2].decompress_block(block, 8192) == data[:len(want)]


def _first_block(arc: bytes) -> bytes:
    """The first block of ``arc``: header and payload."""
    bh = headers.read_block_header(arc, C.FILE_HEADER_SIZE)
    return arc[C.FILE_HEADER_SIZE:
               C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE + bh.comp_size]


def test_dctx_block_errors_equal_jax():
    block = _first_block(Z.compress(_entropy_body(), Z.EncodeOpts(
        level=3, block_size=8192)))
    flipped = bytearray(block)
    flipped[len(block) // 2] ^= 0x5A
    for bad in (block[:5], bytes(flipped), block[:C.BLOCK_HEADER_SIZE]
                + b"\xff" * (len(block) - C.BLOCK_HEADER_SIZE)):
        want = got = None
        try:
            want = JDctx().decompress_block(bad, 8192)
        except JZxcError as e:
            want = e.code
        try:
            got = Z.Dctx().decompress_block(bad, 8192)
        except Z.ZxcError as e:
            got = e.code
        assert got == want
    # a payload cut short: the port raises ZxcError where JAX's numpy
    # buffer read raises ValueError
    with pytest.raises(ValueError):
        JDctx().decompress_block(block[:len(block) // 2], 8192)
    with pytest.raises(Z.ZxcError) as e:
        Z.Dctx().decompress_block(block[:len(block) // 2], 8192)
    assert e.value.code == Z.errors.ERROR_SRC_TOO_SMALL


def test_dctx_device_true_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot be "
                    "observed")
    arc = Z.compress(b"abc" * 5000, Z.EncodeOpts(level=3, block_size=4096))
    with pytest.raises(RuntimeError, match="CUDA"):
        Z.Dctx(device=True).decompress(arc)
    with pytest.raises(RuntimeError, match="CUDA"):
        Z.Dctx(device="cuda").decompress(arc)


@pytest.mark.parametrize("kw", [{}, dict(use_pieces=False),
                                dict(use_serial=True),
                                dict(device_entropy=True)],
                         ids=["pieces", "chase", "serial", "entropy"])
def test_collect_phases_records_as_jax_does(kw):
    data = _entropy_body()
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    assert profiling.phases() is None
    jkw = {k: v for k, v in kw.items() if k != "use_serial"}
    with jprof.collect_phases() as jph:
        assert jops.decompress(arc, **jkw) == data
    with profiling.collect_phases() as pph:
        ph = {}
        assert Z.ops.decompress(arc, device="cpu", _phases=ph, **kw) == data
        assert profiling.phases() is pph
    assert profiling.phases() is None
    m = pph.as_dict()
    assert set(m) == set(jph.as_dict())
    assert set(m) >= ({"plan", "device"} if kw.get("device_entropy")
                      or kw.get("use_pieces") is False
                      else {"plan", "resolve", "device"})
    assert all(v["seconds"] >= 0 and v["calls"] == 1 for v in m.values())
    device = sum(ph.get(k, 0.0) for k in ("pad", "pack", "entropy",
                                          "device"))
    assert m["device"]["seconds"] == pytest.approx(device, rel=1e-12)
    assert m["plan"]["seconds"] == ph["plan"]
    # two decodes in one collector add up
    with profiling.collect_phases() as two:
        Z.ops.decompress(arc, device="cpu", **kw)
        Z.ops.decompress(arc, device="cpu", **kw)
    assert all(v["calls"] == 2 for v in two.as_dict().values())


def test_collectors_nest():
    arc = Z.compress(b"abc" * 5000, Z.EncodeOpts(level=3, block_size=4096))
    with profiling.collect_phases() as outer:
        with profiling.collect_phases() as inner:
            Z.ops.decompress(arc, device="cpu")
        assert profiling.phases() is outer
    assert "plan" in inner.seconds and not outer.seconds


def test_trace_writes_a_chrome_trace(tmp_path):
    arc = Z.compress(b"abc" * 5000, Z.EncodeOpts(level=3, block_size=4096))
    with profiling.trace(str(tmp_path / "tr")) as path:
        assert Z.ops.decompress(arc, device="cpu") == b"abc" * 5000
    assert glob.glob(str(tmp_path / "tr" / "*.json")) == [path]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)
    # a raising block still leaves its trace
    with pytest.raises(Z.ZxcError):
        with profiling.trace(str(tmp_path / "bad")) as bad:
            Z.ops.decompress(arc[:10], device="cpu")
    assert glob.glob(str(tmp_path / "bad" / "*.json")) == [bad]


def test_entry_equals_graft_entry():
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    jfn, host = graft.entry()
    for a, h in zip(args, host):
        assert np.array_equal(a.numpy(), np.asarray(h))
    got, want = fn(*args), jfn(*host)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    plan, host2 = entry.example_plan(4096, 8)
    assert plan.n_blocks == 8 and not got[2].any()
    assert got[1].tolist() == plan.totals


def test_entry_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal cannot be "
                    "observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
