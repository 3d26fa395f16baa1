"""The port's command line with ``--device`` against the JAX package's,
through ``main(..., device="cpu")`` (the kernels' plain versions).

The JAX references are made once per module on three blocks' worth of
seeded data: the JAX CLI's ``-z --device`` archives at 64 KiB blocks (the
LCP matcher) and at its 512 KiB default (the kernel-free matcher), its
``-d --device`` output, ``zxc_tpu.ops.write_hints``'s hint and
``decompress_e2e(hint=, interpret=True)``'s output (the JAX CLI's hint
decode cannot run on the CPU: it calls that function without
``interpret``). Archives and decoded bytes must be equal; a ``.zxh`` must
equal the port's ``write_hints`` bytes and load, through both packages'
loaders, to the JAX hint's geometry and arrays (the port's hint body
carries checksums, so its bytes differ from the JAX file's by design).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zxc_tpu import cli as JC
from zxc_tpu.codec.frame import DecodeOpts as JDecodeOpts
from zxc_tpu.ops import device_pipeline as JDP, hints as JH

import zxc_tpu_torch as Z
from zxc_tpu_torch import cli as PC
from zxc_tpu_torch.codec import frame as pframe
from zxc_tpu_torch.format.headers import read_file_header
from zxc_tpu_torch.ops import hints as PH

from test_torch_jax_native import jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 65536
HINT_ARRAYS = ("totals", "litlen", "litrows", "plan_off", "qs", "qbase",
               "tq", "pctrl", "plans")


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _data() -> bytes:
    rng = np.random.default_rng(16)
    seg = rng.integers(0, 256, 997, dtype=np.uint8).tobytes()
    body = (b"text " * 5000 + seg * 40 + b"\x00" * 20000 + b"ab" * 8000
            + rng.integers(0, 256, 60000, dtype=np.uint8).tobytes())
    return (body * 3)[:2 * BLOCK + 20000]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX references, by name."""
    jax_native()
    d = tmp_path_factory.mktemp("jax")
    data = _data()
    (d / "d.bin").write_bytes(data)
    r = {"data": data}
    for name, flags in (("a64", ["-B", "64K"]), ("a512", [])):
        out = str(d / f"{name}.zxc")
        assert JC.main(["-z", "-k", "-q", "--device", *flags, "-o", out,
                        str(d / "d.bin")]) == 0
        r[name] = open(out, "rb").read()
        assert JC.main(["-d", "-q", "--device", "-o", str(d / name),
                        out]) == 0
        r[f"{name}_out"] = (d / name).read_bytes()
    r["hint"] = JH.write_hints(r["a64"], str(d / "a64.zxh"), JDecodeOpts())
    r["hint_out"] = JDP.decompress_e2e(r["a64"], hint=r["hint"],
                                       interpret=True)
    return r


def _main(argv, path) -> int:
    old = os.getcwd()
    os.chdir(path)
    try:
        return PC.main(list(argv), device="cpu")
    finally:
        os.chdir(old)


def _same_hint(path: str, arc: bytes, jpath: str) -> None:
    """The port hint at ``path`` holds the JAX hint's content, through
    both loaders."""
    jj = JH.HintFile(jpath, arc)
    for h in (PH.HintFile(path, arc), JH.HintFile(path, arc)):
        assert vars(h.geo) == vars(jj.geo)
        for f in HINT_ARRAYS:
            assert np.array_equal(np.asarray(getattr(h, f)),
                                  np.asarray(getattr(jj, f))), f


def test_compress_device_equals_jax(ref, tmp_path, capsys):
    (tmp_path / "d.bin").write_bytes(ref["data"])
    assert _main(["-z", "-k", "--device", "-B", "64K", "-o", "a64.zxc",
                  "d.bin"], tmp_path) == 0
    assert (tmp_path / "a64.zxc").read_bytes() == ref["a64"]
    # without -B the JAX CLI's 512 KiB default holds (not 64 KiB)
    assert _main(["-z", "-k", "--device", "d.bin"], tmp_path) == 0
    arc = (tmp_path / "d.bin.zxc").read_bytes()
    assert arc == ref["a512"]
    assert read_file_header(arc).block_size == 512 << 10
    assert pframe.decompress(arc) == ref["data"]
    assert sorted(os.listdir(tmp_path)) == ["a64.zxc", "d.bin", "d.bin.zxc"]


def test_compress_device_hints(ref, tmp_path, capsys):
    (tmp_path / "d.bin").write_bytes(ref["data"])
    assert _main(["-z", "-k", "--device", "-B", "64K", "--hints", "-o",
                  "h.zxc", "d.bin"], tmp_path) == 0
    assert "h.zxc.zxh: piece-plan hints written" in capsys.readouterr().err
    assert (tmp_path / "h.zxc").read_bytes() == ref["a64"]
    want = PH.write_hints(ref["a64"], str(tmp_path / "want.zxh"),
                          Z.DecodeOpts())
    got = str(tmp_path / "h.zxc.zxh")
    assert open(got, "rb").read() == open(want, "rb").read()
    _same_hint(got, ref["a64"], ref["hint"])


def test_decode_hints_writes_then_reuses(ref, tmp_path, monkeypatch):
    (tmp_path / "x.zxc").write_bytes(ref["a64"])
    calls = []
    e2e = Z.ops.decompress_e2e
    monkeypatch.setattr(Z.ops, "decompress_e2e", lambda *a, **kw: (
        calls.append(kw["hint"]), e2e(*a, **kw))[1])
    assert _main(["-d", "-k", "--device", "--hints", "-o", "x.out",
                  "x.zxc"], tmp_path) == 0
    assert (tmp_path / "x.out").read_bytes() == ref["hint_out"] == \
        ref["data"]
    hint = str(tmp_path / "x.zxc.zxh")
    assert calls == ["x.zxc.zxh"]       # relative to the working directory
    _same_hint(hint, ref["a64"], ref["hint"])
    stamp = os.stat(hint).st_mtime_ns

    def no_write(*a, **kw):
        raise AssertionError("the cached hint was written again")

    monkeypatch.setattr(Z.ops, "write_hints", no_write)
    assert _main(["-d", "-f", "--device", "--hints", "-o", "x.out",
                  "x.zxc"], tmp_path) == 0
    assert calls == ["x.zxc.zxh"] * 2
    assert os.stat(hint).st_mtime_ns == stamp
    assert (tmp_path / "x.out").read_bytes() == ref["data"]


def test_foreign_hint_falls_back(ref, tmp_path, monkeypatch, capsysbinary):
    (tmp_path / "x.zxc").write_bytes(ref["a64"])
    other = Z.compress(ref["data"][:BLOCK * 2], Z.EncodeOpts(
        level=1, block_size=BLOCK))
    PH.write_hints(other, str(tmp_path / "x.zxc.zxh"))
    routes = []
    dec = Z.ops.decompress
    monkeypatch.setattr(Z.ops, "decompress", lambda *a, **kw: (
        routes.append(kw["device"]), dec(*a, **kw))[1])
    assert _main(["-d", "-c", "--device", "--hints", "x.zxc"], tmp_path) == 0
    assert capsysbinary.readouterr().out == ref["data"]
    assert routes == [torch.device("cpu")]


@pytest.mark.parametrize("name", ["a64", "a512"])
def test_decode_device_equals_jax(ref, tmp_path, capsysbinary, name):
    (tmp_path / "x.zxc").write_bytes(ref[name])
    assert _main(["-d", "-c", "--device", "x.zxc"], tmp_path) == 0
    assert capsysbinary.readouterr().out == ref[f"{name}_out"] == \
        ref["data"]


def test_test_and_bench_device(ref, tmp_path, capsysbinary):
    arc = Z.compress(ref["data"], Z.EncodeOpts(level=3, block_size=BLOCK,
                                               checksum=True))
    bad = bytearray(arc)
    bad[len(bad) // 2] ^= 0x20
    (tmp_path / "ok.zxc").write_bytes(arc)
    (tmp_path / "bad.zxc").write_bytes(bytes(bad))
    (tmp_path / "d.bin").write_bytes(ref["data"])
    for argv, rc in ((["-t", "--device", "ok.zxc"], 0),
                     (["-t", "--device", "ok.zxc", "bad.zxc"], 1),
                     (["-b", "1", "-j", "-B", "64K", "--device", "d.bin"],
                      0)):
        capsysbinary.readouterr()
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            jrc = JC.main(argv)
        finally:
            os.chdir(old)
        j = capsysbinary.readouterr()
        assert _main(argv, tmp_path) == jrc == rc
        p = capsysbinary.readouterr()
        if argv[0] == "-b":
            jr, pr = json.loads(j.out), json.loads(p.out)
            assert pr.keys() == jr.keys()
            assert all(pr[k] == jr[k] for k in pr if not k.endswith("mbps"))
        else:
            assert p.out == j.out and p.err == j.err


def test_dictionary_decode_device(ref, tmp_path, capsysbinary):
    samples = [ref["data"][i:i + 4096] for i in range(0, 65536, 4096)]
    d = Z.dict_train(samples, 2048)
    (tmp_path / "d.zxd").write_bytes(d.save())
    arc = Z.compress(ref["data"], Z.EncodeOpts(
        level=3, block_size=BLOCK, dict_content=d.content,
        dict_huf=d.huf_lengths))
    (tmp_path / "x.zxc").write_bytes(arc)
    assert _main(["-d", "-c", "--device", "-D", "d.zxd", "x.zxc"],
                 tmp_path) == 0
    assert capsysbinary.readouterr().out == ref["data"]
    assert _main(["-d", "-c", "--device", "x.zxc"], tmp_path) == 1
    assert b"DICT_REQUIRED" in capsysbinary.readouterr().err


def test_runtime_errors_propagate(ref, tmp_path, monkeypatch, capsys):
    """A kernel that fails to build or launch raises RuntimeError, which
    no handler of the CLI catches; a ZxcError from the hint writer after
    compress is reported and skipped."""
    (tmp_path / "x.zxc").write_bytes(ref["a64"])
    (tmp_path / "d.bin").write_bytes(ref["data"][:BLOCK])

    def broken(*a, **kw):
        raise RuntimeError("building copy_engine failed")

    monkeypatch.setattr(Z.ops, "decompress_e2e", broken)
    with pytest.raises(RuntimeError, match="copy_engine"):
        _main(["-d", "-c", "--device", "--hints", "x.zxc"], tmp_path)
    monkeypatch.setattr(Z.ops, "compress_device", broken)
    with pytest.raises(RuntimeError, match="copy_engine"):
        _main(["-z", "-c", "--device", "d.bin"], tmp_path)
    monkeypatch.setattr(Z.ops, "write_hints", broken)
    with pytest.raises(RuntimeError, match="copy_engine"):
        _main(["-z", "-k", "--hints", "d.bin"], tmp_path)

    def refused(*a, **kw):
        raise Z.ZxcError(-8, "hint refused")

    monkeypatch.setattr(Z.ops, "write_hints", refused)
    assert _main(["-z", "-k", "-f", "--hints", "d.bin"], tmp_path) == 0
    assert "hints skipped: ZXC_ERROR_CORRUPT_DATA: hint refused" in \
        capsys.readouterr().err
    assert not (tmp_path / "d.bin.zxc.zxh").exists()


def test_device_refused_without_cuda(ref, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be observed")
    (tmp_path / "x.zxc").write_bytes(ref["a64"])
    (tmp_path / "d.bin").write_bytes(ref["data"])
    before = sorted(os.listdir(tmp_path))
    for argv in (["-d", "--device", "-k", "x.zxc"],
                 ["-z", "--device", "-B", "64K", "d.bin"],
                 ["-t", "--device", "x.zxc"],
                 ["-b", "1", "--device", "d.bin"]):
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert PC.main(argv) == 1
        finally:
            os.chdir(old)
        cap = capsys.readouterr()
        assert "CUDA" in cap.err and cap.out == ""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-m", "zxc_tpu_torch", "-d",
                        "--device", "x.zxc"], capture_output=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 1 and b"CUDA" in r.stderr and r.stdout == b""
    assert sorted(os.listdir(tmp_path)) == before
