"""The PyTorch port stands alone: it imports neither jax nor anything of
``zxc_tpu``, it never falls back silently to the CPU, and a missing native
library or kernel build (copy engine, encoder or attic) raises."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch import buildlib, runtime
from zxc_tpu_torch.ops import _build, attic as AT, copy_engine as CE
from zxc_tpu_torch.ops import attic_quad as AQ, probes as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zxc_tpu_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_import_leaves_jax_and_zxc_tpu_out():
    code = ("import sys, zxc_tpu_torch, zxc_tpu_torch.ops.copy_engine, "
            "zxc_tpu_torch.ops.device_pipeline, zxc_tpu_torch.runtime, "
            "zxc_tpu_torch.ops.hints, zxc_tpu_torch.ops.batch, "
            "zxc_tpu_torch.ops.serial, zxc_tpu_torch.codec.block_decode, "
            "zxc_tpu_torch.codec.huffman, zxc_tpu_torch.format.varint, "
            "zxc_tpu_torch.ops.encode, zxc_tpu_torch.ops.encode_kernels, "
            "zxc_tpu_torch.codec.block_encode, zxc_tpu_torch.ops.expand, "
            "zxc_tpu_torch.ops.attic, zxc_tpu_torch.ops.attic_quad, "
            "zxc_tpu_torch.ops.probes, zxc_tpu_torch.codec.seekable, "
            "zxc_tpu_torch.gather_ab, zxc_tpu_torch.ops.pivco_device, "
            "zxc_tpu_torch.context, zxc_tpu_torch.profiling, "
            "zxc_tpu_torch.entry\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'zxc_tpu' "
            "or m.startswith('zxc_tpu.'))\n"
            "print(','.join(bad))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_no_jax_or_zxc_tpu_import_in_sources():
    files = list(_py_files()) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "zxc_tpu"), (path, n)


def test_no_device_means_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal "
                    "cannot be observed")
    arc = Z.compress(b"abc" * 10000, Z.EncodeOpts(level=3, block_size=16384))
    hint = Z.write_hints(arc, str(tmp_path / "a.zxh"))
    plan = Z.ops.plan_frame(arc)
    sek = Z.seekable.Seekable.open_bytes(Z.compress(
        b"abc" * 10000, Z.EncodeOpts(level=3, block_size=4096,
                                     seekable=True)))
    for call in (lambda **kw: Z.decompress_e2e(arc, **kw),
                 lambda **kw: Z.decompress_e2e(arc, hint=hint, **kw),
                 lambda **kw: Z.ops.decompress(arc, **kw),
                 lambda **kw: Z.ops.decompress(arc, use_serial=True, **kw),
                 lambda **kw: Z.ops.decompress(arc, use_pieces=False, **kw),
                 lambda **kw: Z.ops.decompress(arc, device_entropy=True,
                                               **kw),
                 lambda **kw: Z.Dctx(device=kw.get("device", True))
                 .decompress(arc),
                 lambda **kw: sek.decompress_range_device(0, 30000, **kw),
                 lambda **kw: b"".join(AQ.decode_blocks_v15(
                     *Z.ops.batch.resolve_serial(plan), plan.totals, 16384,
                     **kw)),
                 lambda **kw: b"".join(AQ.decode_blocks_v23(
                     *Z.ops.batch.resolve_serial(plan), plan.totals, 16384,
                     **kw))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
        assert call(device="cpu") == b"abc" * 10000


def test_wrappers_refuse_other_devices():
    t = [torch.zeros((1, 2), dtype=torch.int32, device="meta"),
         torch.zeros((1, 2), dtype=torch.int32, device="meta"),
         torch.full((1, 64, 128), 128, dtype=torch.int32, device="meta"),
         torch.zeros((1, 2, 128), dtype=torch.uint8, device="meta"),
         torch.zeros((1, 128, 128), dtype=torch.uint8, device="meta")]
    for fn in (CE.v19, CE.v26):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*t)
    with pytest.raises(ValueError, match="cuda or cpu"):
        CE.v27(t[0], t[1], t[0][:, 0].contiguous(), t[2], t[3], t[4][0],
               RLP=128)
    t13 = t[:3] + [t[3].to(torch.int32)] + t[4:]
    with pytest.raises(ValueError, match="cuda or cpu"):
        CE.v13(*t13)
    for mode in (12, 15, 20):
        with pytest.raises(ValueError, match="cuda or cpu"):
            CE.quad(*t13, mode=mode)
    with pytest.raises(ValueError):
        Z.decompress_e2e(b"", device="meta")
    for kw in ({}, dict(use_serial=True), dict(use_serial=True, variant=2)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            Z.ops.decompress(b"", device="meta", **kw)
    sek = Z.seekable.Seekable.open_bytes(Z.compress(
        b"abc" * 3000, Z.EncodeOpts(level=3, block_size=4096,
                                    seekable=True)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sek.decompress_range_device(0, 10, device="meta")
    plan = Z.ops.plan_frame(Z.compress(b"abc" * 3000, Z.EncodeOpts(
        level=3, block_size=4096)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        Z.ops.decode_plan_device(plan, device="meta")
    att = (torch.zeros(1, dtype=torch.int32, device="meta"),
           torch.zeros(1, dtype=torch.int32, device="meta"),
           torch.zeros((1, 24, 128), dtype=torch.int32, device="meta"),
           torch.zeros((1, 40, 128), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        AT.piece_serial(*att, block=1024, fill_from_s=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        CE.v25(*t)
    for shifted, paired in P.V13_BISECT_MODES:
        with pytest.raises(ValueError, match="cuda or cpu"):
            P.v13_bisect(*t13, shifted, paired)
    with pytest.raises(ValueError, match="cuda or cpu"):
        P.v12_ablate2(*t13, "nomm")
    x = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    for call in (lambda: P.gather_axis1(x, x), lambda: P.gather_grid(x, x, 4),
                 lambda: P.dma_b(x, x[0])):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_missing_native_library_raises(tmp_path, monkeypatch):
    broken = tmp_path / "zxc_host.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "_SRC", str(broken))
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building libzxchost failed"):
        runtime.lib()
    with pytest.raises(RuntimeError):
        Z.compress(b"data", Z.EncodeOpts(block_size=16384))
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="building copy_engine failed"):
        _build.kernels()


def test_failed_encode_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="building encode failed"):
        _build.encode_kernels()


def test_failed_attic_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="building attic failed"):
        _build.attic_kernels()


def test_failed_gather_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="building gather failed"):
        _build.gather_kernels()


def test_nvcc_absent_raises(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.encode_kernels()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.attic_kernels()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.gather_kernels()


def test_build_cache_rebuilds_on_source_change(tmp_path, monkeypatch):
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "a.cpp"
    src.write_text("extern \"C\" int f(void) { return 1; }\n")
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    p1, log1 = buildlib.build_shared(str(src), "liba", cmd)
    p2, log2 = buildlib.build_shared(str(src), "liba", cmd)
    assert p1 == p2 and os.path.exists(p1) and log2 == ""
    src.write_text("extern \"C\" int f(void) { return 2; }\n")
    p3, _ = buildlib.build_shared(str(src), "liba", cmd)
    assert p3 != p1 and os.path.exists(p3)
    assert os.path.dirname(p1) == str(tmp_path / "build")


def test_native_source_is_a_verbatim_copy():
    # the port keeps its own copy of the JAX package's native host runtime;
    # a one-sided edit would make the two packages' prep drift apart
    with open(os.path.join(PKG, "runtime", "zxc_host.cpp"), "rb") as f:
        port = f.read()
    with open(os.path.join(ROOT, "zxc_tpu", "runtime", "zxc_host.cpp"),
              "rb") as f:
        assert port == f.read()


def test_group_from_numpy_keeps_bits():
    rng = np.random.default_rng(3)
    arrays = (rng.integers(0, 9, (2, 3), dtype=np.int32),
              rng.integers(0, 9, (2, 4), dtype=np.int32),
              rng.integers(-2**31, 2**31, (2, 64, 128), dtype=np.int64)
              .astype(np.int32),
              rng.integers(0, 256, (2, 4, 128), dtype=np.uint8),
              rng.integers(0, 256, (2, 128, 128), dtype=np.uint8))
    for a, t in zip(arrays, CE.group_from_numpy(*arrays)):
        assert t.device.type == "cpu"
        assert np.array_equal(t.numpy(), a) and t.numpy().dtype == a.dtype
