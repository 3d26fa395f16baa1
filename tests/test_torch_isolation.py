"""The PyTorch port stands alone: it imports neither jax nor anything of
``zxc_tpu``, it never falls back silently to the CPU, and a missing native
library or kernel build raises."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch import buildlib, runtime
from zxc_tpu_torch.ops import _build, copy_engine as CE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zxc_tpu_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_import_leaves_jax_and_zxc_tpu_out():
    code = ("import sys, zxc_tpu_torch, zxc_tpu_torch.ops.copy_engine, "
            "zxc_tpu_torch.ops.device_pipeline, zxc_tpu_torch.runtime\n"
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


def test_no_device_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal "
                    "cannot be observed")
    arc = Z.compress(b"abc" * 10000, Z.EncodeOpts(level=3, block_size=16384))
    with pytest.raises(RuntimeError, match="CUDA"):
        Z.decompress_e2e(arc)
    with pytest.raises(RuntimeError, match="CUDA"):
        Z.decompress_e2e(arc, device="cuda")
    assert Z.decompress_e2e(arc, device="cpu") == b"abc" * 10000


def test_wrappers_refuse_other_devices():
    t = [torch.zeros((1, 2), dtype=torch.int32, device="meta"),
         torch.zeros((1, 2), dtype=torch.int32, device="meta"),
         torch.full((1, 64, 128), 128, dtype=torch.int32, device="meta"),
         torch.zeros((1, 2, 128), dtype=torch.uint8, device="meta"),
         torch.zeros((1, 128, 128), dtype=torch.uint8, device="meta")]
    for fn in (CE.v19, CE.v26):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*t)
    with pytest.raises(ValueError):
        Z.decompress_e2e(b"", device="meta")


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
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="building copy_engine failed"):
        _build.kernels()


def test_nvcc_absent_raises(monkeypatch):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()


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
