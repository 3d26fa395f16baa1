"""Build-once cache for the port's native libraries.

Both native parts of the port — the host runtime (``runtime/zxc_host.cpp``,
g++) and the Hopper kernels (``csrc/*.cu``, nvcc) — are compiled at first
use into ``build/zxc_tpu_torch/`` beside the package (gitignored), never
next to their sources. A library's file name carries a digest of its
source, its compile command and the host CPU, so an edited source, other
flags or a checkout copied to another machine build afresh instead of
loading a stale or foreign binary. A file lock serialises concurrent
builds (parallel test workers); a failed build raises.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "zxc_tpu_torch")


def _cpu_identity() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def build_shared(src: str, stem: str, cmd: list[str],
                 timeout: float = 600) -> tuple[str, str]:
    """Compile ``src`` with ``cmd + ["-o", <out>, src]`` unless a library
    for the same source, command and CPU exists. Returns (path, compiler
    output); the output is empty when the library was already built.
    Raises RuntimeError with the compiler's output when the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(cmd).encode()
                                + _cpu_identity()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, ""
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            r = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                               text=True, timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {stem} failed: {e}") from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {stem} failed (rc {r.returncode}):"
                               f"\n{r.stdout}{r.stderr}")
        os.replace(tmp, path)
        return path, r.stdout + r.stderr
