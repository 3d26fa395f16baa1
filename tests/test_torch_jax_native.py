"""The JAX package's native library for the port's parity tests, got
reliably under parallel test workers (``jax_native``), and its test.

The port's parity tests run the JAX package beside the port, and the JAX
package decodes through its own native library (``zxc_tpu.runtime.lib``).
A test file uses the helper from an autouse fixture, so the decision is
made when a test runs, never while the module is imported.
"""
import fcntl
import os
import shutil
import time

import pytest

from zxc_tpu import runtime as jrt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, "build", "jax_native.lock")
WAIT_S = 180


def _fresh() -> bool:
    return (os.path.exists(jrt._SO)
            and os.path.getmtime(jrt._SO) >= os.path.getmtime(jrt._SRC))


def jax_native():
    """``zxc_tpu.runtime.lib()``, built and loaded for this process.

    ``zxc_tpu.runtime`` builds its library with every process writing the
    same ``libzxchost.so.tmp`` (``_build``) and latches ``_tried`` after
    any failed attempt (``lib``). On a fresh checkout pytest-xdist's
    workers all build at collection, a worker that loses that race keeps
    ``available() == False`` for its whole life, and a module-level skip
    on it silently drops tests (ROADMAP queue 3 records the defect; the
    JAX package is not changed here). So the port's tests take a file
    lock, call ``lib()``, and when it returns None wait (up to WAIT_S) for
    the winner's fresh library, clear the module's private ``_tried`` and
    ``_lib`` latch and load again. This touches the reference's private
    state from test code only.

    Skips only without ``g++``; a library that still does not load fails
    the test with the reason: a lost race is not "toolchain unavailable".
    """
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the JAX package's native library "
                    "cannot be built")
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        L = jrt.lib()
        deadline = time.monotonic() + WAIT_S
        while L is None and time.monotonic() < deadline:
            if not _fresh():   # another process may still be building
                time.sleep(0.5)
                continue
            with jrt._lock:
                jrt._tried = False
                jrt._lib = None
            L = jrt.lib()
            if L is None:
                time.sleep(1.0)
    if L is None:
        pytest.fail(f"zxc_tpu.runtime.lib() did not load {jrt._SO} within "
                    f"{WAIT_S} s (fresh: {_fresh()})")
    return L


def test_jax_native_recovers_from_a_lost_build_race(monkeypatch):
    L = jax_native()
    # the state a worker that lost the race is left in
    monkeypatch.setattr(jrt, "_lib", None)
    monkeypatch.setattr(jrt, "_tried", True)
    assert jrt.lib() is None
    got = jax_native()
    assert got is not None and jrt.available()
    assert got.zxch_isa_supported() == L.zxch_isa_supported() == 1
