"""Tracing and per-phase metrics, the port of ``zxc_tpu.profiling``.

* :func:`trace` — a context manager around ``torch.profiler.profile``
  that records everything inside it (host calls always; kernels, copies
  and memsets on the card when CUDA is present) and writes a Chrome trace
  into ``logdir`` (open it in ``chrome://tracing`` or Perfetto).
* :class:`Phases` / :func:`phases` — lightweight host-side per-phase
  wall-time accumulator. ``ops.decompress`` records ``plan`` /
  ``resolve`` / ``device`` phases into the module-level collector when
  enabled, so production callers can see where a decode spent its time
  without attaching a profiler.

Both are zero-overhead when unused: ``phases()`` returns the active
collector or ``None``, and call sites guard on that.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class Phases:
    """Accumulates wall-time per named phase; re-entrant per phase."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {k: {"seconds": self.seconds[k], "calls": self.counts[k]}
                for k in self.seconds}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ", ".join(f"{k}={v:.4f}s" for k, v in self.seconds.items())
        return f"Phases({body})"


_active: Phases | None = None


def phases() -> Phases | None:
    """The currently-installed collector (None = metrics disabled)."""
    return _active


@contextlib.contextmanager
def collect_phases():
    """Enable per-phase metrics for the dynamic extent; yields the
    :class:`Phases` collector that instrumented paths write into."""
    global _active
    prev = _active
    _active = Phases()
    try:
        yield _active
    finally:
        _active = prev


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into ``logdir``.

    CPU activity always, CUDA activity when the card is present. Yields
    the path of the Chrome trace (JSON), which is written when the block
    ends, also when it raises.
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"zxc_trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        with prof:
            yield path
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(path)
