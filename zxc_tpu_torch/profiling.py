"""Tracing, spans and counters, the port of ``zxc_tpu.profiling``.

* :func:`trace` — a context manager around ``torch.profiler.profile``
  that records everything inside it (host calls always; kernels, copies
  and memsets on the card when CUDA is present) and writes a Chrome trace
  into ``logdir`` (open it in ``chrome://tracing`` or Perfetto).
* :class:`Phases` — a collector of seconds and calls per span name and
  of counters. :func:`collect_phases` installs one for the dynamic
  extent of a block; :func:`phases` returns the installed one (None when
  there is none). The installed collector is one context variable, so
  each thread sees its own: two threads that each open a collector do not
  write into one another's, and a thread started inside a block does not
  see the block's collector.
* :func:`span` — ``with span("parse.readback"):`` adds the block's
  ``perf_counter`` seconds and one call to the installed collector, and,
  while a profiler records the calling thread (``trace``, or any caller's
  ``torch.profiler.profile`` started in that thread), opens
  ``torch.profiler.record_function("zxc.parse.readback")``, so that the
  profiler records the span on the clock of the card's kernels and
  copies, nested under the caller's ranges. A span in a thread that no
  profiler records, such as a benchmark's client while the profiler runs
  in the main thread, opens no range. A span never synchronises the card:
  a span that issues device work ends when the work is queued, and the
  host's waits fall in the spans of the calls that wait (a readback, a
  copy from pageable memory).
  ``args``, a dict, is written into the range's name (``zxc.group
  index=3 blocks=16``): the Chrome export drops ``record_function``'s
  own argument string. With no collector installed, ``span`` is one
  context-variable lookup and a shared no-op context: nothing is
  recorded and no range is opened.
* :func:`add` — ``add("emit.streams", s)`` adds seconds measured
  elsewhere (a native call's stage clocks) and one call to the installed
  collector, as a span of that name would; it opens no range.
* :func:`count` — ``count("d2h_bytes", n)`` adds to the installed
  collector's counter (nothing without one).

A span's parent is the span open around it, which the profiler's nesting
shows; in the collector a dotted name's prefix names it (``parse`` is
the parent of ``parse.readback``), and a span's self time is its seconds
less its children's. ``ops.compress_device`` and the sharded paths of
``parallel`` record into a collector of their own when handed a
``_phases`` dict (:func:`collect_into`); the decode paths fill their
``_phases`` dicts directly, and ``ops.decompress`` adds its ``plan`` /
``resolve`` / ``device`` seconds to the installed collector.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time

import torch


class Phases:
    """Seconds and calls per span name, and counters."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: dict[str, int] = {}

    def as_dict(self) -> dict[str, dict]:
        """``{span: {"seconds", "calls"}}`` and ``{counter: {"count"}}``."""
        out: dict[str, dict] = {
            k: {"seconds": self.seconds[k], "calls": self.counts[k]}
            for k in self.seconds}
        out.update({k: {"count": v} for k, v in self.counters.items()})
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ", ".join(f"{k}={v:.4f}s" for k, v in self.seconds.items())
        return f"Phases({body})"


_active: contextvars.ContextVar[Phases | None] = contextvars.ContextVar(
    "zxc_phases", default=None)
_OFF = contextlib.nullcontext()


def phases() -> Phases | None:
    """The collector installed in this context (None = metrics off)."""
    return _active.get()


@contextlib.contextmanager
def collect_phases():
    """Install a new :class:`Phases` for the dynamic extent of the block
    (in this thread) and yield it."""
    col = Phases()
    token = _active.set(col)
    try:
        yield col
    finally:
        _active.reset(token)


@contextlib.contextmanager
def collect_into(out: dict | None, keys: tuple[str, ...]):
    """Where ``out`` is a dict, run the block in a collector of its own
    and then add the seconds and counters it holds under ``keys`` into
    ``out``; where it is None, the block's spans go to the installed
    collector, if any."""
    if out is None:
        yield None
        return
    with collect_phases() as col:
        yield col
    for k in keys:
        v = col.seconds.get(k, col.counters.get(k))
        if v is not None:
            out[k] = out.get(k, 0) + v


class _Span:
    __slots__ = ("col", "name", "label", "rf", "t0")

    def __init__(self, col: Phases, name: str, label: str):
        self.col, self.name, self.label = col, name, label

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.label)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        col, name = self.col, self.name
        col.seconds[name] = col.seconds.get(name, 0.0) + dt
        col.counts[name] = col.counts.get(name, 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, args: dict | None = None):
    """A context that records ``name`` into the installed collector and
    opens the profiler range ``zxc.<name>`` (module docstring)."""
    col = _active.get()
    if col is None:
        return _OFF
    label = "zxc." + name
    if args:
        label += " " + " ".join(f"{k}={v}" for k, v in args.items())
    return _Span(col, name, label)


def add(name: str, seconds: float) -> None:
    """Add ``seconds`` and one call under ``name`` to the installed
    collector (nothing without one): a span timed elsewhere, such as a
    stage of a native call. It opens no profiler range."""
    col = _active.get()
    if col is not None:
        col.seconds[name] = col.seconds.get(name, 0.0) + float(seconds)
        col.counts[name] = col.counts.get(name, 0) + 1


def count(name: str, n) -> None:
    """Add ``n`` to the installed collector's counter ``name``."""
    col = _active.get()
    if col is not None:
        col.counters[name] = col.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into ``logdir``.

    CPU activity always, CUDA activity when the card is present. Yields
    the path of the Chrome trace (JSON), which is written when the block
    ends, also when it raises. The trace holds the program's spans where
    a collector is installed (``collect_phases``, or a ``_phases`` dict
    handed to a call that takes one).
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
