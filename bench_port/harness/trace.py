"""The traced window: ``torch.profiler`` around the whole window, reduced
to the device's busy time, the kernels' time and the breakdown.

Device intervals are the trace's CUDA events: kernels, copies and
memsets. Busy time is the length of their union, kernel time the length
of the union of the kernels alone. Host spans (``record_function`` around
every request, and the harness's own clock of each request) say what the
host was doing in each idle gap; a marker at the window's start maps the
harness's clock onto the trace's.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class TraceSummary:
    busy_s: float               # union of device intervals
    kernel_s: float             # union of kernel intervals
    window_s: float             # the profiled span
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def union(intervals: list) -> list:
    """Merged, sorted (start, end) pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(merged: list) -> float:
    return float(sum(e - s for s, e in merged))


def gaps(merged: list, lo: float, hi: float) -> list:
    """(start, end) of every stretch of [lo, hi] that ``merged`` leaves
    uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(device_events: list, lo: float, hi: float, host_spans: list
           ) -> TraceSummary:
    """``device_events``: (name, start_s, end_s) in the trace's clock;
    ``host_spans``: (label, start_s, end_s) in the same clock; [lo, hi]
    the profiled span."""
    clip = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events
            if e > lo and s < hi]
    busy = union([(s, e) for _, s, e in clip])
    kern = union([(s, e) for n, s, e in clip if not _is_copy(n)])
    by_name: dict = {}
    for n, s, e in clip:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        active = sorted(lab for lab, hs, he in host_spans if hs <= mid < he)
        counts: dict = {}
        for lab in active:
            counts[lab] = counts.get(lab, 0) + 1
        name = (" + ".join(f"{k} x{v}" if v > 1 else k
                           for k, v in counts.items())
                or "no request in flight")
        labelled.append([name, e - s])
    return TraceSummary(length(busy), length(kern), hi - lo,
                        [[n, v] for n, v in top], labelled)


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a callable that, after the block, returns (device_events,
    lo, hi, to_trace) with ``to_trace(perf_counter_s)`` mapping the
    harness's clock onto the trace's; a no-op when not ``enabled``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    box: dict = {}
    with profile(activities=acts) as prof:
        with record_function("bench_port.marker"):
            box["mark"] = time.perf_counter()
        box["lo"] = time.perf_counter()
        yield lambda: box["result"]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        box["hi"] = time.perf_counter()
    evs = prof.profiler.kineto_results.events()
    dev, offset = [], None
    for e in evs:
        name = e.name()
        if name == "bench_port.marker":
            offset = e.start_ns() * 1e-9 - box["mark"]
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns() * 1e-9
            dev.append((name, s, s + e.duration_ns() * 1e-9))
    if offset is None:
        raise RuntimeError("the trace lacks the harness's marker")
    box["result"] = (dev, box["lo"] + offset, box["hi"] + offset,
                     lambda t: t + offset)
