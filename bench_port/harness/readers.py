"""Arithmetic that metric readers share. A reader returns None where it
finds nothing to read; the harness then leaves the metric out."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GB = 1e9


@dataclass
class Observation:
    """What one run saw: its completed requests, the window's span on the
    host clock, the set-up seconds, the trace's summary (traced runs) and
    the card's published peaks (None for a card the table lacks)."""
    requests: list
    window_s: float
    setup_s: float
    trace: object = None
    peak: dict | None = None


def done(obs: Observation) -> list:
    return [r for r in obs.requests if r.error is None]


def rate_gbps(obs: Observation) -> float | None:
    """Plaintext GB of every completed request over the window, from its
    start to the last completion."""
    reqs = done(obs)
    if not reqs or obs.window_s <= 0:
        return None
    return sum(r.plain_bytes for r in reqs) / GB / obs.window_s


def ratio(obs: Observation) -> float | None:
    reqs = done(obs)
    plain = sum(r.plain_bytes for r in reqs)
    return sum(r.archive_bytes for r in reqs) / plain if plain else None


def percentile_ms(obs: Observation, q: float) -> float | None:
    lat = [r.t1 - r.t0 for r in obs.requests]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, q))


def phase_s_per_gb(obs: Observation, keys: tuple) -> float | None:
    """The requests' phase seconds summed over ``keys``, per plaintext GB
    of those requests."""
    reqs = [r for r in done(obs) if r.phases]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases.get(k, 0.0) for r in reqs for k in keys) / (plain / GB)


def idle_pct(obs: Observation) -> float | None:
    t = obs.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(obs: Observation, least_bytes: int) -> float | None:
    """The least time for ``least_bytes`` at the card's memory bandwidth
    over the kernels' time, in percent."""
    t, peak = obs.trace, obs.peak
    if t is None or peak is None or t.kernel_s <= 0 or least_bytes <= 0:
        return None
    return 100.0 * (least_bytes / peak["hbm_bytes_per_s"]) / t.kernel_s
