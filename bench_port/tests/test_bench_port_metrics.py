"""The metric arithmetic on fixed inputs."""
import time

import numpy as np
import pytest

from bench_port.harness import readers, trace, window
from bench_port.harness.readers import Observation
from bench_port.harness.window import Item, Request


def req(t0, t1, plain, arc=0, phases=None, err=None, item=0):
    return Request(0, item, t0, t1, plain, arc, phases or {}, None, err)


def test_rate_counts_requests_in_flight_at_the_deadline():
    # window starts at 0, deadline 10; the last request was issued at 9.5
    # and completes at 12: its bytes and its time both count
    reqs = [req(0, 4, 4_000_000_000), req(4, 9.5, 5_000_000_000),
            req(9.5, 12, 3_000_000_000)]
    obs = Observation(reqs, window_s=12.0, setup_s=1.0)
    assert readers.rate_gbps(obs) == pytest.approx(12.0 / 12.0)


def test_rate_leaves_out_failed_requests():
    reqs = [req(0, 2, 2_000_000_000), req(2, 3, 9_000_000_000, err="boom")]
    obs = Observation(reqs, window_s=4.0, setup_s=0.0)
    assert readers.rate_gbps(obs) == pytest.approx(0.5)
    assert readers.rate_gbps(Observation([], 4.0, 0.0)) is None


def test_ratio():
    reqs = [req(0, 1, 100, 40), req(1, 2, 300, 100)]
    assert readers.ratio(Observation(reqs, 2.0, 0.0)) == pytest.approx(0.35)


def test_p95():
    reqs = [req(0, (i + 1) / 1000, 1) for i in range(200)]   # 1..200 ms
    v = readers.percentile_ms(Observation(reqs, 1.0, 0.0), 95.0)
    assert v == pytest.approx(np.percentile(np.arange(1, 201), 95.0))
    assert 190 < v < 191


def test_phase_sums_per_gb():
    reqs = [req(0, 1, 500_000_000, phases={"plan": 0.2, "pad": 0.1}),
            req(1, 2, 1_500_000_000, phases={"plan": 0.6, "resolve": 0.1}),
            req(2, 3, 7_000_000_000)]     # untraced: left out
    obs = Observation(reqs, 3.0, 0.0)
    assert readers.phase_s_per_gb(obs, ("plan", "resolve", "pad")) == \
        pytest.approx(1.0 / 2.0)
    assert readers.phase_s_per_gb(Observation([], 1, 0), ("plan",)) is None


def test_union_and_gaps():
    merged = trace.union([(5, 6), (0, 2), (1, 3), (3, 4), (8, 9)])
    assert merged == [[0, 4], [5, 6], [8, 9]]
    assert trace.length(merged) == 6
    assert trace.gaps(merged, 0, 10) == [(4, 5), (6, 8), (9, 10)]
    assert trace.gaps(merged, -1, 5.5) == [(-1, 0), (4, 5)]


def test_reduce_idle_share_kernel_union_and_breakdown():
    dev = [("kernA", 0.0, 1.0), ("kernB", 0.5, 1.5), ("Memcpy HtoD", 2.0,
                                                      3.0),
           ("kernA", 6.0, 7.0), ("kernA", 9.5, 11.0)]   # clipped to 10
    spans = [("e2e[x]", 0.0, 4.0), ("e2e[y]", 3.5, 9.0)]
    s = trace.reduce(dev, 0.0, 10.0, spans)
    assert s.busy_s == pytest.approx(1.5 + 1.0 + 1.0 + 0.5)
    assert s.kernel_s == pytest.approx(1.5 + 1.0 + 0.5)
    assert s.window_s == 10.0
    assert s.device_ops[0] == ["kernA", pytest.approx(2.5)]
    # idle gaps, longest first, named by the spans at their midpoints
    assert [[n, round(v, 6)] for n, v in s.idle_gaps] == [
        ["e2e[y]", 3.0], ["e2e[y]", 2.5], ["e2e[x]", 0.5]]
    obs = Observation([], 1.0, 0.0, s, {"hbm_bytes_per_s": 1e12})
    assert readers.idle_pct(obs) == pytest.approx(100 * (1 - 4.0 / 10.0))


def test_roofline_counts_bytes_over_kernel_time():
    s = trace.TraceSummary(busy_s=2.0, kernel_s=0.5, window_s=10.0)
    obs = Observation([], 1.0, 0.0, s, {"hbm_bytes_per_s": 1e12})
    # 1e11 bytes at 1e12 B/s = 0.1 s least, over 0.5 s of kernels
    assert readers.roofline_pct(obs, 10**11) == pytest.approx(20.0)
    assert readers.roofline_pct(Observation([], 1, 0, s, None), 1) is None
    s0 = trace.TraceSummary(busy_s=0.0, kernel_s=0.0, window_s=1.0)
    assert readers.roofline_pct(Observation([], 1, 0, s0, {
        "hbm_bytes_per_s": 1.0}), 1) is None
    assert readers.idle_pct(Observation([], 1, 0, s0, None)) is None


def test_closed_loop_issues_only_before_the_deadline():
    items = [Item(i, f"i{i}", b"x" * (i + 1), b"") for i in range(3)]

    def call(state, item, phases):
        time.sleep(0.05)
        return item.plain

    w = window.run(call, None, items, clients=2, seconds=0.3, seed=2**31,
                   kind="decode", traced=False)
    assert all(r.t0 < w.deadline for r in w.requests)
    assert w.end == max(r.t1 for r in w.requests) and w.end >= w.deadline
    assert w.stuck == 0 and len(w.requests) >= 8
    # each client walks a deck: every item once before any repeats
    for c in (0, 1):
        seq = [r.item for r in w.requests if r.client == c]
        assert sorted(seq[:3]) == [0, 1, 2]


def test_deck_depends_on_seed_and_client():
    a = [window.Deck(12, 7, 0).next() for _ in range(1)]
    d0, d1 = window.Deck(12, 7, 0), window.Deck(12, 7, 1)
    s0 = [d0.next() for _ in range(12)]
    s1 = [d1.next() for _ in range(12)]
    assert sorted(s0) == sorted(s1) == list(range(12)) and s0 != s1
    assert a[0] == s0[0]

