"""The port's spans and counters (``zxc_tpu_torch/profiling.py``) and the
ones ``ops.compress_device`` records, on the CPU: the keys its
``_phases`` dict receives, the parents' sums, the counters against their
closed forms and the archive's own counts, one collector a thread, no
profiler range without a collector, and the ranges in a
``profiling.trace``. Torch only; the card's counterpart (no
``torch.cuda.synchronize`` on the path) is in ``test_torch_cuda.py``."""
import json
import sys
import threading

import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch import profiling
from zxc_tpu_torch.codec import block_encode
from zxc_tpu_torch.ops import encode as PE

BLOCK = 4096


def _text(n: int, seed: int = 3) -> bytes:
    """Word soup: matches at many distances, none near the LCP cap."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(400)]
    out = bytearray()
    while len(out) < n:
        out += vocab[int(rng.integers(0, len(vocab)))] + b" "
    return bytes(out[:n])


def _compress(data: bytes, **kw):
    ph: dict = {}
    arc = PE.compress_device(data, level=3, block_size=BLOCK, device="cpu",
                             checksum=True, _phases=ph, **kw)
    return arc, ph


def test_compress_device_phases_hold_every_key():
    data = _text(5 * BLOCK + 123)
    arc, ph = _compress(data)
    assert Z.decompress(arc) == data
    assert set(ph) == set(PE.PHASES)
    assert all(isinstance(ph[k], float) and ph[k] >= 0
               for k in PE.PHASES[:-2])
    assert isinstance(ph["d2h_bytes"], int) and ph["d2h_bytes"] > 0
    assert ph["emit.native_bytes"] == len(data)


def test_parents_hold_their_children():
    """``parse`` holds its issue and readback, and ``emit`` at least its
    four children; the gaps are the spans' own cost (a few microseconds a
    call)."""
    _, ph = _compress(_text(8 * BLOCK + 5))
    slack = 2e-3
    kids = ph["parse.issue"] + ph["parse.readback"]
    assert 0 <= ph["parse"] - kids <= 0.05 * ph["parse"] + slack
    emit_kids = sum(ph[k] for k in ("emit.cap", "emit.streams",
                                    "emit.literals", "emit.hufflit"))
    assert ph["emit"] >= emit_kids


@pytest.mark.parametrize("tail", [0, 1, 2047])
def test_counters_equal_closed_forms_and_the_archive(tail):
    """On the CPU every block is its own group: one readback of its
    (3, 1, n // 5 + 1) int32 sequences and its (1,) count; a group, a
    readback and an emission a block of the archive."""
    data = _text(6 * BLOCK + tail, seed=tail)
    with profiling.collect_phases() as col:
        arc = PE.compress_device(data, 3, BLOCK, device="cpu",
                                 checksum=True)
    assert Z.decompress(arc) == data
    sizes = [BLOCK] * 6 + ([tail] if tail else [])
    cap = [n // 5 + 1 for n in sizes]
    assert col.counters == {"d2h_bytes": sum(3 * 4 * c + 4 for c in cap),
                            "emit.native_bytes": len(data)}
    plan = Z.ops.plan_frame(arc)
    assert (col.counts["group"] == col.counts["parse.readback"]
            == col.counts["emit"] == plan.n_blocks == len(sizes))


def test_phases_dict_keeps_out_of_an_outer_collector():
    data = _text(3 * BLOCK)
    with profiling.collect_phases() as outer:
        _compress(data)
        assert profiling.phases() is outer
    assert not outer.seconds and not outer.counters
    with profiling.collect_phases() as outer:
        PE.compress_device(data, 3, BLOCK, device="cpu")
    m = outer.as_dict()
    assert set(m) == set(PE.PHASES) | {"compress_device", "group"}
    assert m["compress_device"]["calls"] == 1
    assert m["group"]["calls"] == m["emit"]["calls"] == 3
    assert m["d2h_bytes"] == {"count": 3 * (3 * 4 * (BLOCK // 5 + 1) + 4)}


@pytest.mark.parametrize("level", [1, 3, 7])
def test_host_encoder_records_emit_spans_in_a_collector(level):
    """``codec.block_encode`` on given sequences records the emission's
    spans in a collector of its thread: without a dictionary the native
    emitter's four stage clocks, one call each (a stage that does not
    run at the level reads zero), and its bytes; the Python emitters
    their own spans."""
    arr = np.frombuffer(_text(BLOCK), np.uint8)
    lens, offs = PE.find_matches_device_lcp(torch.from_numpy(arr.copy()), 4)
    (seqs,) = PE._host_seqs(*PE._walk_compact(lens[None], offs[None],
                                              True, 5))
    want = block_encode.encode_chunk_plain(arr, level, sequences=seqs)
    with profiling.collect_phases() as col:
        assert block_encode.encode_chunk(arr, level, sequences=seqs) == want
    assert col.counts == dict.fromkeys(block_encode.EMIT_STAGES, 1)
    assert col.counters == {"emit.native_bytes": BLOCK}
    if level == 1:
        assert col.seconds["emit.literals"] == 0
    if level == 7:
        assert col.seconds["emit.hufflit"] == 0
    with profiling.collect_phases() as col:
        assert block_encode.encode_chunk_plain(arr, level,
                                               sequences=seqs) == want
    # GHI (level 1) has no literal auction, levels 6-7 no all-literal
    # candidate; GLO emits its streams twice
    assert col.counts == ({"emit.streams": 2, "emit.hufflit": 1}
                          if level == 1 else
                          {"emit.streams": 2, "emit.literals": 1}
                          if level == 7 else
                          {"emit.streams": 2, "emit.literals": 1,
                           "emit.hufflit": 1})
    assert not col.counters


@pytest.mark.parametrize("route", ["lcp", "xla_by_env", "xla_by_size",
                                   "tail", "encode_chunk_device"])
@pytest.mark.parametrize("level", [1, 3, 6])
def test_native_bytes_count_every_block_without_a_dictionary(route, level,
                                                             monkeypatch):
    """``emit.native_bytes`` is the archive's plaintext on every route
    without a dictionary, and ``emit`` holds its four children."""
    if route == "xla_by_env":
        monkeypatch.setenv("ZXC_DEVICE_MATCHER", "xla")
    block = 128 << 10 if route == "xla_by_size" else BLOCK
    n = {"lcp": 3 * BLOCK, "xla_by_env": 2 * BLOCK, "xla_by_size": 3000,
         "tail": 2 * BLOCK + 777, "encode_chunk_device": 3 * BLOCK // 2}
    data = _text(n[route], seed=level)
    with profiling.collect_phases() as col:
        if route == "encode_chunk_device":
            PE.encode_chunk_device(data, level, "cpu", checksum=True)
        else:
            arc = PE.compress_device(data, level, block, device="cpu",
                                     checksum=True)
            assert Z.decompress(arc) == data
    assert col.counters["emit.native_bytes"] == len(data)
    s = col.seconds
    assert s["emit"] >= sum(s[k] for k in block_encode.EMIT_STAGES)
    assert all(col.counts[k] == col.counts["emit"]
               for k in block_encode.EMIT_STAGES)


def test_collectors_of_two_threads_do_not_mix():
    """Threads each with a collector of their own, more threads than
    cores and a short switch interval: every collector holds its own
    spans and counts exactly."""
    n_threads, rounds = 12, 400
    results: dict = {}
    start = threading.Barrier(n_threads)

    def work(i: int) -> None:
        start.wait()
        with profiling.collect_phases() as col:
            for _ in range(rounds):
                with profiling.span(f"t{i}"):
                    profiling.count("n", 1)
                    profiling.count(f"c{i}", i + 1)
            results[i] = col

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for i, col in results.items():
        assert col.counts == {f"t{i}": rounds}
        assert col.counters == {"n": rounds, f"c{i}": rounds * (i + 1)}
    assert len(results) == n_threads
    assert profiling.phases() is None


def test_thread_started_in_a_collector_does_not_see_it():
    seen = []
    with profiling.collect_phases() as col:
        t = threading.Thread(target=lambda: seen.append(profiling.phases()))
        t.start()
        t.join(10)
        with profiling.span("here"):
            pass
    assert seen == [None] and col.counts == {"here": 1}


def test_no_profiler_range_without_a_collector(monkeypatch):
    """Without a collector a span opens no range (``record_function``
    would raise); with one but no profiler running, none either; with a
    profiler running, the spans open theirs."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    data = _text(2 * BLOCK + 7)
    want = PE.compress_device(data, 3, BLOCK, device="cpu")
    assert profiling.span("x") is profiling.span("y")
    _, ph = _compress(data)
    assert set(ph) == set(PE.PHASES)
    with pytest.raises(AssertionError, match="entered"):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            PE.compress_device(data, 3, BLOCK, device="cpu", _phases={})
    assert PE.compress_device(data, 3, BLOCK, device="cpu") == want


def test_trace_holds_the_spans_nested_under_the_caller(tmp_path):
    data = _text(2 * BLOCK + 99)
    with profiling.trace(str(tmp_path)) as path:
        with torch.profiler.record_function("caller"):
            _, ph = _compress(data)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    (caller,) = [e for e in events if e["name"] == "caller"]
    zxc = [e for e in events if e["name"].startswith("zxc.")]
    names = {e["name"].split(" ")[0] for e in zxc}
    assert {"zxc.compress_device", "zxc.group", "zxc.match",
            "zxc.parse.readback", "zxc.emit"} <= names
    # the emission's stages are the native call's clocks, not ranges
    assert not any(n.startswith("zxc.emit.") for n in names)
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in zxc)
    (call,) = [e for e in zxc if e["name"].startswith("zxc.compress_")]
    assert call["name"].startswith(f"zxc.compress_device bytes={len(data)} "
                                   "call=")
    groups = sorted(e["name"] for e in zxc
                    if e["name"].startswith("zxc.group"))
    assert groups == [f"zxc.group index={i} blocks=1" for i in range(3)]
    # each readback lies inside its parse, inside its group
    for rb in (e for e in zxc if e["name"] == "zxc.parse.readback"):
        assert any(p["ts"] <= rb["ts"] and rb["ts"] + rb["dur"]
                   <= p["ts"] + p["dur"] for p in zxc
                   if p["name"] == "zxc.parse")
    assert set(ph) == set(PE.PHASES)


def test_no_range_where_the_profiler_records_another_thread(monkeypatch):
    """A profiler started in one thread opens no range for the spans of a
    call in another thread (the benchmark's traced window: the profiler in
    the main thread, the requests in a client's); the call still records
    its spans."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    data = _text(2 * BLOCK + 7)
    out: dict = {}

    def client() -> None:
        try:
            out["ph"] = _compress(data)[1]
        except AssertionError as e:
            out["err"] = e

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        t = threading.Thread(target=client)
        t.start()
        t.join(60)
        monkeypatch.undo()
    assert "err" not in out and set(out["ph"]) == set(PE.PHASES)
