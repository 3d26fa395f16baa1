"""Every cell of BENCHMARK.json, and every parked cell from a copy that
adds it back, resolves to its files and runs at a tiny size on the CPU,
with the metrics the contract asks of it."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, PARKED, ROOT, bench, run_tiny

CELLS = [w["name"] for w in bench()["workloads"]]
ALL = CELLS + PARKED


def test_benchmark_file_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_port"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert 1 <= len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           f"{w['traffic']}.json"))


def _bench_path(cell, parked_bench):
    return parked_bench if cell in PARKED else None


@pytest.mark.parametrize("cell", ALL)
def test_cell_resolves(cell, parked_bench):
    from bench_port.harness import spec
    c = spec.load_cell(_bench_path(cell, parked_bench)
                       or os.path.join(ROOT, "BENCHMARK.json"), cell)
    assert c.entry.KIND in ("decode", "compress")
    for fn in ("prepare", "call", "control", "close"):
        assert callable(getattr(c.entry, fn))
    assert "setup_s" in [m.name for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)


@pytest.mark.parametrize("cell", ALL)
def test_cell_runs_tiny(cell, parked_bench):
    path = _bench_path(cell, parked_bench)
    res = run_tiny(cell, bench_path=path)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    b = _load(path)
    want = {m["name"] for m in b["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ALL)
def test_cell_traced_tiny(cell, parked_bench):
    """The traced run reads the per-layer metrics of the program's phases
    and the clients (the CPU trace has no device events, so the device
    readers find nothing and their metrics are left out)."""
    path = _bench_path(cell, parked_bench)
    res = run_tiny(cell, trace=True, bench_path=path)
    assert res["correct"], res["checks"]
    b = _load(path)
    listed = {m["name"] for m in b["per_layer"]
              if cell in m["workloads"] and m["source"] != "device_trace"}
    assert listed and listed <= set(res["metrics"])
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _load(path):
    if path is None:
        return bench()
    with open(path) as f:
        return json.load(f)


def test_parked_cells_fit_the_benchmark():
    """Each parked cell names a configuration, mix and metrics of files
    that are here, and no name it adds is taken."""
    from conftest import parked
    b, p = bench(), parked()
    configs = {c["name"] for c in b["configs"] + p["configs"]}
    assert {w["config"] for w in p["workloads"]} <= configs
    for c in p["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in p["workloads"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           f"{w['traffic']}.json"))
    assert not {w["name"] for w in p["workloads"]} & set(CELLS)
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    mine = p["end_to_end"] + p["per_layer"]
    assert not {m["name"] for m in mine} & names
    assert set(p["add_to"]) <= names
    for m in mine:
        assert set(m["workloads"]) <= set(PARKED)
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))


def test_command_refuses_without_a_card():
    r = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        CELLS[0], "--seed", str(2**31 + 9), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_same_seed_same_inputs():
    from bench_port.harness import cli
    from conftest import config_file, tiny_sizes
    cfg_path = config_file("silesia-64k.compress")
    with open(os.path.join(ROOT, cfg_path)) as f:
        cfg = json.load(f)
    sizes = tiny_sizes(cfg_path)
    a = cli.make_items(cfg, 2**31 + 11, 2, sizes)
    b = cli.make_items(cfg, 2**31 + 11, 1, sizes)
    c = cli.make_items(cfg, 2**31 + 12, 1, sizes)
    assert [(i.plain, i.archive) for i in a] == [(i.plain, i.archive)
                                                 for i in b]
    assert [i.plain for i in a] != [i.plain for i in c]
    assert [len(i.plain) for i in a] == list(sizes.values())


def test_corpus_parallel_equals_serial():
    from bench_port.harness import corpus
    sizes = {"a": 5 << 20, "b": (4 << 20) + 123}
    par = corpus.make_members(sizes, 2**31 + 13, 2)
    ser = {k: b"".join(corpus.gen_chunk(min(corpus.CHUNK, n - off),
                                        (2**31 + 13, m, j))
                       for j, off in enumerate(range(0, n, corpus.CHUNK)))
           for m, (k, n) in enumerate(sizes.items())}
    assert par == ser
    assert [len(v) for v in par.values()] == list(sizes.values())
