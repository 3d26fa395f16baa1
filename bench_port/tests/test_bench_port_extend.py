"""A cell added from new files only: a copy of the benchmark gains a
configuration, a traffic mix, an entry adapter, a per-layer metric and a
cell, and no file the copy had is edited."""
import hashlib
import json
import os
import shutil

from conftest import BENCH_DIR, ROOT, run_tiny

NEW_CONFIG = {
    "name": "tiny-l1-128k", "source": "a test configuration",
    "layout": "files", "members": {"a": 40_000, "b": 150_000},
    "total_bytes": 190_000, "level": 1, "block_size": 131072,
    "checksum": True, "assumed": [],
}
NEW_TRAFFIC = {"entry": "decompress_e2e_dispatch8", "hint": False,
               "clients": 3, "loop": "closed", "draw": "deck",
               "warmup": "split", "about": "a test mix"}
NEW_ENTRY = '''"""Entry: decompress_e2e with dispatch groups of 8 blocks."""
KIND = "decode"


def prepare(ctx):
    return {"device": ctx.device}


def call(state, item, phases):
    from zxc_tpu_torch import decompress_e2e
    return decompress_e2e(item.archive, device=state["device"], dispatch=8,
                          _phases=phases)


def control(state, item, phases):
    from bench_port.reference import zxc_numpy
    return zxc_numpy.decode_frame(item.archive, overlap=False)


def close(state):
    state.clear()
'''
NEW_METRIC = '''"""total_s_per_gb.e2e8: decompress_e2e's total seconds per GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("total",))
'''


def _digests(top: str) -> dict:
    out = {}
    for d, _, files in os.walk(top):
        if "__pycache__" in d or os.sep + "build" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_cell_added_from_new_files_only(tmp_path):
    copy = tmp_path / "bench_port"
    shutil.copytree(BENCH_DIR, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "build"))
    before = _digests(str(copy))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # new files
    (copy / "configs" / "tiny-l1-128k.json").write_text(
        json.dumps(NEW_CONFIG))
    (copy / "traffic" / "e2e8.json").write_text(json.dumps(NEW_TRAFFIC))
    (copy / "entries" / "decompress_e2e_dispatch8.py").write_text(NEW_ENTRY)
    (copy / "metrics" / "total_s_per_gb.e2e8.py").write_text(NEW_METRIC)
    # new entries in BENCHMARK.json, nothing of it changed
    bench["configs"].append({"name": "tiny-l1-128k", "source": "test",
                             "file": "bench_port/configs/tiny-l1-128k.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": "tiny.e2e8", "config": "tiny-l1-128k",
                               "traffic": "e2e8", "chips": 1,
                               "why": "a test cell"})
    # its end-to-end metric, an entry new to the file, read by a metric
    # file that is here
    assert "decode_gbps" not in [m["name"] for m in bench["end_to_end"]]
    assert (copy / "metrics" / "decode_gbps.py").exists()
    bench["end_to_end"].append({"name": "decode_gbps", "unit": "GB/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.e2e8"]})
    bench["per_layer"].append({"name": "total_s_per_gb.e2e8", "unit": "s/GB",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "decode_gbps",
                               "workloads": ["tiny.e2e8"]})
    bench_path = tmp_path / "BENCHMARK.json"
    bench_path.write_text(json.dumps(bench))
    after = _digests(str(copy))
    assert {k: v for k, v in after.items() if k in before} == before

    res = run_tiny("tiny.e2e8", bench_path=str(bench_path))
    assert res["correct"] and set(res["metrics"]) == {"decode_gbps",
                                                      "setup_s"}
    assert res["window"]["clients"] == 3
    res = run_tiny("tiny.e2e8", bench_path=str(bench_path), trace=True)
    assert res["correct"]
    assert res["metrics"]["total_s_per_gb.e2e8"]["value"] > 0
    # the existing cells of the copy still resolve and run
    res = run_tiny("silesia-64k.compress", bench_path=str(bench_path))
    assert res["correct"]
