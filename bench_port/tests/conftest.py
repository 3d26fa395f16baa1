"""Shared helpers of the benchmark's CPU tests: cells at a tiny size, run
through ``cli.run_cell(device="cpu")``, the kernels' plain versions."""
import json
import os
import sys
import time

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHRINK = 400   # member sizes divided by this: 0.5 MiB in all


def tiny_sizes(config_file: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, config_file)) as f:
        members = json.load(f)["members"]
    return {k: max(1, v // SHRINK) for k, v in members.items()}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config_file(cell: str, b: dict | None = None) -> str:
    b = b or bench()
    cfg = {w["name"]: w["config"] for w in b["workloads"]}[cell]
    return {c["name"]: c["file"] for c in b["configs"]}[cfg]


def run_tiny(cell: str, seed: int = 2**31 + 5, trace: bool = False,
             control: bool = False, bench_path: str | None = None,
             seconds: float = 0.4) -> dict:
    from bench_port.harness import cli
    b, root = None, ROOT
    if bench_path is not None:
        with open(bench_path) as f:
            b = json.load(f)
        root = os.path.dirname(os.path.abspath(bench_path))
    sizes = tiny_sizes(config_file(cell, b), root)
    return cli.run_cell(cell, seed, seconds, trace,
                        t_start=time.perf_counter(), device="cpu",
                        control=control, bench_path=bench_path, sizes=sizes)


def parked() -> dict:
    with open(os.path.join(BENCH_DIR, "tests", "parked_cells.json")) as f:
        return json.load(f)


PARKED = [w["name"] for w in parked()["workloads"]]


def bench_with_parked(top: str) -> str:
    """A copy of BENCHMARK.json with the parked cells added back, beside a
    link to this folder; returns its path."""
    b, p = bench(), parked()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        b[key] += p.get(key, [])
    for m in b["end_to_end"] + b["per_layer"]:
        m.get("workloads", []).extend(p["add_to"].get(m["name"], []))
    link = os.path.join(top, "bench_port")
    if not os.path.exists(link):
        os.symlink(BENCH_DIR, link)
    path = os.path.join(top, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(b, f)
    return path


@pytest.fixture(scope="session")
def parked_bench(tmp_path_factory) -> str:
    return bench_with_parked(str(tmp_path_factory.mktemp("parked")))


@pytest.fixture(scope="session", autouse=True)
def _cache_dirs():
    from bench_port.harness import cli
    cli.fix_cache_dirs(ROOT)
