"""Resolves a cell of ``BENCHMARK.json`` to the files that define it.

* a configuration: ``BENCHMARK.json``'s ``configs[].file`` (a JSON file
  under ``configs/``);
* a traffic mix: ``traffic/<traffic>.json``, data only, which names its
  entry adapter;
* an entry adapter: ``entries/<entry>.py``, how one call of
  ``zxc_tpu_torch`` is made;
* a metric: ``metrics/<name>.py``, a reader with ``read(obs)`` that
  returns a number, or None where it finds nothing to read.

Adding a configuration, a mix, an entry, a metric or a cell is adding
files and entries; no file of the harness names any of them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, name: str):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    reader: object   # module with read(obs)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str, reporting: set) -> bool:
    """Whether ``metric`` is read in ``cell``: its ``workloads`` list the
    cell, or it has none and the cell reports the end-to-end metric it
    moves (for end-to-end metrics without ``workloads``: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reporting


def load_cell(bench_path: str, cell: str) -> Cell:
    """The cell ``cell`` of the benchmark file at ``bench_path``; its files
    are found beside it (the checkout's root, where ``paths`` start)."""
    root = os.path.dirname(os.path.abspath(bench_path))
    here = os.path.join(root, "bench_port")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in {bench_path}")
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    entry = load_module(os.path.join(here, "entries",
                                     f"{traffic['entry']}.py"),
                        f"bench_port_entry_{traffic['entry']}")

    def metric(m: dict) -> Metric:
        reader = load_module(os.path.join(here, "metrics", f"{m['name']}.py"),
                             f"bench_port_metric_{m['name']}")
        return Metric(m["name"], m["unit"], reader)

    e2e = [metric(m) for m in bench["end_to_end"]
           if _applies(m, cell, set())]
    reporting = {m.name for m in e2e}
    per_layer = [metric(m) for m in bench["per_layer"]
                 if _applies(m, cell, reporting)]
    return Cell(cell, int(w["chips"]), config, traffic, entry, e2e,
                per_layer)
