"""One run of one cell: set-up, the measured window, the check, the result.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card with as many devices as the cell asks for, the run
exits with code 3 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

from . import spec as spec_mod
from . import window as W

ROOT = os.path.dirname(spec_mod.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "zxc_tpu"}
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
             "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}


class NoCard(Exception):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``zxc_tpu_torch`` is not ``zxc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def fix_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHE_ENV.items():
        path = os.path.join(root, "build", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def make_items(config: dict, seed: int, workers: int, sizes=None) -> list:
    """Plaintext from the seed, archives from the frozen encoder."""
    from . import corpus, frozen
    members = dict(sizes or config["members"])
    plains = corpus.make_members(members, seed, workers)
    if config["layout"] == "concat":
        named = [(config["name"], b"".join(plains[m] for m in members))]
    elif config["layout"] == "files":
        named = list(plains.items())
    else:
        raise ValueError(f"layout {config['layout']!r}")
    del plains
    return [W.Item(i, name, plain,
                   frozen.compress(plain, int(config["level"]),
                                   int(config["block_size"]),
                                   bool(config["checksum"]), workers))
            for i, (name, plain) in enumerate(named)]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", control: bool = False,
             bench_path: str | None = None, sizes=None) -> dict:
    """Runs the cell and returns the result object. ``device="cpu"`` (the
    kernels' plain versions) and ``sizes`` (member sizes) serve the CPU
    tests only; the command line always runs on the card."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    cell = spec_mod.load_cell(bench_path, cell_name)
    traffic = cell.traffic
    if traffic.get("loop") != "closed" or traffic.get("draw") != "deck":
        raise ValueError("the harness runs closed loops over a deck")
    import torch
    steps: dict = {}
    t = t_start
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise NoCard(f"needs {cell.chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(0)
    import zxc_tpu_torch  # noqa: F401  (the program under test)
    t = _step(steps, "imports_and_card", t)
    workers = max(1, min(os.cpu_count() or 1, 16))
    items = make_items(cell.config, seed, workers, sizes)
    t = _step(steps, "plaintext_and_archives", t)
    entry = cell.entry
    tmpdir = tempfile.mkdtemp(prefix="bench_port_")
    state = None
    try:
        ctx = SimpleNamespace(config=cell.config, traffic=traffic,
                              items=items, device=device, tmpdir=tmpdir)
        state = entry.prepare(ctx)
        t = _step(steps, "entry_state", t)
        clients = int(traffic["clients"])
        warm_items = (entry.warmup_items(state, items)
                      if hasattr(entry, "warmup_items") else items)
        errs, slowest = W.warm(entry.call, state, warm_items, clients,
                               traffic.get("warmup", "each_client"),
                               entry.KIND)
        if errs:
            raise RuntimeError("warm-up failed:\n" + errs[0])
        steps["warmup_slowest_request"] = slowest
        if device == "cuda":
            torch.cuda.synchronize()
        t = _step(steps, "warmup", t)
        setup_s = t - t_start
        gc.collect()
        call = entry.control if control else entry.call
        from . import trace as T
        span = None
        if trace:
            from torch.profiler import record_function

            def span(item):
                return record_function(f"request:{item.name}")
        with T.profiled(trace) as traced:
            win = W.run(call, state, items, clients, seconds, seed,
                        entry.KIND, trace, span,
                        join_limit=600.0 if control else 90.0,
                        check_share=(1.0 if control else
                                     float(traffic.get("check_share", 1.0))))
        summary = None
        if trace:
            dev, lo, hi, to_trace = traced()
            spans = [(f"{traffic['entry']}[{items[r.item].name}]",
                      to_trace(r.t0), to_trace(r.t1)) for r in win.requests]
            summary = T.reduce(dev, lo, hi, spans)
        peak = (torch.cuda.max_memory_allocated(0) if device == "cuda"
                else 0)
        kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        entry.close(state)
        state = None
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    finally:
        if state is not None:
            with contextlib.suppress(Exception):
                entry.close(state)
        shutil.rmtree(tmpdir, ignore_errors=True)

    from . import judge, peaks
    from .readers import Observation
    obs = Observation(win.requests, win.seconds, setup_s, summary,
                      peaks.lookup(kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(obs)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    t = time.perf_counter()
    ref_blocks = None
    if entry.KIND == "compress":
        numbers, ref_blocks = judge.judge_compress(
            win.requests, items, cell.config, seed, workers)
    else:
        numbers = judge.judge_decode(win.requests, items)
    raised = sum(r.error is not None for r in win.requests)
    numbers = {"failed": raised, "stuck": win.stuck, **numbers}
    completed = len(win.requests) - raised
    checked = sum(r.kept and r.error is None for r in win.requests)
    correct, checks = judge.verdict(numbers, checked)
    for r in win.requests:
        if r.error is not None:
            print(f"request {items[r.item].name} failed:\n{r.error}",
                  file=sys.stderr)
            break
    for r in win.requests:
        r.output = None
    steps["check_after_window"] = time.perf_counter() - t
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": kind, "count": cell.chips,
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": len(win.requests) + win.stuck,
              "failed": raised + win.stuck, "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["setup_steps"] = steps
    result["window"] = {"seconds": win.seconds, "completed": completed,
                        "checked": checked, "ref_blocks": ref_blocks,
                        "clients": int(traffic["clients"]),
                        "control": bool(control)}
    result["checks"] = checks
    return result


def _step(steps: dict, name: str, t: float) -> float:
    now = time.perf_counter()
    steps[name] = now - t
    return now


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="run the entry's control in the program's place "
                         "(for the check of the comparison; not a "
                         "benchmark run)")
    a = ap.parse_args(argv)
    fix_cache_dirs(ROOT)
    try:
        res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                       t_start=t_start, control=bool(a.control))
    except NoCard as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    sys.stdout.flush()
    return 0
