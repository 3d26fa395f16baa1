"""Times the row gather's forms a and c (``ops/probes.py``, ``dma_a`` /
``dma_c``) over a set of launch geometries on one NVIDIA card, beside
form b and ``torch.index_select``, to choose ``probes.ROWS_PER_CTA``,
``probes.STAGES`` and ``probes.STAGE_BYTES``.

    python3 -m zxc_tpu_torch.row_gather_sweep [--out FILE]

Shapes: the probe's (table (4096, 128) int32, 1,024 rows; the random
draws of ``tools/tpu_indirect_dma_probe.py``), long rows (table (1024,
12000) int32, 1,024 rows) for the stage size, and the probe's table with
8,192 rows ("wide": eight times the CTAs of a geometry, to tell whether a
CTA's copies or an SM's are served in turn). Each geometry's output must
equal the plain version. Times: "back to back" is one CUDA-event pair
around 50 calls queued behind a spin (``torch.cuda._sleep``), the median
of 5 rounds, the geometries in turn within a round; "event" is the median
of 50 single calls, each between an event pair (it also holds the host's
launch path). Prints ptxas's report of the gather kernels, one line a
geometry and, last, one JSON object (also written to ``--out``). Needs a
CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

SPIN_CYCLES = 50_000_000
ROUNDS, QUEUED, SINGLE = 5, 50, 50
ROWS_A = (1, 2, 4, 8, 16)
ROWS_C = (2, 4, 8, 16, 32, 64)
STAGES_C = (2, 3, 4, 8)
STAGE_BYTES = (1024, 2048, 4096, 8192)


def back_to_back(fn) -> float:
    torch.cuda._sleep(SPIN_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(QUEUED):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / QUEUED


def event_ms(fn) -> float:
    pairs = []
    for _ in range(SINGLE):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def inputs(R: int, C: int, G: int, seed: int):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.integers(0, 256, (R, C)).astype(
        np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(0, R, (G,)).astype(np.int32)).cuda()
    return table, idx


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_gather_sweep: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from zxc_tpu_torch.ops import probes as P
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    shapes = {"probe": inputs(4096, 128, 1024, 0),
              "long": inputs(1024, 12000, 1024, 1),
              "wide": inputs(4096, 128, 8192, 2)}
    cases = []      # (label, shape, fn)
    bound = {}      # shape: (bytes to move, ms at 3.35 TB/s)
    for shape, (table, idx) in shapes.items():
        G, C = len(idx), table.shape[1]
        nbytes = P.rows_bytes_moved(table, idx)
        bound[shape] = (nbytes, nbytes / 3.35e12 * 1e3)
        want = P.gather_rows_reference(table, idx)
        idx64 = idx.long()
        cases.append((f"{shape} index_select", shape,
                      lambda t=table, i=idx64: torch.index_select(t, 0, i)))
        cases.append((f"{shape} b", shape,
                      lambda t=table, i=idx: P.dma_b(t, i)))
        plans = []
        for stage in STAGE_BYTES if shape == "long" else (P.STAGE_BYTES,):
            rows_a, rows_c, stages_c = ((ROWS_A, ROWS_C, STAGES_C)
                                        if shape != "wide" else
                                        ((1, 8), (2, 8), (2,)))
            plans += [("a", P._row_plan(G, C, True, k, 1, stage))
                      for k in rows_a]
            plans += [("c", P._row_plan(G, C, True, k, s, stage))
                      for k in rows_c for s in stages_c]
        for form, plan in plans:
            if plan.smem > 48 << 10:
                continue
            out = torch.empty_like(want)

            def fn(t=table, i=idx, o=out, f=form, p=plan):
                P._launch_rows(t, i, o, f, p)
                return o
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"row_gather_sweep: {shape} {form} {plan} differs "
                      "from the plain version", file=sys.stderr)
                sys.exit(1)
            cases.append((f"{shape} {form} rows {plan.rows_per_cta} stages "
                          f"{plan.stages} stage {4 * plan.piece} B", shape,
                          fn))
    from zxc_tpu_torch.ops import _build
    for ln in _build.build_logs.get("gather", "").splitlines():
        if "ptxas" in ln:
            print(f"  {ln.strip()}")
    b2b = {label: [] for label, _, _ in cases}
    for fn in (c[2] for c in cases):
        fn()
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for label, _, fn in cases:
            b2b[label].append(back_to_back(fn))
    rows = []
    for label, shape, fn in cases:
        row = {"case": label, "b2b_ms": statistics.median(b2b[label]),
               "b2b_rounds": b2b[label], "event_ms": event_ms(fn)}
        rows.append(row)
        print(f"{label}: {row['b2b_ms']:.5f} ms back to back (median of "
              f"{ROUNDS}), {row['event_ms']:.5f} ms event", flush=True)
    for shape, (nbytes, ms) in bound.items():
        print(f"{shape}: {nbytes} bytes to move, bound {ms:.6f} ms")
    result = {"card": smi, "rounds": ROUNDS, "queued": QUEUED,
              "bound": bound, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
