#!/usr/bin/env python3
"""The XLA matcher's two extensions, timed against each other on one card.

    python3 xla_matcher_ab.py [--device cuda|cpu]

``compress_device`` at the library's default 512 KiB blocks takes the XLA
matcher (``zxc_tpu_torch/ops/encode.py``). Its extension is either
``_extend_rounds``, the JAX matcher's loop of 4-byte compare rounds as it
is (one round per 4 bytes of the longest match), or ``_extend_exact``,
the same loop cut short after 16 rounds, the pairs still equal then
measured by the run of equal bytes at their lag. This script runs
``compress_device`` with each on two inputs:

* the first 4 MiB of the pinned corpus (``tools/gen_corpus.py``) at
  level 3: eight 512 KiB blocks, order exact, rounds, rounds, exact;
* one 512 KiB block of a log line repeated, at level 1 (2 candidates):
  every match runs to the end of the block; order exact, rounds, exact
  (the straight loop once: it takes a round per 4 bytes).

One untimed run comes first. Both archives of an input must be equal and
decode to it. It prints the card's name and power limit, each wall time
and the ratio of the medians.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCK = 512 << 10
LINE = b"GET /static/app.js HTTP/1.1 200 1534\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.ops import encode as ENC
    from gen_corpus import gen_corpus

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"card: {smi}", flush=True)
    exact = ENC._extend_exact
    inputs = (("corpus 4 MiB, L3", gen_corpus(32 << 20)[:4 << 20], 3,
               "ERRE"),
              (f"{len(LINE)}-byte period 512 KiB, L1",
               (LINE * (BLOCK // len(LINE) + 1))[:BLOCK], 1, "ERE"))
    # one untimed run first: the process's first use of the device and of
    # the native emitter is not the matcher's time
    ENC.compress_device(inputs[0][1][:BLOCK], level=3, block_size=BLOCK,
                        device=args.device)
    try:
        for name, data, level, order in inputs:
            walls = {"E": [], "R": []}
            arcs = {}
            for which in order:
                ENC._extend_exact = (exact if which == "E"
                                     else ENC._extend_rounds)
                t0 = time.perf_counter()
                arcs[which] = ENC.compress_device(data, level=level,
                                                  block_size=BLOCK,
                                                  device=args.device)
                walls[which].append(time.perf_counter() - t0)
            if arcs["E"] != arcs["R"] or frame.decompress(arcs["E"]) != data:
                sys.exit(f"{name}: the two extensions' archives differ or "
                         "do not decode")
            e, r = (statistics.median(walls[k]) for k in "ER")
            print(f"{name}: {len(data)} bytes -> {len(arcs['E'])}; exact "
                  f"{walls['E']} s, rounds {walls['R']} s; median rounds / "
                  f"exact = {r / e:.2f}", flush=True)
    finally:
        ENC._extend_exact = exact


if __name__ == "__main__":
    main()
