"""Level 7 of ``ops.compress_device`` on the card against the plain
reference, on the benchmark's Silesia members.

    python l7_reference_check.py [--seed N] [--out FILE]

Makes the 12 members of ``silesia-files-l7-64k`` from the seed with the
benchmark's generator, compresses each whole member as the benchmark's
timed path does (``compress_device(member, 7, 65536, checksum=True)`` on
the card), and compares the archive's blocks of each member's first
dispatch group (16 blocks of 64 KiB) and the longest member's tail block
with ``bench_port/reference/opt_parse.py``'s: its plain-torch matcher on
the card, its parse on the host in worker processes. Prints the counts
of blocks compared and equal (and writes them to ``--out`` as JSON), and
exits 1 where any block differs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def _ref_block(args):
    from bench_port.reference import opt_parse as OP
    arr, lens, offs = args
    return OP.encode_block(arr, lens, offs, True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--out")
    a = ap.parse_args()
    import torch
    from bench_port.harness import corpus
    from bench_port.reference import opt_parse as OP, zxc_numpy as R
    from zxc_tpu_torch import ops
    from zxc_tpu_torch.ops import encode as PE

    with open(os.path.join(ROOT, "bench_port", "configs",
                           "silesia-files-l7-64k.json")) as f:
        cfg = json.load(f)
    bs = int(cfg["block_size"])
    plains = corpus.make_members(cfg["members"], a.seed, 8)
    longest = max(plains, key=lambda m: len(plains[m]))
    dev = torch.device("cuda")
    jobs, got, where = [], [], []
    t0 = time.perf_counter()
    for name, plain in plains.items():
        arc = ops.compress_device(plain, 7, bs, checksum=True)
        fr = R.walk_frame(arc)
        picks = list(range(min(PE.DISPATCH, len(fr.blocks))))
        if name == longest:
            picks.append(len(fr.blocks) - 1)
        for b in picks:
            blk = fr.blocks[b]
            got.append(arc[blk.start - R.BLOCK_HEADER:
                           blk.start + blk.size + 4])
            arr = np.frombuffer(plain, np.uint8,
                                min(bs, len(plain) - b * bs), b * bs)
            lens, offs = OP.best_candidates(
                torch.from_numpy(arr.copy()).to(dev))
            jobs.append((arr, lens.cpu().numpy(), offs.cpu().numpy()))
            where.append((name, b))
    t_card = time.perf_counter() - t0
    import multiprocessing as mp
    with ProcessPoolExecutor(8, mp_context=mp.get_context("spawn")) as ex:
        want = list(ex.map(_ref_block, jobs, chunksize=4))
    bad = [w for w, g, r in zip(where, got, want) if g != r]
    res = {"seed": a.seed, "blocks_compared": len(got),
           "blocks_equal": len(got) - len(bad), "differ": bad[:20],
           "card": torch.cuda.get_device_name(0),
           "card_seconds": t_card,
           "seconds": time.perf_counter() - t0}
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
