#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zxc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (nvidia-smi); build the native host
   runtime (g++), the copy-engine kernels (``csrc/copy_engine.cu``, nvcc,
   sm_90a: the tile routine for v19, v13, the attic's quad-tile modes and
   v12's probe ablations, in clusters of ``copy_engine.tile_plan``; the
   (supertile, block) grid for v25/v26/v27), the encoder's kernels
   lcp/parse_walk (``csrc/encode.cu``), the attic's piece-serial,
   window-merge and lane-sum kernels with the lane-sum probes
   (``csrc/attic.cu``) and the gather probes (``csrc/gather.cu``) in
   parallel;
2. the pinned 32 MiB corpus (tools/gen_corpus.py, sha256 checked against
   tools/corpus_manifest.json), encoded by the port's native encoder at
   level 3 with 64 KiB blocks (512 blocks, 32 dispatch groups of 16), with
   4 KiB blocks (8192 blocks, 512 groups), with the default 512 KiB blocks
   (64 blocks, one device batch of 64) and seekable with 64 KiB blocks,
   and its first 4 MiB at level 7 with 64 KiB blocks (the deepest PivCo
   trees, 11-bit codes); ``write_hints`` of the 64 KiB archive, timed on
   its own;
3. each kernel against its plain PyTorch version on the card, on the first
   dispatch group as the port's pipelines ship it (v19, v26: the cold
   prep, and v26 also on the 512 KiB archive's first group, 32 supertiles
   a block, with the share of quads by supertile that read the block's
   own output; v27: the hint's control and the batch replay's flat lit;
   v13: the 4 KiB archive as ``ops/serial.py`` packs it, with v13's and
   v19's cluster sizes printed; the attic kernel: the
   64 KiB archive as ``ops.decompress(use_serial=True, variant=2)`` packs
   it; the window merge in modes v4-v7 and the lane sum in modes v9-v11:
   the same blocks as ``attic.decode_blocks_v4/v9/v10/v11`` pack them,
   and the attic kernel and the lane sum also on their worst cases
   (``attic_ab``: windows of 1,024 pieces, one piece a block, every lane
   slot spanning all 128 lanes), checked and not timed;
   ``copy_engine.quad`` in modes v12, v14-v17, v20, v21, v23 and v24: the
   same blocks as ``attic_quad.decode_blocks_vN`` packs them; v25: the
   same blocks resolved with ``self_ref=True`` as
   ``serial.decode_blocks_v25`` packs them; the probes of ``tools/`` in
   every mode their ``main()`` runs (``probes.v13_bisect``,
   ``v12_ablate2`` on v12's packing, ``v10_probe``, ``v12_ablate`` on
   v10's) on the same blocks, and the gathers beside ``torch.gather`` /
   ``torch.index_select``: gather_axis1 at each of the probe's six shapes
   (a mode each, with its ``probes.grid_plan`` form printed), the grid
   gather and the row gather at the probes' largest shapes (dma_b with
   its plan printed);
   lcp and parse_walk: the first 16 blocks of the corpus at level 3 as
   ``ops/encode.py`` feeds them, and parse_walk also on steps of 5 where
   its walks never meet, with the rounds its chunks took to converge
   (``encode_kernels.walk_rounds``); the grid gather with its form and
   cluster geometry (``probes.grid_plan``)): equal output, the kernel's median time
   over CUDA-event-timed launches, the plain version's time and the bytes
   bound (``copy_engine.bytes_moved``: the group's live control and the
   window rows it reads, read once, and the output written once;
   ``attic.bytes_moved``: 16 bytes a piece, each literal byte once and the
   output once; ``attic.bytes_moved_window`` / ``bytes_moved_lane``: the
   live ops' control, each literal byte once and the output once;
   ``encode_kernels.lcp_bytes_moved`` / ``walk_bytes_moved``; over
   3.35 TB/s), the time a call of 20 queued back to back behind a spin
   (an event pair around one call of an idle card also holds the host's
   launch path), and the walk's dependent chain, a statistic;
4. the main paths, each with every launch counter set to 0 just before
   and read just after; each output must equal the corpus (or its range)
   and each path's kernel must have launched once per group and no other
   kernel at all: the cold ``decompress_e2e`` with v26 (the default) and
   v19, and with v26 over the 512 KiB archive; the hint path
   ``decompress_e2e(hint=)`` with v27 (its default) and with v26; the default ``ops.decompress`` route (piece plans expanded by
   tensor ops) at 512 KiB and 64 KiB blocks and its chase route
   (``use_pieces=False``) at 512 KiB, which launch no hand-written kernel;
   ``Seekable.decompress_range_device`` over a range of 11 blocks of the
   seekable archive, also kernel-free; the serial route
   ``ops.decompress(use_serial=True)`` with v19 at 64 KiB blocks, v13 at
   4 KiB blocks and the attic kernel (variant 2) at 64 KiB blocks, and
   variants 1 and 3 on the first 4 MiB; the attic's window-op and
   lane-op entries ``attic.decode_blocks_v4`` (variant 4),
   ``decode_blocks_v9``, ``v10`` and ``v11`` over the 64 KiB archive and
   ``decode_blocks_v4`` with variants 5, 6 and 7 over its first 4 MiB,
   and the quad-tile entries ``attic_quad.decode_blocks_v15`` and ``v21``
   over the 64 KiB archive and ``v12``, ``v14``, ``v16``, ``v17``, ``v20``,
   ``v22``, ``v23`` and ``v24`` over its first 4 MiB (``quad`` once per
   group), on one shared section parse and resolve; ``v25`` through
   ``serial.decode_blocks_v25`` over the 64 KiB archive on the same parse
   and its own resolve (``self_ref=True``); each probe in each of its
   modes over the first 4 MiB (a launch a group and mode; the full modes
   equal to the corpus, the ablated ones to their plain versions) and the
   gathers at the probes' own shapes; the device encode
   ``ops.compress_device`` of the corpus at level 3 with 64 KiB blocks
   (lcp and parse_walk once per group of 16 blocks). Fingerprint forms
   must equal the fingerprints computed on the host; the device encode's
   archive must decode to the corpus through the native decoder and
   ``decompress_e2e``, stay within 2% of the native encoder's size, and
   its first 1 MiB must equal the CPU route's archive; a 1 MiB run at
   128 KiB blocks (the XLA matcher) must decode. The device entropy
   decode ``ops.decompress(device_entropy=True)`` (the PivCo literal
   sections routed on the card from their wire bytes by
   ``pivco_device.route_sections``, tensor ops, then the chase route)
   over the 64 KiB and 512 KiB level-3 archives and the level-7 archive:
   each equal to its plaintext, route ``chase``, sections deferred, no
   hand-written kernel launched, with the H2D bytes of the deferred route
   and of the chase route on host literals; ``Dctx(device=True)`` on the
   512 KiB archive inside ``profiling.collect_phases()``, and one decode
   inside ``profiling.trace``, whose trace must hold CUDA events. Wall
   time, GB/s and phase times, and the device busy share of one cold v26
   decode, one hint decode, one default-route decode at 512 KiB, the
   chase route and the device entropy route at 512 KiB (which must show
   device time) and one device encode (torch.profiler);
5. the command line (``zxc_tpu_torch.cli.main`` in process, on the
   corpus in a scratch directory, every launch counter set to 0 before
   each command and read after it): ``-z -3 -k --device -B 64K --hints``
   (its archive equal to ``ops.compress_device(data, 3, 65536,
   checksum=True)``'s, lcp and parse_walk once per group), ``-d --device
   --hints -o`` (v27 once per group, output equal to the corpus), ``-t
   --device`` and ``-d --device -D`` (the default route, no hand-written
   kernel), ``-l -j``, ``--train`` on the first 1 MiB in 64 KiB samples
   and ``-z -D`` with its dictionary, and ``-b 1 --device -j``, each wall
   beside the library call it wraps (command, call, call, command: the
   best of each pair); then ``python3 -m zxc_tpu_torch -d
   --device --hints -c`` in a subprocess, whose stdout must equal the
   corpus;
6. the sharded path (``parallel``): in process over an NCCL group of one
   rank, ``decode_plan_sharded`` (its plan included) on the 64 KiB and
   512 KiB archives beside ``ops.decompress``'s default route and its
   chase route, interleaved, best of 3; ``decode_plan_dp_sp`` on a
   (1, 1) mesh at 64 KiB; ``compress_sharded`` of the corpus less 99
   bytes at level 3, 64 KiB blocks, checksums on (the tail block through
   ``lcp`` and ``parse_walk``, once each), decoded back by the native
   decoder; every decode equal to the corpus, launching no hand-written
   kernel; a truncated archive and a tampered plan raise ZxcError. Then
   two gloo ranks sharing the card (``parallel.launch``, ``jobs``): the
   64 KiB archive through ``decode_plan_sharded`` on (2,) and
   ``decode_plan_dp_sp`` on (1, 2), ``compress_sharded`` of 3 blocks,
   each rank's bytes equal to the data, and the two corrupt cases
   raising the same ZxcError on both ranks; ``dryrun_multichip(1)`` over
   NCCL, and ``dryrun_multichip(2)`` where the machine has two cards;
7. the host codec surfaces (``host_phase``): ``CStream`` at level 3,
   64 KiB blocks and checksums, pushed in chunks of 1 MiB + 7 bytes and
   drained in 64 KiB windows, and ``codec.stream.stream_compress`` with
   ``os.cpu_count()`` threads must each equal ``compress`` of the corpus
   with the same options; that archive must decode to the corpus through
   ``decompress_e2e`` (every counter zeroed first: v26 once a group and
   nothing else), ``Dctx(device=True)``, ``DStream`` (the same pushes and
   windows), ``codec.stream.stream_decompress`` and ``decompress_inplace``
   in one buffer of ``decompress_inplace_bound`` bytes; on the first
   4 MiB, ``train_dict`` + ``train_dict_huf`` over 64 samples of 16 KiB,
   then ``Cctx(level=6)`` with that dictionary and ``Cctx(level=7)``
   without one, each archive (and a ``compress_block``) decoded on the
   host and by ``ops.decompress`` on the card, which launches no
   hand-written kernel; each wall with its MB/s;
8. corruption must raise ZxcError: a flipped payload byte with checksums
   on and a truncated archive (cold path, default route, serial route,
   device entropy route, ``DStream``, ``codec.stream.stream_decompress``
   and ``decompress_inplace``), a hint of another archive, a truncated
   hint and a hint whose qbase carries the (1<<24)|64 flip.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it fails without printing a result.
"""
import atexit
import hashlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
CORPUS_BYTES = 32 << 20
BLOCK = 64 << 10
DISPATCH = 16
SMALL_BLOCK = 4 << 10
DEFAULT_BLOCK = 512 << 10     # the encoder's default block size
ATTIC_SOURCE = "zxc_tpu_torch/csrc/attic.cu"
ATTIC_REPLACES = "tools/kernel_attic.py:272"
# the attic's window-op (v4-v7: one pallas_call) and lane-op kernels
ATTIC_V_REPLACES = {4: "tools/kernel_attic.py:483",
                    5: "tools/kernel_attic.py:483",
                    6: "tools/kernel_attic.py:483",
                    7: "tools/kernel_attic.py:483",
                    9: "tools/kernel_attic.py:831",
                    10: "tools/kernel_attic.py:989",
                    11: "tools/kernel_attic.py:1102"}
# the attic's quad-tile kernels, ported as modes of copy_engine.quad
QUAD_REPLACES = {12: "tools/kernel_attic.py:1224",
                 14: "tools/kernel_attic.py:1340",
                 15: "tools/kernel_attic.py:1567",
                 16: "tools/kernel_attic.py:1702",
                 17: "tools/kernel_attic.py:1834",
                 20: "tools/kernel_attic.py:2464",
                 21: "tools/kernel_attic.py:2617",
                 23: "tools/kernel_attic.py:2356",
                 24: "tools/kernel_attic.py:2771"}
HEAD_BLOCKS = 64              # the first 4 MiB at 64 KiB blocks
V25_REPLACES = "zxc_tpu/ops/pallas_decode.py:780"
# the probes of tools/: (source, pallas_call site)
PROBES = {"v13_bisect": ("copy_engine", "tools/tpu_v13_bisect.py:118"),
          "v12_ablate2": ("copy_engine", "tools/tpu_v12_ablate2.py:124"),
          "v10_probe": ("attic", "tools/tpu_v10_probe.py:119"),
          "v12_ablate": ("attic", "tools/tpu_v12_ablate.py:123"),
          "gather_axis1": ("gather", "tools/tpu_pallas_gather_probe.py:44"),
          "gather_grid": ("gather", "tools/tpu_pallas_gather_probe.py:59"),
          "dma_a": ("gather", "tools/tpu_indirect_dma_probe.py:56"),
          "dma_b": ("gather", "tools/tpu_indirect_dma_probe.py:76"),
          "dma_c": ("gather", "tools/tpu_indirect_dma_probe.py:111")}
# tpu_pallas_gather_probe.main()'s shapes: (M, N) i32, then (8, 64K) u8
GATHER_SHAPES = ((8, 1 << 13), (8, 1 << 16), (8, 1 << 19), (64, 1 << 16),
                 (256, 1 << 13))
GRID_SHAPE = (8, 1 << 16, 1 << 19, 1 << 13)     # M, N, index columns, tile
DMA_SHAPE = (4096, 128, 1024)                   # R, C, G
REPLACES = {19: "zxc_tpu/ops/pallas_decode.py:1306",
            26: "zxc_tpu/ops/pallas_decode.py:1038",
            27: "zxc_tpu/ops/pallas_decode.py:1188",
            13: "zxc_tpu/ops/pallas_decode.py:279"}
SOURCE = "zxc_tpu_torch/csrc/copy_engine.cu"
ENC_SOURCE = "zxc_tpu_torch/csrc/encode.cu"
ENC_REPLACES = {"lcp": "zxc_tpu/ops/pallas_encode.py:202",
                "parse_walk": "zxc_tpu/ops/pallas_encode.py:257"}
ENC_LEVEL = 3
XLA_BLOCK = 128 << 10
HEAD_BYTES = 4 << 20          # the first 4 MiB
SHARD_ENC_BYTES = CORPUS_BYTES  # compress_sharded's data, less 99 bytes


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms, one CUDA-event pair per call."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


SPIN_CYCLES = 50_000_000      # ~25 ms of the card's clock


def device_ms(fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, back to back: one event
    pair around ``n`` calls that the host queues while the card spins
    (``torch.cuda._sleep``), so the card never waits for the host's
    launch path, which an event pair around one call of an idle card
    holds. ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def host_fingerprint(data: bytes, block: int) -> tuple[int, int]:
    """f1 = sum of bytes, f2 = sum of byte * (offset in block % 8191),
    both mod 2^32 (the JAX package's device fingerprint)."""
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    w = np.arange(len(a), dtype=np.int64) % block % 8191
    return int(a.sum()) & 0xFFFFFFFF, int((a * w).sum()) & 0xFFFFFFFF




def kernel_families():
    from zxc_tpu_torch.ops import attic, copy_engine, encode_kernels, probes
    return (copy_engine.KERNELS, encode_kernels.KERNELS, attic.KERNELS,
            probes.KERNELS)


def zero_counts() -> None:
    for fam in kernel_families():
        for k in fam.values():
            k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for fam in kernel_families()
            for name, k in fam.items()}


def kernel_row(name, source, replaces, kern, ref, nbytes, shape,
               diff=None, first_group=None, library=None):
    """A kernel against its plain version on one group: equal outputs
    (``diff`` gives the max abs error; by default of one tensor) and, with
    ``first_group``, bytes equal to the corpus; kernel and plain times;
    bound; with ``library``, the time of the one PyTorch call that
    computes the same function. Returns the row."""
    out, plain = kern(), ref()
    torch.cuda.synchronize()
    err = (diff(out, plain) if diff else
           int((out.int() - plain.int()).abs().max()))
    check(err == 0, f"{name} kernel differs from its plain version "
          f"(max abs err {err})")
    if first_group is not None:
        check(first_group(out), f"{name} kernel's first group differs from "
              "the corpus")
    ms = cuda_ms(kern, reps=50)
    plain_ms = cuda_ms(ref, reps=5, warm=1)
    dev_ms = device_ms(kern)
    lib_ms = cuda_ms(library, reps=50) if library else None
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": lib_ms, "b2b_ms": dev_ms}
    lib = ""
    if library:
        row["library_b2b_ms"] = device_ms(library)
        lib = (f", library {lib_ms:.4f} ms ({row['library_b2b_ms']:.4f} "
               "back to back)")
    print(f"kernel {name}: {shape}, {nbytes} bytes to move; {ms:.4f} ms "
          f"(median of 50) vs plain {plain_ms:.2f} ms{lib}, bound "
          f"{row['bound_ms']:.6f} ms; {dev_ms:.4f} ms a call back to back "
          "(20 queued behind a spin); equal", flush=True)
    return row


def modes_row(name, source, replaces, modes, row_of, lead=None):
    """One kernel row for a probe run in several modes: ``row_of(mode)``
    gives each mode's ``kernel_row``; the numbers of mode ``lead`` (by
    default the first) stand in the row, every mode's under ``modes``
    (with the library's times where the mode has them)."""
    rows = {str(m): row_of(m) for m in modes}
    row = dict(rows[str(lead)] if lead is not None
               else next(iter(rows.values())), name=name, source=source,
               replaces=replaces)
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row["modes"] = {m: {k: r[k] for k in ("ms", "b2b_ms", "plain_ms",
                                          "bound_ms", "library_ms",
                                          "library_b2b_ms") if k in r}
                    for m, r in rows.items()}
    return row


def walk_err(out, plain) -> int:
    """Max abs error of a parse walk against its plain version: nseq, and
    pos where the walk defines it."""
    from zxc_tpu_torch.ops.encode_kernels import walk_defined
    (n, pos), (rn, rpos) = out, plain
    live = walk_defined(rn, pos.shape[1])
    return max(int((n - rn).abs().max()),
               int(torch.where(live, pos - rpos, 0).abs().max()))


def run_compress(EK, n_groups, fn, data, native_len, reps=3):
    """The device encode path: counters zeroed before and read after its
    first run, which must launch lcp and parse_walk once per group and no
    other kernel, decode to ``data`` and stay within 2% of the native
    archive; then the best of ``reps`` timed runs with phases. Returns
    (launches, archive)."""
    zero_counts()
    ph = {}
    t0 = time.perf_counter()
    arc = fn(ph)
    wall0 = time.perf_counter() - t0
    counts = read_counts()
    want = {v: (n_groups if v in EK.KERNELS else 0) for v in counts}
    check(counts == want, f"compress_device: launches {counts}, expected "
          f"{want}")
    check(len(arc) <= native_len * 1.02, f"compress_device archive "
          f"{len(arc)} bytes, native {native_len} (over 2%)")
    walls, phs = [], []
    for _ in range(reps):
        p = {}
        t0 = time.perf_counter()
        r = fn(p)
        walls.append(time.perf_counter() - t0)
        phs.append(p)
        check(r == arc, "compress_device: repeat differs")
    best = min(range(reps), key=lambda i: walls[i])
    print(f"compress_device L{ENC_LEVEL} 64 KiB: launches {counts}, archive "
          f"{len(arc)} bytes ({len(arc) / native_len:.4f} of native "
          f"{native_len}); first wall {wall0:.4f} s; best of {reps} "
          f"{walls[best]:.4f} s = {len(data) / 1e9 / walls[best]:.4f} GB/s; "
          "phases " + fmt_phases(phs[best]), flush=True)
    return counts, arc


def out_quads(qs, qbase, RLP: int) -> str:
    """Per supertile, the quads a v26 group runs (pair-floored ranges
    clipped to [0, MAXQ)) whose window reaches the block's own output
    (qbase + 127 >= RLP), as "out/all" strings."""
    qs, qbase = qs.cpu().numpy(), qbase.cpu().numpy()
    shares = []
    for t in range(qs.shape[1] - 1):
        n = o = 0
        for b in range(qs.shape[0]):
            q0 = int(qs[b, t])
            hi = min(q0 + 2 * max(0, (int(qs[b, t + 1]) - q0) >> 1),
                     qbase.shape[1])
            live = qbase[b, max(q0, 0):max(hi, 0)].astype(np.int64)
            n += len(live)
            o += int((live + 127 >= RLP).sum())
        shares.append(f"{o}/{n}")
    return " ".join(shares)


def group_bytes_equal(data, totals, block, dispatch):
    def ok(out):
        host = out.cpu().numpy().reshape(dispatch, -1)
        dec = b"".join(host[j, :totals[j]].tobytes() for j in range(dispatch))
        return dec == data[:len(dec)]
    return ok


def run_path(name, kernel, n_launch, fn, data, reps=3):
    """One main path: counters zeroed before and read after its first run,
    which must equal ``data`` with ``n_launch`` launches of ``kernel`` and
    none of any other (``kernel=None``: no launch at all); then the best of
    ``reps`` timed runs. Returns the launches."""
    zero_counts()
    ph = {}
    t0 = time.perf_counter()
    out = fn(ph)
    wall0 = time.perf_counter() - t0
    counts = read_counts()
    check(out == data, f"{name}: output differs from the corpus")
    want = {v: (n_launch if v == kernel else 0) for v in counts}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    walls, phs = [], []
    for _ in range(reps):
        p = {}
        t0 = time.perf_counter()
        r = fn(p)
        walls.append(time.perf_counter() - t0)
        phs.append(p)
        check(r == data, f"{name}: repeat differs")
    best = min(range(reps), key=lambda i: walls[i])
    print(f"{name}: launches {counts}, first wall {wall0:.4f} s (phases "
          + fmt_phases(ph) + f"); best of {reps} {walls[best]:.4f} s = "
          f"{len(data) / 1e9 / walls[best]:.4f} GB/s; phases "
          + fmt_phases(phs[best]), flush=True)
    return counts.get(kernel, 0)


def attic_rows(AT, pieces, lits, totals, data) -> dict:
    """The window merge in modes 4-7 and the lane sum in modes 9-11
    against their plain versions on one dispatch group, packed as
    ``attic.decode_blocks_v4/v9/v10/v11`` pack it."""
    def row(v, host, kern, ref, nbytes, shape):
        args = [torch.from_numpy(a).cuda() for a in host]
        return kernel_row(f"v{v}", ATTIC_SOURCE, ATTIC_V_REPLACES[v],
                          lambda: kern(*args), lambda: ref(*args), nbytes,
                          shape, first_group=group_bytes_equal(
                              data, totals, BLOCK, len(pieces)))

    out = {}
    for v in (4, 5, 6, 7):
        host, (OR, RL, NW) = AT.pack_blocks_v4(
            pieces, lits, totals, BLOCK, split_src=v >= 5,
            pad_unroll={6: AT.UNROLL, 7: AT.UNROLL7}.get(v, 0))
        n_ops = int(host[0][:, -1].sum())
        out[v] = row(v, host,
                     lambda *a: AT.window_merge(*a, block=BLOCK, mode=v),
                     lambda *a: AT.window_merge_reference(*a, block=BLOCK,
                                                          mode=v),
                     AT.bytes_moved_window(host[0], host[1], lits, BLOCK),
                     f"window merge mode {v}, {n_ops} ops (padding "
                     f"included), OR={OR} RL={RL} NW={NW}")
    nb, ts, rws, pctrl, lit32 = AT.pack_blocks_v9(pieces, lits, totals,
                                                  BLOCK)
    out[9] = row(9, (pctrl, lit32, ts, rws),
                 lambda pc, l, t, r: AT.lane_sum(pc, l, BLOCK, 9, ts=t,
                                                 rows=r),
                 lambda pc, l, t, r: AT.lane_sum_reference(
                     pc, l, BLOCK, 9, ts=t, rows=r),
                 AT.bytes_moved_lane(pctrl, lits, BLOCK, 9, ts, nb),
                 f"lane sum mode 9, {int(nb.sum())} batches, MAXB="
                 f"{rws.shape[1] // 32} G32={pctrl.shape[1]} "
                 f"RL={lit32.shape[1]}")
    nb, ts, pctrl, lit8 = AT.pack_blocks_v10(pieces, lits, totals, BLOCK)
    out[10] = row(10, (pctrl, lit8, ts),
                  lambda pc, l, t: AT.lane_sum(pc, l, BLOCK, 10, ts=t),
                  lambda pc, l, t: AT.lane_sum_reference(pc, l, BLOCK, 10,
                                                         ts=t),
                  AT.bytes_moved_lane(pctrl, lits, BLOCK, 10, ts, nb),
                  f"lane sum mode 10, G32={pctrl.shape[1]} "
                  f"RLP={lit8.shape[1]}")
    from zxc_tpu_torch.ops import serial
    layers = AT.v11_layers(serial.lane_ops_blocks(pieces, totals))
    pctrl, lit8 = AT.pack_blocks_v11(pieces, lits, totals, BLOCK,
                                     LAYERS=layers)
    out[11] = row(11, (pctrl, lit8),
                  lambda pc, l: AT.lane_sum(pc, l, BLOCK, 11, layers=layers),
                  lambda pc, l: AT.lane_sum_reference(pc, l, BLOCK, 11,
                                                      layers=layers),
                  AT.bytes_moved_lane(pctrl, lits, BLOCK, 11),
                  f"lane sum mode 11, LAYERS={layers} G32={pctrl.shape[1]} "
                  f"RLP={lit8.shape[1]}")
    return out


def attic_worst_cases(AT, pieces, lits, totals) -> None:
    """The piece-serial kernel and the lane sum on their hand-made worst
    cases (``zxc_tpu_torch.attic_ab``): windows of 1,024 one-byte pieces
    and of 1,024 pieces with one start, one piece a block (v1 and v2), and
    v10's first group with every slot spanning all 128 lanes; each equal to
    its plain version."""
    from zxc_tpu_torch import attic_ab as AB
    for label, host in AB.piece_worst_cases(lits, 0).items():
        args = [torch.from_numpy(a).cuda() for a in host]
        for fill in (False, True):
            check(torch.equal(
                AT.piece_serial(*args, block=BLOCK, fill_from_s=fill),
                AT.piece_serial_reference(*args, block=BLOCK,
                                          fill_from_s=fill)),
                f"attic kernel differs on {label} (fill {fill})")
    _, ts, pctrl, lit8 = AT.pack_blocks_v10(pieces, lits, totals, BLOCK)
    ts, pctrl, lit8 = (torch.from_numpy(a).cuda()
                       for a in (ts, AB.all_lanes(pctrl), lit8))
    check(torch.equal(AT.lane_sum(pctrl, lit8, BLOCK, 10, ts=ts),
                      AT.lane_sum_reference(pctrl, lit8, BLOCK, 10, ts=ts)),
          "lane sum differs with every slot spanning all 128 lanes")
    print("attic kernel (windows of 1,024 one-byte pieces and of 1,024 "
          "equal starts, one piece a block) and lane sum (every slot all "
          "128 lanes): equal to their plain versions", flush=True)


def quad_rows(CE, Q, pieces, lits, totals, data) -> dict:
    """``copy_engine.quad`` in each attic mode against its plain version on
    one dispatch group, packed as ``attic_quad.decode_blocks_vN`` packs
    it."""
    out = {}
    for v in QUAD_REPLACES:
        mode, pack, _ = Q.VARIANTS[v]
        host = pack(pieces, lits, totals, BLOCK)
        args = CE.group_from_numpy(*host, device="cuda")
        out[v] = kernel_row(
            f"v{v}", SOURCE, QUAD_REPLACES[v],
            lambda: CE.quad(*args, mode=mode),
            lambda: CE.quad_reference(*args, mode=mode),
            CE.bytes_moved(*host, mode=mode),
            f"quad mode {mode}, {int(host[0][:, -1].sum())} quads, "
            f"MAXQ={host[1].shape[1]} pctrl rows={host[2].shape[1]} "
            f"RLP={host[4].shape[1]}",
            first_group=group_bytes_equal(data, totals, BLOCK, len(pieces)))
    return out


def probe_source(name: str) -> str:
    return f"zxc_tpu_torch/csrc/{PROBES[name][0]}.cu"


def probe_rows(CE, AT, P, S, pieces, lits, totals, data) -> dict:
    """The decode probes of ``tools/`` in every mode their ``main()`` runs,
    each against its plain version on one dispatch group packed as the
    probe packs it (v12's packing with quad_align 2 for v13_bisect and 1
    for v12_ablate2; v10's for the lane probes); the full modes' bytes
    equal the corpus."""
    fg = group_bytes_equal(data, totals, BLOCK, len(pieces))
    out = {}
    for name, qa, modes in (("v13_bisect", 2, P.V13_BISECT_MODES),
                            ("v12_ablate2", 1, P.V12_ABLATE2_MODES)):
        host = S.pack_blocks_v12(pieces, lits, totals, BLOCK, quad_align=qa)
        args = CE.group_from_numpy(*host, device="cuda")
        shape = (f"v12 packing (quad_align={qa}), "
                 f"{int(host[0][:, -1].sum())} quads, MAXQ="
                 f"{host[1].shape[1]} RLP={host[4].shape[1]}")
        if name == "v13_bisect":
            def one(m, host=host, args=args, shape=shape):
                return kernel_row(
                    f"v13_bisect {m}", probe_source(name), PROBES[name][1],
                    lambda: P.v13_bisect(*args, *m),
                    lambda: P.v13_bisect_reference(*args, *m),
                    CE.bytes_moved(*host, K=1, rows=CE.V13_ROWS) if m[1]
                    else CE.bytes_moved(*host, mode=12), shape,
                    first_group=fg)
        else:
            def one(m, host=host, args=args, shape=shape):
                return kernel_row(
                    f"v12_ablate2 {m}", probe_source(name), PROBES[name][1],
                    lambda: P.v12_ablate2(*args, m),
                    lambda: P.v12_ablate2_reference(*args, m),
                    CE.bytes_moved(*host, mode=12,
                                   ablate=None if m == "full" else m),
                    shape, first_group=fg if m == "full" else None)
        out[name] = modes_row(name, probe_source(name), PROBES[name][1],
                              modes, one)
    nb, ts, pctrl, lit8 = AT.pack_blocks_v10(pieces, lits, totals, BLOCK)
    args = [torch.from_numpy(a).cuda() for a in (ts, pctrl, lit8)]
    for name, modes in (("v10_probe", P.V10_PROBE_MODES),
                        ("v12_ablate", P.V12_ABLATE_MODES)):
        def one(m, name=name):
            return kernel_row(
                f"{name} {m}", probe_source(name), PROBES[name][1],
                lambda: P.KERNELS[name](*args, m),
                lambda: P.lane_probe_reference(name, *args, m),
                AT.bytes_moved_lane(pctrl, lits, BLOCK, 10, ts, nb,
                                    probe=P.lane_probe_kind(name, m, lit8)),
                f"v10 packing, {int(nb.sum())} batches, G32="
                f"{pctrl.shape[1]} RLP={lit8.shape[1]}",
                first_group=fg if m == "full" else None)
        out[name] = modes_row(name, probe_source(name), PROBES[name][1],
                              modes, one)
    return out


def gather_inputs(seed: int, M: int, N: int, NI: int, dtype=np.int32):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 100
    x = torch.from_numpy(rng.integers(0, hi, (M, N)).astype(dtype)).cuda()
    idx = torch.from_numpy(rng.integers(0, N, (M, NI)).astype(
        np.int32)).cuda()
    return x, idx


def dma_inputs():
    R, C, G = DMA_SHAPE
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(0, 256, (R, C)).astype(
        np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(0, R, (G,)).astype(np.int32)).cuda()
    return table, idx


def gather_modes() -> dict:
    """gather_axis1's modes: the probe's six shapes, "(M, N) dtype" ->
    (M, N, dtype), each with a square index."""
    shapes = ([(M, N, np.int32) for M, N in GATHER_SHAPES]
              + [(8, 1 << 16, np.uint8)])
    return {f"({M}, {N}) {np.dtype(dt).name}": (M, N, dt)
            for M, N, dt in shapes}


def gather_rows_of(P) -> dict:
    """The gathers against their plain versions, beside the PyTorch call
    for the same function (an int64 index made beforehand): gather_axis1
    at each of the probe's shapes with its ``grid_plan`` (the row's
    numbers those of (8, 512K)), the grid gather and the row gather at the
    probes' largest shapes."""
    out = {}

    def axis1(mode):
        M, N, dt = modes[mode]
        x, idx = gather_inputs(0, M, N, N, dt)
        idx64 = idx.long()
        plan = P.gather_grid_plan(x, idx, torch.empty_like(idx,
                                                           dtype=x.dtype))
        return kernel_row(
            f"gather_axis1 {mode}", probe_source("gather_axis1"),
            PROBES["gather_axis1"][1], lambda: P.gather_axis1(x, idx),
            lambda: P.gather_axis1_reference(x, idx),
            P.gather_bytes_moved(x, idx),
            f"x {mode}, idx ({M}, {N}); {plan.form} form, K={plan.K}, "
            f"{plan.clusters * plan.K * M} CTAs",
            library=lambda: torch.gather(x, 1, idx64))
    modes = gather_modes()
    out["gather_axis1"] = modes_row(
        "gather_axis1", probe_source("gather_axis1"),
        PROBES["gather_axis1"][1], list(modes), axis1,
        lead="(8, 524288) int32")
    M, N, NI, T = GRID_SHAPE
    x, idx = gather_inputs(1, M, N, NI)
    idx64 = idx.long()
    plan = P.gather_grid_plan(x, idx, torch.empty_like(idx))
    print(f"gather_grid: {plan.form} form, clusters of {plan.K} CTAs, "
          f"{plan.clusters} a row, {plan.slice * plan.esize} bytes of the "
          f"row a CTA, {plan.cols} index columns a cluster; {plan}",
          flush=True)
    out["gather_grid"] = kernel_row(
        "gather_grid", probe_source("gather_grid"),
        PROBES["gather_grid"][1], lambda: P.gather_grid(x, idx, T),
        lambda: P.gather_axis1_reference(x, idx),
        P.gather_bytes_moved(x, idx),
        f"x ({M}, {N}) int32, idx ({M}, {NI}), tile {T}; {plan.form} form, "
        f"K={plan.K}, {plan.clusters * plan.K * M} CTAs",
        library=lambda: torch.gather(x, 1, idx64))
    table, idx = dma_inputs()
    idx64 = idx.long()
    for name, fn in (("dma_a", P.dma_a), ("dma_b", P.dma_b),
                     ("dma_c", P.dma_c)):
        plan = P.row_plan(len(idx), table.shape[1], name[-1])
        if name == "dma_b":
            print(f"dma_b: a warp a row, {plan.rows_per_cta} rows a CTA, "
                  f"{plan.grid} CTAs of {32 * plan.rows_per_cta} threads, "
                  f"{16 if plan.bulk else 4}-byte copies; {plan}",
                  flush=True)
        out[name] = kernel_row(
            name, probe_source(name), PROBES[name][1],
            lambda fn=fn: fn(table, idx),
            lambda: P.gather_rows_reference(table, idx),
            P.rows_bytes_moved(table, idx),
            f"table {tuple(table.shape)} int32, idx ({len(idx)},), "
            f"{plan.grid} CTAs of {plan.rows_per_cta} rows, "
            f"{plan.stages} stages, bulk {plan.bulk}",
            library=lambda: torch.index_select(table, 0, idx64))
    return out


def run_probe(name, groups, modes, call, ref, decodes, want_bytes,
              totals) -> int:
    """One probe in each mode over ``groups`` (tensors on the card), with
    every launch counter set to 0 before and read after: a launch a group
    and mode, none of any other kernel; a mode that ``decodes`` gives the
    corpus's bytes, the others equal their plain versions. Returns the
    launches."""
    zero_counts()
    t0 = time.perf_counter()
    for m in modes:
        outs = []
        for g in groups:
            got = call(g, m)
            if decodes(m):
                outs.append(got.cpu().numpy().reshape(got.shape[0], -1))
            else:
                check(torch.equal(got, ref(g, m)), f"{name} {m}: the kernel "
                      "differs from its plain version")
        if decodes(m):
            host = np.concatenate(outs)
            dec = b"".join(host[j, :t].tobytes() for j, t in
                           enumerate(totals))
            check(dec == want_bytes, f"{name} {m}: output differs from the "
                  "corpus")
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = len(groups) * len(modes)
    want = {k: (n if k == name else 0) for k in counts}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    print(f"probe {name}: {len(modes)} modes x {len(groups)} groups, "
          f"launches {counts[name]}, {wall:.4f} s with the checks; full "
          "modes equal the corpus, ablated modes their plain versions",
          flush=True)
    return counts[name]


def fmt_phases(ph: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in ph.items()) or "not recorded"


def profile_share(name, fn) -> float | None:
    """Device busy share of one decode (torch.profiler, CUPTI): kernel and
    copy time on the card over the decode's wall time. Returns the busy
    seconds, None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    busy_us = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0}
    calls = {ev.key: ev.count for ev in prof.key_averages()
             if ev.key in busy_us}
    if not busy_us:
        print(f"profile {name}: the profiler recorded no device time "
              "(device busy share not measured)", flush=True)
        return None
    top = sorted(busy_us.items(), key=lambda kv: -kv[1])[:4]
    busy = sum(busy_us.values()) / 1e6
    print(f"profile {name}: wall {wall:.4f} s, device busy {busy:.5f} s "
          f"(idle share {1 - busy / wall:.4f}); top: "
          + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms ({calls[k]} calls)"
                      for k, v in top),
          flush=True)
    return busy


def h2d_bytes(BT, PV, arc: bytes, batch: int) -> dict:
    """Bytes the chase route (``decode_plan_device``) ships to the card:
    each padded batch's arrays, and with deferred sections also their
    ``pad_plans`` arrays (wire bytes and routing tables); the deferred
    blocks' literal rows still ship, as zeros. Returns {"host": bytes with
    host-decoded literals, "deferred": bytes with deferred sections,
    "zero_rows": the zero literal bytes inside "deferred"}."""
    from zxc_tpu_torch.codec.block_decode import DeferredSection
    out = {}
    for key, defer in (("host", False), ("deferred", True)):
        plan = BT.plan_frame(arc, defer_entropy=defer)
        S, L = BT._pow2(plan.max_seq), BT._pow2(plan.max_lit)
        nb = plan.n_blocks
        Bsz = BT._pow2(min(batch, nb), lo=4)
        total = zero = 0
        for base in range(0, nb, Bsz):
            idx = range(base, min(base + Bsz, nb))
            total += sum(a.nbytes for a in BT._pad_batch(plan, idx, S, L,
                                                         B=Bsz))
            secs = [plan.lit[i] for i in idx
                    if isinstance(plan.lit[i], DeferredSection)]
            if secs:
                plans = [PV.plan_section(s.payload, s.n, s.tree)
                         for s in secs]
                args = PV.pad_plans([s.payload for s in secs], plans, L=L)[0]
                total += sum(a.nbytes for a in args)
                zero += len(secs) * L
        out[key] = total
        if defer:
            out["zero_rows"] = zero
    return out


def flipped_qbase_hint(H, path: str, out_path: str) -> None:
    """A copy of the hint at ``path`` whose first qbase word carries the
    (1<<24)|64 flip, re-framed so its header and body hash stay valid."""
    import zxc_tpu_torch as Z
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch import runtime
    raw = open(path, "rb").read()
    f = list(H._HDR.unpack(raw[:H.HEADER_SIZE]))
    nb, NST = f[6], f[12]
    body = bytearray(frame.decompress(raw[H.HEADER_SIZE:]))
    qb_off = 8 * (3 * nb + nb + 1) + 4 * nb * (NST + 1)
    body[qb_off:qb_off + 4] = ((1 << 24) | 64).to_bytes(4, "little")
    comp = Z.compress(bytes(body), Z.EncodeOpts(level=1, block_size=1 << 20,
                                                checksum=True))
    f[13] = runtime.rapidhash64(comp[:4096]) ^ len(comp)
    with open(out_path, "wb") as fo:
        fo.write(H._HDR.pack(*f) + comp)


CLI_TRAIN_BYTES = 1 << 20     # --train samples: the corpus's first 1 MiB
CLI_SAMPLE = 64 << 10         # in samples of 64 KiB


def cli_phase(Z, EK, data: bytes, out_dir: str, n_groups: int) -> None:
    """The command line (``zxc_tpu_torch.cli.main``, in process) on the
    corpus in a scratch directory, every launch counter set to 0 before
    each command and read after it: each command must exit 0 and launch
    what its path launches, its outputs must equal the corpus, and its
    wall stands beside the wall of the library call it wraps (command,
    call, call, command; the best of each). Then one ``python3 -m zxc_tpu_torch -d --device --hints
    -c`` in a subprocess, whose stdout must equal the corpus."""
    import contextlib
    import io
    from zxc_tpu_torch import cli
    d = tempfile.mkdtemp(prefix="cli-", dir=out_dir)
    src = os.path.join(d, "corpus.bin")
    with open(src, "wb") as f:
        f.write(data)
    arc_path, hint_path = src + ".zxc", src + ".zxc.zxh"

    def read(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def command(label, argv, want=None, library=None, nbytes=len(data)):
        """Runs ``argv``, which must exit 0; ``want`` maps kernel to
        launches (others 0), read around each run. With ``library``, the
        call the command wraps, the order is command, call, call, command
        (the command's outputs forced) and the best of each pair stands;
        rates are of ``nbytes`` (None: no rate). Returns the command's
        stdout."""
        def run() -> tuple[float, str]:
            zero_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts = read_counts()
            check(rc == 0, f"cli {label}: exit code {rc}")
            expect = {k: (want or {}).get(k, 0) for k in counts}
            check(counts == expect, f"cli {label}: launches {counts}, "
                  f"expected {expect}")
            return wall, buf.getvalue()

        def timed(fn) -> float:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def rate(t: float) -> str:
            return f" = {nbytes / 1e9 / t:.4f} GB/s" if nbytes else ""

        wall, out = run()
        walls, lib = [wall], ""
        if library is not None:
            name, fn = library
            libs = [timed(fn), timed(fn)]
            walls.append(run()[0])
            lib = (f"; library call {name} best {min(libs):.4f} s"
                   f"{rate(min(libs))} (runs "
                   + ", ".join(f"{t:.4f}" for t in libs) + ")")
        print(f"cli {label}: wall best {min(walls):.4f} s{rate(min(walls))}"
              " (runs " + ", ".join(f"{t:.4f}" for t in walls) + "), "
              f"launches { {k: v for k, v in (want or {}).items() if v} }"
              + lib, flush=True)
        return out

    arc_lib = {}
    command("-z -3 -k --device -B 64K --hints",
            ["-z", "-3", "-k", "-f", "-q", "--device", "-B", "64K", "--hints",
             src],
            {k: n_groups for k in EK.KERNELS},
            ("compress_device(checksum=True) + write_hints", lambda: arc_lib
             .update(arc=Z.ops.compress_device(data, 3, BLOCK, checksum=True),
                     hint=Z.write_hints(read(arc_path),
                                        os.path.join(d, "lib.zxh")))))
    arc = read(arc_path)
    check(arc == arc_lib["arc"], "cli -z --device: the archive differs from "
          "ops.compress_device(data, 3, 65536, checksum=True)'s")
    check(os.path.exists(hint_path), "cli -z --hints wrote no .zxh")
    out = os.path.join(d, "corpus.out")
    command("-d --device --hints -o",
            ["-d", "-k", "-f", "-q", "--device", "--hints", "-o", out,
             arc_path],
            {27: n_groups},
            ("decompress_e2e(hint=)", lambda: Z.decompress_e2e(
                arc, Z.DecodeOpts(checksum=True), hint=hint_path)))
    check(read(out) == data, "cli -d --device --hints: output differs from "
          "the corpus")
    command("-t --device", ["-t", "-q", "--device", arc_path], None,
            ("ops.decompress(checksum)", lambda: Z.ops.decompress(
                arc, Z.DecodeOpts(checksum=True))))
    row = json.loads(command("-l -j", ["-l", "-j", arc_path], nbytes=None))
    check(row["blocks"] == len(data) // BLOCK and row["decompressed"]
          == len(data) and row["block_size"] == BLOCK and row["checksums"],
          f"cli -l -j: {row}")
    samples = []
    for i in range(CLI_TRAIN_BYTES // CLI_SAMPLE):
        samples.append(os.path.join(d, f"sample{i:02d}.bin"))
        with open(samples[-1], "wb") as f:
            f.write(data[i * CLI_SAMPLE:(i + 1) * CLI_SAMPLE])
    zxd = os.path.join(d, "corpus.zxd")
    command("--train", ["--train", "-q", "-f", "-o", zxd, *samples], None,
            ("dict_train", lambda: Z.dict_train(
                [read(p) for p in samples], 16384)), CLI_TRAIN_BYTES)
    dict_arc = os.path.join(d, "dict.zxc")
    command("-z -D", ["-z", "-k", "-q", "-D", zxd, "-o", dict_arc, src])
    dict_out = os.path.join(d, "dict.out")
    dct = Z.Dictionary.load(read(zxd))
    command("-d --device -D", ["-d", "-k", "-f", "-q", "--device", "-D", zxd,
                               "-o", dict_out, dict_arc], None,
            ("ops.decompress(dictionary)", lambda: Z.ops.decompress(
                read(dict_arc), Z.DecodeOpts(
                    checksum=True, dict_content=dct.content,
                    dict_huf=dct.huf_lengths))))
    check(read(dict_out) == data, "cli -d --device -D: output differs from "
          "the corpus")
    bench = json.loads(command("-b 1 --device -j",
                               ["-b", "1", "--device", "-j", src],
                               nbytes=None))
    check(bench["size"] == len(data) and bench["decompress_mbps"] > 0,
          f"cli -b --device: {bench}")
    print(f"cli -b 1 --device -j: {bench}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "zxc_tpu_torch", "-d",
                        "--device", "--hints", "-c", arc_path],
                       capture_output=True, env=env, cwd=d, timeout=300)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"python3 -m zxc_tpu_torch -d --device --hints "
          f"-c: exit code {r.returncode}: {r.stderr.decode()[-2000:]}")
    check(r.stdout == data, "python3 -m zxc_tpu_torch -d --device --hints "
          "-c: stdout differs from the corpus")
    print(f"cli python3 -m zxc_tpu_torch -d --device --hints -c: wall "
          f"{wall:.4f} s with the interpreter's start, stdout equals the "
          "corpus", flush=True)
    shutil.rmtree(d, True)

SHARD_TAMPER = [[2, 0, "off", 60_000]]    # an offset past its window


def shard_spec(out_dir: str, arc: bytes, data: bytes) -> tuple[str, dict]:
    """The jobs of the two gloo ranks that share the card
    (``parallel.jobs.run_jobs``): the 64 KiB archive through
    ``decode_plan_sharded`` on (2,) and ``decode_plan_dp_sp`` on (1, 2),
    ``compress_sharded`` of 3 full blocks (2 sharded, 1 on the
    single-device path) with checksums, and a truncated archive and a
    tampered plan, which must raise alike on both ranks. Returns the
    spec's path and the plaintext each job must give."""
    files = {"arc": arc, "trunc": arc[:len(arc) // 2],
             "enc": data[:3 * BLOCK]}
    paths = {}
    for name, blob in files.items():
        paths[name] = os.path.join(out_dir, f"shard_{name}.bin")
        with open(paths[name], "wb") as f:
            f.write(blob)
    jobs = [dict(name="dp", op="decode_plan_sharded", archive=paths["arc"],
                 axes=["dp"], shape=[2]),
            dict(name="dp_sp", op="decode_plan_dp_sp", archive=paths["arc"],
                 axes=["dp", "sp"], shape=[1, 2]),
            dict(name="compress", op="compress_sharded", input=paths["enc"],
                 block_size=BLOCK, level=ENC_LEVEL, checksum=True,
                 axes=["dp"], shape=[2]),
            dict(name="truncated", op="decode_plan_sharded",
                 archive=paths["trunc"], axes=["dp"], shape=[2]),
            dict(name="tampered", op="decode_plan_sharded",
                 archive=paths["arc"], tamper=SHARD_TAMPER, axes=["dp"],
                 shape=[2])]
    spec = os.path.join(out_dir, "shard_spec.json")
    with open(spec, "w") as f:
        json.dump({"out": out_dir, "device": "cuda", "jobs": jobs}, f)
    return spec, {"dp": data, "dp_sp": data, "compress": files["enc"]}


def sharding_phase(Z, data: bytes, arc: bytes, arc512: bytes,
                   out_dir: str, smi: str) -> None:
    """Phase 6: the sharded decode and encode (``parallel``) on the card:
    in process over an NCCL group of one rank, then on two gloo ranks
    that share the card (``parallel.launch``), then
    ``entry.dryrun_multichip`` over NCCL."""
    import torch.distributed as dist
    from zxc_tpu_torch import entry, parallel
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:"
                                        f"{launch.free_port()}")
    mesh = parallel.make_mesh()
    mesh11 = parallel.make_mesh(axes=("dp", "sp"), shape=(1, 1))

    def timed(fn):
        zero_counts()
        ph = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(ph)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out, ph, read_counts()

    def sharded(a):
        def fn(ph):
            t0 = time.perf_counter()
            plan = Z.ops.plan_frame(a)
            ph["plan"] = time.perf_counter() - t0
            return parallel.decode_plan_sharded(plan, mesh, _phases=ph)
        return fn

    # decode_plan_sharded beside ops.decompress's default route and its
    # chase route (the same expansion), interleaved, best of 3
    for label, a in (("64 KiB", arc), ("512 KiB", arc512)):
        fns = {"decode_plan_sharded": sharded(a),
               "ops.decompress default": lambda ph, a=a: Z.ops.decompress(
                   a, device="cuda", _phases=ph),
               "ops.decompress chase": lambda ph, a=a: Z.ops.decompress(
                   a, device="cuda", use_pieces=False, _phases=ph)}
        best = {}
        for _ in range(3):
            for name, fn in fns.items():
                wall, out, ph, counts = timed(fn)
                check(out == data, f"{name} at {label} differs from the "
                      "corpus")
                check(not any(counts.values()),
                      f"{name} at {label} launched kernels: {counts}")
                if name not in best or wall < best[name][0]:
                    best[name] = (wall, ph)
        for name, (wall, ph) in best.items():
            print(f"shard world-1 nccl {label}: {name} best of 3 "
                  f"{wall:.4f} s ({len(data) / wall / 1e9:.3f} GB/s; "
                  f"{fmt_phases(ph)}); launches 0 [{smi}]", flush=True)

    plan = Z.ops.plan_frame(arc)
    wall, out, ph, counts = timed(
        lambda ph: parallel.decode_plan_dp_sp(plan, mesh11, _phases=ph))
    check(out == data, "decode_plan_dp_sp (1, 1) differs from the corpus")
    check(not any(counts.values()),
          f"decode_plan_dp_sp launched kernels: {counts}")
    print(f"shard world-1 nccl 64 KiB: decode_plan_dp_sp (1, 1) "
          f"{wall:.4f} s, plan excluded ({fmt_phases(ph)}); launches 0 "
          f"[{smi}]", flush=True)

    enc_data = data[:SHARD_ENC_BYTES - 99]
    wall, arc_s, ph, counts = timed(lambda ph: parallel.compress_sharded(
        enc_data, mesh, ENC_LEVEL, BLOCK, checksum=True, _phases=ph))
    check(frame.decompress(arc_s, Z.DecodeOpts(checksum=True)) == enc_data,
          "compress_sharded's archive does not decode to its data")
    fired = {k: v for k, v in counts.items() if v}
    check(fired == {"lcp": 1, "parse_walk": 1},
          f"compress_sharded launches {fired}, not lcp 1 and parse_walk 1")
    print(f"shard world-1 nccl: compress_sharded of {len(enc_data)} bytes "
          f"at level {ENC_LEVEL}, 64 KiB blocks, checksums: {wall:.4f} s "
          f"({len(enc_data) / wall / 1e6:.2f} MB/s; {fmt_phases(ph)}); "
          f"archive {len(arc_s)} bytes ({len(arc_s) / len(enc_data):.4f}); "
          f"launches {fired} [{smi}]", flush=True)

    bad = Z.ops.plan_frame(arc)
    for blk, seq, fld, value in SHARD_TAMPER:
        getattr(bad, fld)[blk][seq] = value
    for name, call in (
            ("truncated archive", lambda: parallel.decode_plan_sharded(
                Z.ops.plan_frame(arc[:len(arc) // 2]), mesh)),
            ("tampered plan", lambda: parallel.decode_plan_sharded(
                bad, mesh))):
        try:
            call()
        except Z.ZxcError as e:
            print(f"shard world-1 nccl, corrupt ({name}): raised {e}",
                  flush=True)
        else:
            fail(f"sharded decode of a {name} raised nothing")
    dist.destroy_process_group()

    # two gloo ranks share the card
    spec, want = shard_spec(out_dir, arc, data)
    t0 = time.perf_counter()
    launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", 2, args=(spec,),
                  device="cuda", backend="gloo", timeout=300)
    wall = time.perf_counter() - t0
    res = {}
    for name in ("dp", "dp_sp", "compress", "truncated", "tampered"):
        res[name] = []
        for r in range(2):
            with open(os.path.join(out_dir, f"{name}.r{r}.pkl"), "rb") as f:
                res[name].append(pickle.load(f))
    for name, plain in want.items():
        for r, got in enumerate(res[name]):
            check("ok" in got, f"gloo rank {r} {name}: {got.get('error')}")
            out = got["ok"]
            if name == "compress":
                out = frame.decompress(out, Z.DecodeOpts(checksum=True))
            check(out == plain, f"gloo rank {r} {name} differs")
        check(res[name][0]["ok"] == res[name][1]["ok"],
              f"gloo ranks return different {name} bytes")
        print(f"shard 2 gloo ranks on one card: {name} "
              + "; ".join(f"rank {r} {g['wall']:.4f} s "
                          f"({fmt_phases(g['phases'])}; launches "
                          f"{g['launches'] or 0})"
                          for r, g in enumerate(res[name]))
              + f" [{smi}]", flush=True)
    for name in ("truncated", "tampered"):
        errs = [g.get("error") for g in res[name]]
        check(errs[0] is not None and errs[0][0] == "ZxcError"
              and errs[0] == errs[1],
              f"gloo ranks on a {name} plan: {errs}")
        print(f"shard 2 gloo ranks, corrupt ({name}): both raised "
              f"{errs[0][2]}", flush=True)
    print(f"shard 2 gloo ranks: launch wall {wall:.2f} s with the ranks' "
          "start", flush=True)

    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    print(f"shard dryrun_multichip(1) over NCCL: "
          f"{time.perf_counter() - t0:.2f} s with the rank's start",
          flush=True)
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        entry.dryrun_multichip(2)
        print(f"shard dryrun_multichip(2) over NCCL across 2 cards: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    else:
        print("shard dryrun_multichip(2): not run, one card: NCCL across "
              "cards is not verified here", flush=True)
    print(f"shard phase: {time.perf_counter() - t_phase:.2f} s", flush=True)


def host_phase(Z, data: bytes, n_groups: int, device: str = "cuda") -> None:
    """Phase 7: the host codec surfaces. ``CStream`` and the
    multi-threaded file pipeline write the one-shot encoder's archive of
    the corpus; that archive decodes through ``decompress_e2e`` (v26 once a
    group, no other kernel), ``Dctx(device=True)``, ``DStream``, the file
    pipeline and ``decompress_inplace``; a dictionary trained on the first
    4 MiB drives ``Cctx(level=6)``, and ``Cctx(level=7)`` runs without
    one, each archive decoded on the host and by ``ops.decompress`` on the
    card. ``device="cpu"`` runs the same checks on the plain versions (no
    launches) for a dry run away from the card."""
    import io
    from zxc_tpu_torch.codec import stream
    t_phase = time.perf_counter()
    mb = len(data) / 1e6
    threads = os.cpu_count() or 1
    want_opts = Z.EncodeOpts(level=3, block_size=BLOCK, checksum=True,
                             threads=threads)
    want = Z.compress(data, want_opts)
    ck = Z.DecodeOpts(checksum=True)

    def timed(label, fn, nbytes=len(data)):
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        print(f"host {label}: wall {wall:.4f} s = "
              f"{nbytes / 1e6 / wall:.2f} MB/s", flush=True)
        return out

    # CStream at L3 / 64 KiB / checksums: pushes of 1 MiB + 7 bytes,
    # drained in 64 KiB windows
    def push():
        cs = Z.CStream(level=3, block_size=BLOCK, checksum=True)
        out = bytearray()
        step = (1 << 20) + 7
        for pos in range(0, len(data), step):
            produced, used = cs.compress(data[pos:pos + step], BLOCK)
            check(used == len(data[pos:pos + step]), "CStream short push")
            out += produced
            while True:
                produced, _ = cs.compress(b"", BLOCK)
                if not produced:
                    break
                out += produced
        while not cs.finished:
            out += cs.end(BLOCK)
        return bytes(out)

    arc = timed("CStream L3 64 KiB checksums, pushes of 1 MiB + 7", push)
    check(arc == want, "CStream's archive differs from compress's")

    def file_encode():
        buf = io.BytesIO()
        n = stream.stream_compress(io.BytesIO(data), buf, Z.EncodeOpts(
            level=3, block_size=BLOCK, checksum=True), threads)
        check(n == len(buf.getvalue()), "stream_compress's count")
        return buf.getvalue()

    arc_mt = timed(f"codec.stream.stream_compress, {threads} threads",
                   file_encode)
    check(arc_mt == want, "stream_compress's archive differs from compress's")
    print(f"host archives: CStream and stream_compress equal compress "
          f"({len(want)} bytes)", flush=True)

    # the archive through every decode route
    kern, n_launch = (26, n_groups) if device == "cuda" else (None, 0)
    run_path("host archive, decompress_e2e v26", kern, n_launch,
             lambda ph: Z.decompress_e2e(arc, ck, device=device,
                                         _phases=ph), data, reps=1)
    dctx = Z.Dctx(checksum=True, device=True if device == "cuda" else device)
    with Z.profiling.collect_phases() as col:
        check(timed("Dctx(device=True)", lambda: dctx.decompress(arc))
              == data, "Dctx(device=True) differs from the corpus")
    print("host Dctx(device=True) phases: " + ", ".join(
        f"{k} {v['seconds']:.4f}" for k, v in col.as_dict().items()),
        flush=True)

    def pull():
        ds = Z.DStream(checksum=True)
        out = bytearray()
        step = (1 << 20) + 7
        for pos in range(0, len(arc), step):
            produced, _ = ds.decompress(arc[pos:pos + step], BLOCK)
            out += produced
            while True:
                produced, _ = ds.decompress(b"", BLOCK)
                if not produced:
                    break
                out += produced
        check(ds.finished, "DStream did not finish")
        return bytes(out)

    check(timed("DStream, pushes of 1 MiB + 7, 64 KiB windows", pull)
          == data, "DStream differs from the corpus")

    def file_decode():
        out = io.BytesIO()
        n = stream.stream_decompress(io.BytesIO(arc), out, ck, threads)
        check(n == len(data), "stream_decompress's count")
        return out.getvalue()

    check(timed(f"codec.stream.stream_decompress, {threads} threads",
                file_decode) == data,
          "stream_decompress differs from the corpus")
    bound = Z.decompress_inplace_bound(arc)
    buf = bytearray(bound)
    buf[bound - len(arc):] = arc
    n = timed(f"decompress_inplace, one buffer of {bound} bytes",
              lambda: Z.decompress_inplace(buf, len(arc), ck))
    check(n == len(data) and len(buf) == bound
          and bytes(buf[:n]) == data, "decompress_inplace differs")

    # the trainer and the contexts on the first 4 MiB
    head = data[:HEAD_BYTES]
    samples = [head[i * (HEAD_BYTES // 64):i * (HEAD_BYTES // 64) + (16 << 10)]
               for i in range(64)]
    content = timed("train_dict, 64 samples of 16 KiB",
                    lambda: Z.train_dict(samples), 64 << 14)
    table = timed("train_dict_huf", lambda: Z.train_dict_huf(samples,
                                                              content),
                  64 << 14)
    check(0 < len(content) <= 16384 and len(table) == 128,
          f"trained {len(content)} bytes of content, {len(table)} of table")
    print(f"host dictionary: {len(content)} bytes of content, id "
          f"{Z.Dictionary(content, table).id:#010x}", flush=True)
    for label, cctx, opts in (
            ("Cctx(level=6) with the dictionary",
             Z.Cctx(level=6).attach_dict(content, table),
             Z.DecodeOpts(dict_content=content, dict_huf=table)),
            ("Cctx(level=7)", Z.Cctx(level=7), Z.DecodeOpts())):
        a = timed(f"{label}, first 4 MiB", lambda: cctx.compress(head),
                  len(head))
        blk = cctx.compress_block(head[:BLOCK])
        dx = Z.Dctx()
        if opts.dict_content:
            dx.attach_dict(content, table)
        check(dx.decompress_block(blk, BLOCK) == head[:BLOCK],
              f"{label}: compress_block does not decode")
        check(timed(f"{label}: frame.decompress",
                    lambda: Z.decompress(a, opts), len(head)) == head,
              f"{label}: the host decode differs")
        zero_counts()
        got = timed(f"{label}: ops.decompress on {device}",
                    lambda: Z.ops.decompress(a, opts, device=device),
                    len(head))
        counts = read_counts()
        check(got == head, f"{label}: ops.decompress differs")
        check(not any(counts.values()), f"{label}: launches {counts}")
        print(f"host {label}: {len(a)} bytes ({len(a) / len(head):.4f}), "
              f"decoded on the host and by ops.decompress, launches "
              f"{sum(counts.values())}", flush=True)
    print(f"host phase: {time.perf_counter() - t_phase:.2f} s "
          f"({mb:.1f} MB corpus)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import zxc_tpu_torch as Z
    from zxc_tpu_torch import runtime
    from zxc_tpu_torch.ops import _build, copy_engine as CE
    from zxc_tpu_torch.ops import encode as ENC, encode_kernels as EK
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.ops import device_pipeline as DP
    from zxc_tpu_torch.ops import batch as BT, hints as H, serial as S
    from zxc_tpu_torch.ops import attic as AT, attic_quad as AQ
    from zxc_tpu_torch.ops import probes as P, pivco_device as PV
    from zxc_tpu_torch.codec.seekable import Seekable
    from gen_corpus import gen_corpus

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {kind})", flush=True)

    # -- 1. builds, in parallel ------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as ex:
        for f in [ex.submit(fn) for fn in (runtime.lib, _build.kernels,
                                           _build.encode_kernels,
                                           _build.attic_kernels,
                                           _build.gather_kernels)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (libzxchost, "
          f"copy_engine.cu, encode.cu, attic.cu and gather.cu in parallel)",
          flush=True)
    for ln in "".join(_build.build_logs.values()).splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas: {ln.strip()}")

    # -- 2. corpus, archives, hint -----------------------------------------
    t0 = time.perf_counter()
    data = gen_corpus(CORPUS_BYTES)
    with open(os.path.join(ROOT, "tools", "corpus_manifest.json")) as f:
        pinned = json.load(f)["mb32_seed42"]
    check(hashlib.sha256(data).hexdigest() == pinned,
          "corpus sha256 differs from tools/corpus_manifest.json")
    threads = os.cpu_count() or 1
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=BLOCK,
                                        threads=threads))
    arc4 = Z.compress(data, Z.EncodeOpts(level=3, block_size=SMALL_BLOCK,
                                         threads=threads))
    arc512 = Z.compress(data, Z.EncodeOpts(level=3, block_size=DEFAULT_BLOCK,
                                           threads=threads))
    arc_sek = Z.compress(data, Z.EncodeOpts(level=3, block_size=BLOCK,
                                            seekable=True, threads=threads))
    head = data[:HEAD_BYTES]
    arc7 = Z.compress(head, Z.EncodeOpts(level=7, block_size=BLOCK,
                                         threads=threads))
    walk = DP.walk_frame(arc)
    n_groups = -(-walk.n_blocks // DISPATCH)
    n_groups4 = -(-DP.walk_frame(arc4).n_blocks // DISPATCH)
    n_blocks512 = DP.walk_frame(arc512).n_blocks
    print(f"corpus: {len(data)} bytes -> archive {len(arc)} bytes "
          f"({len(arc) / len(data):.4f}), {walk.n_blocks} blocks, "
          f"{n_groups} groups; 4 KiB archive {len(arc4)} bytes, "
          f"{n_groups4} groups; 512 KiB archive {len(arc512)} bytes "
          f"({len(arc512) / len(data):.4f}), {n_blocks512} blocks; seekable "
          f"64 KiB archive {len(arc_sek)} bytes; first 4 MiB at level 7 "
          f"{len(arc7)} bytes ({len(arc7) / len(head):.4f}) "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    # hint files go to a scratch directory under the checkout's build/
    # (gitignored), removed at exit
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(ROOT,
                                                                 "build"))
    atexit.register(shutil.rmtree, out_dir, True)
    hint_path = os.path.join(out_dir, "smoke.zxh")
    t0 = time.perf_counter()
    Z.write_hints(arc, hint_path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    hint = Z.HintFile(hint_path, arc)
    t_load = time.perf_counter() - t0
    g = hint.geo
    print(f"hint: write_hints {t_write:.4f} s, {os.path.getsize(hint_path)} "
          f"bytes on disk; load {t_load:.4f} s; v{g.variant} geometry K="
          f"{g.K} MAXQ={g.MAXQ} NG32={g.NG32} RLP={g.RLP}", flush=True)

    # -- 3. kernel vs plain on the first dispatch group --------------------
    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    walk512 = DP.walk_frame(arc512)
    for key, name, variant, w, a, block in (
            (19, "v19", 19, walk, arc, BLOCK),
            (26, "v26", 26, walk, arc, BLOCK),
            ("v26_512k", "v26_512k", 26, walk512, arc512, DEFAULT_BLOCK)):
        pipe = DP.DevicePipeline(w, a, K=2, dispatch=DISPATCH,
                                 variant=variant)
        pipe.size_shapes()
        buf, host_args = pipe.prep_group(0)
        args = tuple(t.cuda() for t in host_args)
        kern, ref = CE.KERNELS[variant], CE.REFERENCES[variant]
        shape = (f"B={DISPATCH} NST={pipe.NST} MAXQ={pipe.MAXQ} "
                 f"RLP={pipe.RLP} NG32={pipe.NG32}")
        if variant == 26:
            shape += (", quads reading own output by supertile "
                      + out_quads(*host_args[:2], pipe.RLP))
        else:
            plan19 = CE.tile_plan(DISPATCH, pipe.NST, CE.TILE_ROWS, sms)
            shape += f", clusters of {plan19.C}"
        rows[key] = kernel_row(
            name, SOURCE, REPLACES[variant], lambda: kern(*args),
            lambda: ref(*args),
            CE.bytes_moved(*host_args, K=2), shape,
            first_group=group_bytes_equal(data, buf.totals, block, DISPATCH))
        del args
    pipe = DP.DevicePipeline(walk, arc, dispatch=DISPATCH, variant=None,
                             hint=hint)
    check(pipe.variant == 27, f"the hint selected v{pipe.variant}, not v27")
    buf, host_args = pipe.prep_group(0)
    args = tuple(t.cuda() for t in host_args)
    rows[27] = kernel_row(
        "v27", SOURCE, REPLACES[27],
        lambda: CE.v27(*args, RLP=pipe.RLP, K=pipe.K),
        lambda: CE.v27_reference(*args, RLP=pipe.RLP, K=pipe.K),
        CE.bytes_moved(*host_args[:2], *host_args[3:], K=pipe.K,
                       loff=host_args[2], RLP=pipe.RLP),
        f"RLP={pipe.RLP} ROWS_TOT={pipe.rows_tot} (flat)",
        first_group=group_bytes_equal(data, buf.totals, BLOCK, DISPATCH))
    def first_group_plan(a, self_ref=False):
        """The first DISPATCH blocks of archive ``a``, resolved as the
        serial route (or, ``self_ref``, v25) resolves them: (totals,
        pieces, lits)."""
        plan = BT.plan_frame(a)
        first = slice(0, DISPATCH)
        sub = BT.FramePlan(plan.block_size, ll=plan.ll[first],
                           ml=plan.ml[first], off=plan.off[first],
                           lit=plan.lit[first], totals=plan.totals[first],
                           dict_buf=plan.dict_buf)
        return (sub.totals,) + BT.resolve_serial(sub, self_ref=self_ref)

    totals4, pieces, lits = first_group_plan(arc4)
    (group,) = S.pack_groups(pieces, lits, totals4, SMALL_BLOCK, True,
                             DISPATCH)
    args = CE.group_from_numpy(*group, device="cuda")
    plan13 = CE.tile_plan(DISPATCH, group[0].shape[1] - 1, CE.V13_ROWS, sms)
    print(f"tile plan: v13 (B={DISPATCH}, NT={plan13.NT}, 32-row tiles) "
          f"C={plan13.C}; v19 (B={DISPATCH}, NST={plan19.NT}) C={plan19.C};"
          f" {sms} SMs", flush=True)
    rows[13] = kernel_row(
        "v13", SOURCE, REPLACES[13], lambda: CE.v13(*args),
        lambda: CE.v13_reference(*args),
        CE.bytes_moved(*group, K=1, rows=CE.V13_ROWS),
        f"MAXQ={group[1].shape[1]} RLP={group[4].shape[1]}, clusters of "
        f"{plan13.C}",
        first_group=group_bytes_equal(data, totals4, SMALL_BLOCK, DISPATCH))
    totals64, pieces, lits = first_group_plan(arc)
    (group,) = AT.pack_groups(pieces, lits, totals64, BLOCK, DISPATCH)
    args = [torch.from_numpy(a).cuda() for a in group]
    rows["attic"] = kernel_row(
        "attic", ATTIC_SOURCE, ATTIC_REPLACES,
        lambda: AT.piece_serial(*args, block=BLOCK, fill_from_s=True),
        lambda: AT.piece_serial_reference(*args, block=BLOCK,
                                          fill_from_s=True),
        AT.bytes_moved(pieces, lits, BLOCK),
        f"variant 2, B={DISPATCH} pieces={sum(len(p[0]) for p in pieces)} "
        f"PR={group[2].shape[1]} RL={group[3].shape[1]}",
        first_group=group_bytes_equal(data, totals64, BLOCK, DISPATCH))
    del args
    for v, r in attic_rows(AT, pieces, lits, totals64, data).items():
        rows[f"v{v}"] = r
    attic_worst_cases(AT, pieces, lits, totals64)
    for v, r in quad_rows(CE, AQ, pieces, lits, totals64, data).items():
        rows[f"v{v}"] = r
    rows.update(probe_rows(CE, AT, P, S, pieces, lits, totals64, data))
    _, pieces_sr, lits_sr = first_group_plan(arc, self_ref=True)
    host = S.pack_blocks_v25(pieces_sr, lits_sr, totals64, BLOCK)
    args = CE.group_from_numpy(*host, device="cuda")
    rows[25] = kernel_row(
        "v25", SOURCE, V25_REPLACES, lambda: CE.v25(*args),
        lambda: CE.v25_reference(*args),
        CE.bytes_moved(*host),
        "self_ref_grid_kernel (one CTA per (supertile, block), ready "
        f"flags), {int(host[0][:, -1].sum())} quads "
        f"({int((host[1] >= CE.OUT_QB_FLAG).sum())} OUT), MAXQ="
        f"{host[1].shape[1]} RLP={host[4].shape[1]}",
        first_group=group_bytes_equal(data, totals64, BLOCK, DISPATCH))
    del args
    rows.update(gather_rows_of(P))

    params = frame.level_params(ENC_LEVEL)
    grp = torch.from_numpy(np.frombuffer(data, np.uint8, DISPATCH * BLOCK)
                           .reshape(DISPATCH, BLOCK).copy()).cuda()
    pc = ENC.lcp_inputs(grp, params.n_candidates)[0]
    split = EK.lcp_plan(DISPATCH, pc.shape[1], torch.cuda
                        .get_device_properties(0).multi_processor_count)
    enc_rows = {"lcp": kernel_row(
        "lcp", ENC_SOURCE, ENC_REPLACES["lcp"], lambda: EK.lcp(grp, pc),
        lambda: EK.lcp_reference(grp, pc),
        EK.lcp_bytes_moved(DISPATCH, BLOCK, pc.shape[1]),
        f"B={DISPATCH} n={BLOCK} K={params.n_candidates} "
        f"pairs={pc.numel()} split={split}")}
    first, at_cap = EK.lcp_shares(EK.lcp_reference(grp, pc))
    enc_rows["lcp"]["shares"] = {"first_round": first, "cap": at_cap}
    print(f"lcp first group: {first:.6f} of the pairs end in the first "
          f"{EK.LCP_FIRST} bytes (the rest go through the warps' queues), "
          f"{at_cap:.6f} reach {EK.CAP}", flush=True)
    lens = ENC.find_matches_device_lcp_batch(grp, params.n_candidates)[0]
    walk_steps = {"corpus": ENC.walk_steps(lens, params.lazy,
                                           params.min_emit),
                  "all5": torch.full((DISPATCH, BLOCK), 5, dtype=torch.int32,
                                     device="cuda")}

    def walk_row(mode):
        step = walk_steps[mode]
        chain = EK.walk_chain(step)
        rounds = EK.walk_rounds(step).cpu().numpy()
        print(f"parse_walk {mode}: rounds to converge by block "
              f"{rounds[:, 0].tolist()}, serial finish from chunk "
              f"{rounds[:, 1].tolist()} (-1: none); {EK.walk_plan(BLOCK)}",
              flush=True)
        row = kernel_row(
            "parse_walk", ENC_SOURCE, ENC_REPLACES["parse_walk"],
            lambda: EK.parse_walk(step),
            lambda: EK.parse_walk_reference(step),
            EK.walk_bytes_moved(step),
            f"{mode}: B={DISPATCH} P={BLOCK} chain max {chain.max()} mean "
            f"{chain.mean():.0f} steps", diff=walk_err)
        print(f"parse_walk {mode}: {row['b2b_ms'] * 1e6 / chain.max():.2f} ns"
              " back to back per step of the longest chain", flush=True)
        return row

    enc_rows["parse_walk"] = modes_row(
        "parse_walk", ENC_SOURCE, ENC_REPLACES["parse_walk"],
        ("corpus", "all5"), walk_row)
    del grp, pc, lens, walk_steps

    # -- 4. the main paths -------------------------------------------------
    fp_host = host_fingerprint(data, BLOCK)
    cold = {26: None, 19: None}
    for variant in cold:
        rows[variant]["launches"] = run_path(
            f"e2e v{variant} (cold)", variant, n_groups,
            lambda ph: Z.decompress_e2e(arc, device="cuda", variant=variant,
                                        _phases=ph), data)
        fp = Z.decompress_e2e(arc, device="cuda", variant=variant,
                              _collect="fingerprint")
        check(fp[:2] == fp_host and fp[2:] == (walk.n_blocks, len(data)),
              f"e2e v{variant} fingerprint {fp} vs host {fp_host}")
    # v26 over 512 KiB blocks: 32 supertiles a block, 4 groups
    rows["v26_512k"]["launches"] = run_path(
        "e2e v26 (cold), 512 KiB blocks", 26, -(-n_blocks512 // DISPATCH),
        lambda ph: Z.decompress_e2e(arc512, device="cuda", variant=26,
                                    _phases=ph), data)
    fp = Z.decompress_e2e(arc512, device="cuda", variant=26,
                          _collect="fingerprint")
    check(fp[:2] == host_fingerprint(data, DEFAULT_BLOCK)
          and fp[2:] == (n_blocks512, len(data)),
          f"e2e v26 512 KiB fingerprint {fp}")
    # the hint path: the first run ships the control pages to the card
    # (the HintFile keeps them), the timed repeats ship lit only
    rows[27]["launches"] = run_path(
        "e2e hint v27", 27, n_groups,
        lambda ph: Z.decompress_e2e(arc, device="cuda", hint=hint,
                                    _phases=ph), data)
    fp = Z.decompress_e2e(arc, device="cuda", hint=hint,
                          _collect="fingerprint")
    check(fp[:2] == fp_host and fp[2:] == (walk.n_blocks, len(data)),
          f"hint v27 fingerprint {fp} vs host {fp_host}")
    print(f"e2e hint v27 fingerprint {fp[:2]} equal", flush=True)
    run_path("e2e hint v26", 26, n_groups,
             lambda ph: Z.decompress_e2e(arc, device="cuda", hint=hint,
                                         variant=26, _phases=ph), data)
    # the default ops.decompress route: piece plans expanded by tensor
    # ops (and the chase route's pointer doubling), no hand-written kernel
    def default_route(a, route, **kw):
        def fn(ph):
            out = Z.ops.decompress(a, device="cuda", _phases=ph, **kw)
            check(ph["route"] == route, f"route {ph['route']}, not {route}")
            return out
        return fn

    run_path("default route, 512 KiB blocks", None, 0,
             default_route(arc512, "pieces"), data)
    run_path("default route, 64 KiB blocks", None, 0,
             default_route(arc, "pieces"), data)
    run_path("chase route, 512 KiB blocks", None, 0,
             default_route(arc512, "chase", use_pieces=False), data)
    # the device entropy decode: the PivCo literal sections routed on the
    # card from their wire bytes (tensor ops), then the chase route
    def entropy_route(a):
        def fn(ph):
            out = Z.ops.decompress(a, device="cuda", device_entropy=True,
                                   _phases=ph)
            check(ph["route"] == "chase" and ph["entropy_sections"] > 0,
                  f"device entropy route: route {ph['route']}, "
                  f"{ph.get('entropy_sections')} sections")
            return out
        return fn

    for name, a, want in (("64 KiB blocks", arc, data),
                          ("512 KiB blocks", arc512, data),
                          ("level 7, first 4 MiB", arc7, head)):
        run_path(f"device entropy route, {name}", None, 0,
                 entropy_route(a), want)
        hb = h2d_bytes(BT, PV, a, BT.DEFAULT_BATCH)
        print(f"device entropy route, {name}: H2D {hb['deferred']} bytes "
              f"({hb['zero_rows']} of them zero literal rows) against "
              f"{hb['host']} for the chase route on host literals "
              f"({hb['deferred'] / hb['host']:.4f})", flush=True)
    with Z.profiling.collect_phases() as col:
        t0 = time.perf_counter()
        check(Z.Dctx(device=True).decompress(arc512) == data,
              "Dctx(device=True) differs from the corpus")
        t_ctx = time.perf_counter() - t0
    print(f"Dctx(device=True), 512 KiB blocks: {t_ctx:.4f} s, equal; "
          f"collected phases {col.as_dict()}", flush=True)
    check(set(col.as_dict()) == {"plan", "resolve", "device"},
          f"collect_phases recorded {col.as_dict()}")
    sek = Seekable.open_bytes(arc_sek)
    lo, n = 3 * BLOCK + 12345, 10 * BLOCK + 777
    run_path("decompress_range_device, 11 blocks of 64 KiB", None, 0,
             lambda ph: sek.decompress_range_device(lo, n),
             data[lo:lo + n])
    run_path("serial v19 (64 KiB blocks)", 19, n_groups,
             lambda ph: Z.ops.decompress(arc, device="cuda", use_serial=True,
                                         _phases=ph), data)
    rows[13]["launches"] = run_path(
        "serial v13 (4 KiB blocks)", 13, n_groups4,
        lambda ph: Z.ops.decompress(arc4, device="cuda", use_serial=True,
                                    _phases=ph), data)
    rows["attic"]["launches"] = run_path(
        "serial attic variant 2 (64 KiB blocks)", "attic", n_groups,
        lambda ph: Z.ops.decompress(arc, device="cuda", use_serial=True,
                                    variant=2, _phases=ph), data)
    arc_head = Z.compress(head, Z.EncodeOpts(level=3, block_size=BLOCK,
                                             threads=threads))
    for variant in (1, 3):
        run_path(f"serial attic variant {variant} (first 4 MiB)", "attic",
                 -(-(len(head) // BLOCK) // DISPATCH),
                 lambda ph: Z.ops.decompress(arc_head, device="cuda",
                                             use_serial=True,
                                             variant=variant, _phases=ph),
                 head, reps=1)
    # the attic's window-op and lane-op entries on one plan and one
    # resolve of the 64 KiB archive, shared by the paths: their walls
    # are pack and device; the shared section parse and resolve stand
    # beside them as phases
    t0 = time.perf_counter()
    plan64 = BT.plan_frame(arc)
    t_plan = time.perf_counter() - t0
    pieces64, lits64 = BT.resolve_serial(plan64)
    shared = {"plan (shared)": t_plan,
              "resolve (shared)": time.perf_counter() - t0 - t_plan}
    T64 = list(plan64.totals)

    def attic_path(fn, n_blocks, **kw):
        def run(ph):
            ph.update(shared)
            return b"".join(fn(pieces64[:n_blocks], lits64[:n_blocks],
                               T64[:n_blocks], BLOCK, device="cuda",
                               dispatch=DISPATCH, _phases=ph, **kw))
        return run

    entries = {4: (AT.decode_blocks_v4, dict(variant=4)),
               9: (AT.decode_blocks_v9, {}), 10: (AT.decode_blocks_v10, {}),
               11: (AT.decode_blocks_v11, {})}
    for v, (fn, kw) in entries.items():
        kern = "window_merge" if v < 8 else "lane_sum"
        rows[f"v{v}"]["launches"] = run_path(
            f"attic v{v} {kern} (64 KiB blocks)", kern, n_groups,
            attic_path(fn, len(T64), **kw), data)
    check(sum(T64[:HEAD_BLOCKS]) == len(head), "the first 64 blocks are "
          "not the first 4 MiB")
    for v in (5, 6, 7):
        rows[f"v{v}"]["launches"] = run_path(
            f"attic v{v} window_merge (first 4 MiB)", "window_merge",
            HEAD_BLOCKS // DISPATCH,
            attic_path(AT.decode_blocks_v4, HEAD_BLOCKS, variant=v), head,
            reps=1)
    # the quad-tile entries; v22 runs the v20 kernel on its own packing
    for v in (15, 21):
        rows[f"v{v}"]["launches"] = run_path(
            f"attic_quad v{v} quad (64 KiB blocks)", "quad", n_groups,
            attic_path(AQ.ENTRIES[v], len(T64)), data)
    for v in (12, 14, 16, 17, 20, 22, 23, 24):
        n = run_path(f"attic_quad v{v} quad (first 4 MiB)", "quad",
                     HEAD_BLOCKS // DISPATCH,
                     attic_path(AQ.ENTRIES[v], HEAD_BLOCKS), head, reps=1)
        if v != 22:
            rows[f"v{v}"]["launches"] = n
    # v25 on the shared section parse and its own resolve (self_ref)
    t0 = time.perf_counter()
    pieces_sr, lits_sr = BT.resolve_serial(plan64, self_ref=True)
    shared_sr = {"plan (shared)": t_plan,
                 "resolve self_ref": time.perf_counter() - t0}

    def v25_path(ph):
        ph.update(shared_sr)
        return b"".join(S.decode_blocks_v25(pieces_sr, lits_sr, T64, BLOCK,
                                            dispatch=DISPATCH, _phases=ph))

    rows[25]["launches"] = run_path("serial v25 (64 KiB blocks)", 25,
                                    n_groups, v25_path, data)
    # the probes over the first 4 MiB, packed as each probe packs them
    heads = [slice(g, g + DISPATCH) for g in range(0, HEAD_BLOCKS, DISPATCH)]
    T_head = T64[:HEAD_BLOCKS]
    for name, qa, modes in (("v13_bisect", 2, P.V13_BISECT_MODES),
                            ("v12_ablate2", 1, P.V12_ABLATE2_MODES)):
        groups = [CE.group_from_numpy(*S.pack_blocks_v12(
            pieces64[sl], lits64[sl], T64[sl], BLOCK, quad_align=qa),
            device="cuda") for sl in heads]
        if name == "v13_bisect":
            call = lambda g, m: P.v13_bisect(*g, *m)
            ref = lambda g, m: P.v13_bisect_reference(*g, *m)
            decodes = lambda m: True
        else:
            call = lambda g, m: P.v12_ablate2(*g, m)
            ref = lambda g, m: P.v12_ablate2_reference(*g, m)
            decodes = lambda m: m == "full"
        rows[name]["launches"] = run_probe(name, groups, modes, call, ref,
                                           decodes, head, T_head)
    lane_groups = [[torch.from_numpy(a).cuda() for a in AT.pack_blocks_v10(
        pieces64[sl], lits64[sl], T64[sl], BLOCK)[1:]] for sl in heads]
    for name, modes in (("v10_probe", P.V10_PROBE_MODES),
                        ("v12_ablate", P.V12_ABLATE_MODES)):
        rows[name]["launches"] = run_probe(
            name, lane_groups, modes,
            lambda g, m, name=name: P.KERNELS[name](*g, m),
            lambda g, m, name=name: P.lane_probe_reference(name, *g, m),
            lambda m: m == "full", head, T_head)
    # the gathers at tpu_pallas_gather_probe.main()'s and
    # tpu_indirect_dma_probe.main()'s shapes
    zero_counts()
    t0 = time.perf_counter()
    runs = [gather_inputs(2 + k, M, N, N)
            for k, (M, N) in enumerate(GATHER_SHAPES)]
    runs.append(gather_inputs(9, 8, 1 << 16, 1 << 16, np.uint8))
    for x, idx in runs:
        check(torch.equal(P.gather_axis1(x, idx),
                          P.gather_axis1_reference(x, idx)),
              f"gather_axis1 {tuple(x.shape)} {x.dtype} differs from its "
              "plain version")
    M, N, NI, T = GRID_SHAPE
    x, idx = gather_inputs(1, M, N, NI)
    check(torch.equal(P.gather_grid(x, idx, T),
                      P.gather_axis1_reference(x, idx)),
          "gather_grid differs from its plain version")
    table, idx = dma_inputs()
    for fn in (P.dma_a, P.dma_b, P.dma_c):
        check(torch.equal(fn(table, idx), P.gather_rows_reference(
            table, idx)), f"{fn.__name__} differs from its plain version")
    counts = read_counts()
    want = {k: 0 for k in counts}
    want.update(gather_axis1=len(runs), gather_grid=1, dma_a=1, dma_b=1,
                dma_c=1)
    check(counts == want, f"gathers: launches {counts}, expected {want}")
    for name in ("gather_axis1", "gather_grid", "dma_a", "dma_b", "dma_c"):
        rows[name]["launches"] = counts[name]
    print(f"gathers at the probes' shapes: launches "
          f"{ {k: v for k, v in counts.items() if v} }, "
          f"{time.perf_counter() - t0:.4f} s with the checks; each equals "
          "its plain version", flush=True)
    del runs, x, idx, table, lane_groups, groups
    counts, arc_d = run_compress(
        EK, n_groups,
        lambda ph: Z.ops.compress_device(data, level=ENC_LEVEL,
                                         block_size=BLOCK, _phases=ph),
        data, len(arc))
    for name in EK.KERNELS:
        enc_rows[name]["launches"] = counts[name]
    check(frame.decompress(arc_d) == data,
          "compress_device archive: the native decoder differs")
    check(Z.decompress_e2e(arc_d, device="cuda") == data,
          "compress_device archive: decompress_e2e differs")
    mb = data[:1 << 20]
    check(Z.ops.compress_device(mb, level=ENC_LEVEL, block_size=BLOCK)
          == Z.ops.compress_device(mb, level=ENC_LEVEL, block_size=BLOCK,
                                   device="cpu"),
          "compress_device: the first 1 MiB differs from the CPU route")
    t0 = time.perf_counter()
    arc_x = Z.ops.compress_device(mb, level=ENC_LEVEL, block_size=XLA_BLOCK)
    t_x = time.perf_counter() - t0
    check(frame.decompress(arc_x) == mb,
          "compress_device at 128 KiB blocks (XLA matcher) differs")
    print(f"compress_device: decodes (native and decompress_e2e); first "
          f"1 MiB equals the CPU route; 1 MiB at 128 KiB blocks (XLA "
          f"matcher) {len(arc_x)} bytes in {t_x:.4f} s, decodes",
          flush=True)
    profile_share("e2e v26 (cold)", lambda: Z.decompress_e2e(
        arc, device="cuda", variant=26))
    profile_share("e2e hint v27", lambda: Z.decompress_e2e(
        arc, device="cuda", hint=hint))
    profile_share("default route, 512 KiB blocks", lambda: Z.ops.decompress(
        arc512, device="cuda"))
    # the chase route's gathers: 5 fixed ones, one scatter, one a round
    profile_share("chase route, 512 KiB blocks", lambda: Z.ops.decompress(
        arc512, device="cuda", use_pieces=False))
    check(profile_share("device entropy route, 512 KiB blocks",
                        lambda: Z.ops.decompress(arc512, device="cuda",
                                                 device_entropy=True))
          is not None, "the device entropy route showed no device time")
    profile_share("compress_device", lambda: Z.ops.compress_device(
        data, level=ENC_LEVEL, block_size=BLOCK))
    # after the busy-share profiles: a profiler run before them can
    # make them lose events
    with Z.profiling.trace(out_dir) as trace_path:
        Z.ops.decompress(arc512, device="cuda", device_entropy=True)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  for ev in events)
    check(on_card > 0, f"profiling.trace recorded no CUDA event "
          f"({len(events)} events)")
    print(f"profiling.trace, device entropy route at 512 KiB: "
          f"{len(events)} events, {on_card} on the card "
          f"({os.path.getsize(trace_path)} bytes)", flush=True)

    # -- 5. the command line ------------------------------------------------
    cli_phase(Z, EK, data, out_dir, n_groups)

    # -- 6. the sharded decode and encode ---------------------------------
    sharding_phase(Z, data, arc, arc512, out_dir, smi)

    # -- 7. the host codec surfaces ---------------------------------------
    host_phase(Z, data, n_groups)

    # -- 8. corruption -------------------------------------------------------
    small = Z.compress(data[:4 * BLOCK], Z.EncodeOpts(
        level=3, block_size=BLOCK, checksum=True))
    bad = bytearray(small)
    bad[60] ^= 0x20
    small_hint = os.path.join(out_dir, "small.zxh")
    Z.write_hints(small, small_hint)
    truncated = os.path.join(out_dir, "truncated.zxh")
    with open(small_hint, "rb") as fi, open(truncated, "wb") as fo:
        fo.write(fi.read()[:os.path.getsize(small_hint) // 2])
    flipped = os.path.join(out_dir, "flipped.zxh")
    flipped_qbase_hint(H, small_hint, flipped)
    ck = Z.DecodeOpts(checksum=True)

    def stream_decode(a, opts):
        import io
        from zxc_tpu_torch.codec import stream
        stream.stream_decompress(io.BytesIO(a), io.BytesIO(), opts,
                                 os.cpu_count() or 1)

    def inplace(a, opts):
        buf = bytearray(Z.decompress_inplace_bound(small))
        buf[len(buf) - len(a):] = a
        Z.decompress_inplace(buf, len(a), opts)

    for name, call in (
            ("flipped payload byte", lambda: Z.decompress_e2e(
                bytes(bad), ck, device="cuda")),
            ("truncated archive", lambda: Z.decompress_e2e(
                small[:len(small) // 2], device="cuda")),
            ("flipped payload byte, default route", lambda: Z.ops.decompress(
                bytes(bad), ck, device="cuda")),
            ("truncated archive, default route", lambda: Z.ops.decompress(
                small[:len(small) // 2], device="cuda")),
            ("flipped payload byte, serial", lambda: Z.ops.decompress(
                bytes(bad), ck, device="cuda", use_serial=True)),
            ("truncated archive, serial", lambda: Z.ops.decompress(
                small[:len(small) // 2], device="cuda", use_serial=True)),
            ("flipped payload byte, device entropy",
             lambda: Z.ops.decompress(bytes(bad), ck, device="cuda",
                                      device_entropy=True)),
            ("truncated archive, device entropy", lambda: Z.ops.decompress(
                small[:len(small) // 2], device="cuda",
                device_entropy=True)),
            ("hint of another archive", lambda: Z.decompress_e2e(
                arc, device="cuda", hint=small_hint)),
            ("truncated hint", lambda: Z.decompress_e2e(
                small, device="cuda", hint=truncated)),
            ("hint with qbase (1<<24)|64", lambda: Z.decompress_e2e(
                small, device="cuda", hint=flipped)),
            ("flipped payload byte, DStream", lambda: Z.stream_decompress(
                bytes(bad), True)),
            ("truncated archive, DStream", lambda: Z.stream_decompress(
                small[:len(small) // 2])),
            ("flipped payload byte, stream_decompress",
             lambda: stream_decode(bytes(bad), ck)),
            ("truncated archive, stream_decompress",
             lambda: stream_decode(small[:len(small) // 2], None)),
            ("flipped payload byte, decompress_inplace",
             lambda: inplace(bytes(bad), ck)),
            ("truncated archive, decompress_inplace",
             lambda: inplace(small[:len(small) // 2], None))):
        try:
            call()
        except Z.ZxcError as e:
            print(f"corrupt ({name}): raised {e}", flush=True)
        else:
            fail(f"{name} decoded without an error")
    check(Z.decompress_e2e(small, device="cuda", hint=small_hint)
          == data[:4 * BLOCK], "the unflipped small hint does not decode")

    kernels = ([rows[v] for v in (19, 26, "v26_512k", 27, 13)]
               + [enc_rows[k] for k in ("lcp", "parse_walk")]
               + [rows[k] for k in ("attic", "v4", "v5", "v6", "v7", "v9",
                                    "v10", "v11")]
               + [rows[f"v{v}"] for v in QUAD_REPLACES]
               + [rows[25]] + [rows[k] for k in PROBES])
    check(len(kernels) == 34 and all(r["launches"] for r in kernels),
          f"kernel rows without launches: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
