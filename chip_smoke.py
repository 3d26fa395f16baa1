#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zxc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (nvidia-smi); build the native host
   runtime (g++) and the copy-engine kernels (nvcc, sm_90a) in parallel;
2. the pinned 32 MiB corpus (tools/gen_corpus.py, sha256 checked against
   tools/corpus_manifest.json), encoded at level 3 with 64 KiB blocks by
   the port's native encoder: 512 blocks, 32 dispatch groups of 16;
3. each kernel against its plain PyTorch version on the card, on the first
   dispatch group as the port's pipeline preps it: equal bytes, the
   kernel's median time over CUDA-event-timed launches, the plain
   version's time and the bytes bound (``copy_engine.bytes_moved``: the
   group's live control and the window rows it reads, read once, and the
   output written once, over 3.35 TB/s);
4. the main path: ``decompress_e2e`` on the card for v26 (the cold
   default) and v19, each with every launch counter set to 0 just before
   and read just after; the output must equal the corpus, the kernel must
   have launched once per group, and the fingerprint form must equal the
   fingerprints computed on the host; wall time, GB/s and phase times;
5. a corrupted archive (flipped payload byte with checksums on) and a
   truncated one must raise ZxcError.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it fails without printing a result.
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
CORPUS_BYTES = 32 << 20
BLOCK = 64 << 10
DISPATCH = 16
REPLACES = {19: "zxc_tpu/ops/pallas_decode.py:1306",
            26: "zxc_tpu/ops/pallas_decode.py:1038"}
SOURCE = "zxc_tpu_torch/csrc/copy_engine.cu"


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


def host_fingerprint(data: bytes, block: int) -> tuple[int, int]:
    """f1 = sum of bytes, f2 = sum of byte * (offset in block % 8191),
    both mod 2^32 (the JAX package's device fingerprint)."""
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    w = np.arange(len(a), dtype=np.int64) % block % 8191
    return int(a.sum()) & 0xFFFFFFFF, int((a * w).sum()) & 0xFFFFFFFF


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import zxc_tpu_torch as Z
    from zxc_tpu_torch import runtime
    from zxc_tpu_torch.ops import _build, copy_engine as CE
    from zxc_tpu_torch.ops import device_pipeline as DP
    from gen_corpus import gen_corpus

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {kind})", flush=True)

    # -- 1. builds, in parallel ------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        fr = ex.submit(runtime.lib)
        fk = ex.submit(_build.kernels)
        fr.result()
        fk.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (libzxchost + "
          f"copy_engine.cu)", flush=True)
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas: {ln.strip()}")

    # -- 2. corpus and archive ---------------------------------------------
    t0 = time.perf_counter()
    data = gen_corpus(CORPUS_BYTES)
    with open(os.path.join(ROOT, "tools", "corpus_manifest.json")) as f:
        pinned = json.load(f)["mb32_seed42"]
    check(hashlib.sha256(data).hexdigest() == pinned,
          "corpus sha256 differs from tools/corpus_manifest.json")
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=BLOCK,
                                        threads=os.cpu_count() or 1))
    walk = DP.walk_frame(arc)
    n_groups = -(-walk.n_blocks // DISPATCH)
    print(f"corpus: {len(data)} bytes -> archive {len(arc)} bytes "
          f"({len(arc) / len(data):.4f}), {walk.n_blocks} blocks, "
          f"{n_groups} groups ({time.perf_counter() - t0:.2f} s)", flush=True)

    # -- 3. kernel vs plain on the first dispatch group --------------------
    rows = {}
    for variant in (19, 26):
        pipe = DP.DevicePipeline(walk, arc, K=2, dispatch=DISPATCH,
                                 variant=variant)
        pipe.size_shapes()
        buf = pipe.prep_group(0)
        args = CE.group_from_numpy(buf.qs, buf.qbase, buf.pctrl, buf.tq,
                                   buf.lit8, device="cuda")
        kern, ref = CE.KERNELS[variant], CE.REFERENCES[variant]
        out = kern(*args)
        plain = ref(*args)
        torch.cuda.synchronize()
        err = int((out.int() - plain.int()).abs().max())
        check(err == 0, f"v{variant} kernel differs from its plain version "
              f"(max abs err {err})")
        host = out.cpu().numpy().reshape(DISPATCH, -1)
        dec = b"".join(host[j, :buf.totals[j]].tobytes()
                       for j in range(DISPATCH))
        check(dec == data[:len(dec)],
              f"v{variant} kernel's first group differs from the corpus")
        ms = cuda_ms(lambda: kern(*args), reps=50)
        plain_ms = cuda_ms(lambda: ref(*args), reps=5, warm=1)
        # the bound counts what this group's control needs, not the padded
        # buffers (MAXQ and RLP carry the sizing margin)
        nbytes = CE.bytes_moved(buf.qs, buf.qbase, buf.pctrl, buf.tq,
                                buf.lit8, K=2)
        padded = sum(t.numel() * t.element_size() for t in args) + out.numel()
        rows[variant] = {
            "name": f"v{variant}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[variant], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}
        print(f"kernel v{variant}: MAXQ={pipe.MAXQ} RLP={pipe.RLP} "
              f"NG32={pipe.NG32}, {nbytes} bytes to move ({padded} in the "
              f"padded buffers); {ms:.4f} ms (median of 50) vs plain "
              f"{plain_ms:.2f} ms, bound {rows[variant]['bound_ms']:.6f} ms; "
              f"equal", flush=True)

    # -- 4. the main path ----------------------------------------------------
    fp_host = host_fingerprint(data, BLOCK)
    for variant in (26, 19):
        CE.v19.launches = 0
        CE.v26.launches = 0
        ph = {}
        t0 = time.perf_counter()
        out = Z.decompress_e2e(arc, device="cuda", variant=variant,
                               _phases=ph)
        wall0 = time.perf_counter() - t0
        counts = {19: CE.v19.launches, 26: CE.v26.launches}
        check(out == data, f"e2e v{variant} output differs from the corpus")
        check(counts[variant] == n_groups,
              f"e2e v{variant} launched its kernel {counts[variant]} times "
              f"for {n_groups} groups")
        rows[variant]["launches"] = counts[variant]
        walls, phs = [], []
        for _ in range(3):
            p = {}
            t0 = time.perf_counter()
            r = Z.decompress_e2e(arc, device="cuda", variant=variant,
                                 _phases=p)
            walls.append(time.perf_counter() - t0)
            phs.append(p)
            check(r == data, f"e2e v{variant} repeat differs")
        best = min(range(3), key=lambda i: walls[i])
        fp = Z.decompress_e2e(arc, device="cuda", variant=variant,
                              _collect="fingerprint")
        check(fp[:2] == fp_host and fp[2:] == (walk.n_blocks, len(data)),
              f"e2e v{variant} fingerprint {fp} vs host {fp_host}")
        print(f"e2e v{variant}: launches {counts}, first wall {wall0:.4f} s; "
              f"best of 3 {walls[best]:.4f} s = "
              f"{len(data) / 1e9 / walls[best]:.4f} GB/s; phases "
              + ", ".join(f"{k} {v:.4f} s" for k, v in phs[best].items())
              + f"; fingerprint {fp[:2]} equal", flush=True)

    # device busy share of one v26 decode (torch.profiler, CUPTI): kernel
    # and copy time on the card over the decode's wall time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Z.decompress_e2e(arc, device="cuda", variant=26)
        wall = time.perf_counter() - t0
    busy_us = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0}
    if busy_us:
        top = sorted(busy_us.items(), key=lambda kv: -kv[1])[:4]
        busy = sum(busy_us.values()) / 1e6
        print(f"profile e2e v26: wall {wall:.4f} s, device busy {busy:.5f} s "
              f"(idle share {1 - busy / wall:.4f}); top: "
              + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top),
              flush=True)
    else:
        print("profile e2e v26: the profiler recorded no device time "
              "(device busy share not measured)", flush=True)

    # -- 5. corrupted archives -------------------------------------------------
    small = Z.compress(data[:4 * BLOCK], Z.EncodeOpts(
        level=3, block_size=BLOCK, checksum=True))
    bad = bytearray(small)
    bad[60] ^= 0x20
    for name, arc_bad, opts in (
            ("flipped payload byte", bytes(bad), Z.DecodeOpts(checksum=True)),
            ("truncated archive", small[:len(small) // 2], None)):
        try:
            Z.decompress_e2e(arc_bad, opts, device="cuda")
        except Z.ZxcError as e:
            print(f"corrupt ({name}): raised {e}", flush=True)
        else:
            fail(f"{name} decoded without an error")

    print(json.dumps({"kernels": [rows[19], rows[26]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
