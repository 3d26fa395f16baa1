"""Times the LCP kernel and the window merge (modes 4-7) of this checkout
against another checkout's on one NVIDIA card, with ablations of this
checkout's two kernels.

    python3 -m zxc_tpu_torch.lcp_merge_ab --parent DIR [--out FILE]

Builds this checkout's ``csrc/encode.cu`` and ``csrc/attic.cu``, text
substitutions of them (below) and the sources of the checkout at DIR (for
example ``git archive`` of the parent commit unpacked under ``build/``),
each as its own library, in parallel. Each library's ``zxc_lcp`` and
``zxc_window_merge`` are called with the arguments their signatures name,
so an entry without a split argument runs too. Inputs: ``lcp`` on the
first dispatch group (16 blocks of 64 KiB) of the pinned 32 MiB corpus
(``tools/gen_corpus.py``) at level 3 as ``compress_device`` feeds it
(``encode.lcp_inputs``), on 16 blocks of all-equal bytes with the same
pairs (every pair reaches 256) and on 16 random blocks with their own
pairs (nearly every pair ends in the first round); the window merge in
modes 4-7 on the first 16 blocks of the corpus's 64 KiB archive as
``attic.pack_blocks_v4`` packs each mode, and in mode 4 on a hand-made
group of the same shape whose ops each cover the whole window (the
cover's worst case). Each runs in the order parent, change, change,
parent, every output equal to its plain version. Times: one CUDA-event
pair around 20 calls queued behind a spin (``chip_smoke.device_ms``); each
number is the median of 3 such.

Ablations, this checkout only (outputs of those that take a step out are
not compared):

* lcp ``empty``: the int4 pair-word loads and result stores only, no
  stage (the I/O floor); ``stage``: the stage and the I/O; ``nopipe``:
  a lane's next pair words loaded only when it takes them; ``noqueue``:
  long pairs finished in their own lane; ``nobatch``: every queued pair
  finished a pair a warp step; ``first16``: a first round of 16 bytes;
  ``wide``: the first round as one piece, 32 bytes a side from aligned
  16-byte loads; ``threads256`` / ``threads512``: CTAs of 256 threads,
  3 an SM / of 512, 2 an SM; and the split (CTAs a block) at half, one
  and two times ``encode_kernels.lcp_plan``'s (outputs compared but for
  ``empty`` and ``stage``), on the first group and on the all-equal
  blocks;
* window merge ``empty``: the ``wstart`` reads and the store; ``cover``:
  phase 1 only; ``s256``: stage rounds of 256 ops against 1,024;
  ``noskip``: every covered byte taken, also those of ops before a
  round's last whole-window op; ``search``: each covered byte's op by
  its own binary search, the threads striding over the bytes (outputs
  compared but for ``empty`` and ``cover``), on mode 4's group and on
  the group whose every op covers the whole window.

Then ``compress_device`` of the corpus's first 4 MiB at level 3 with
64 KiB blocks, by this checkout and by the one at DIR (in a process of
its own), must give the same archive. Prints the card's name and power
limit first, a line a measurement, and one JSON object last (also written
to ``--out``). Needs a CUDA card; exits 1 without one. An edit of the
substituted source lines makes it stop with "source text not found".
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC_SRC = os.path.join("zxc_tpu_torch", "csrc", "encode.cu")
ATTIC_SRC = os.path.join("zxc_tpu_torch", "csrc", "attic.cu")
BLOCK, DISPATCH, LEVEL = 64 << 10, 16, 3
REPEATS = 3
COVER_OPS = 124        # ops a window of the hand-made plan (v4's group)

ARCHIVE = """
import hashlib, sys
sys.path[:0] = ['.', 'tools']
from gen_corpus import gen_corpus
import zxc_tpu_torch as Z
arc = Z.ops.compress_device(gen_corpus(32 << 20)[:4 << 20], level=3,
                            block_size=65536)
print(hashlib.sha256(arc).hexdigest())
"""

_STAGE = "  stage_block(stage, blk + (long long)b * L, n, &bar);"
_FIRST = "    m[j] = lane_lcp(st, p, c, 0, kFirst);"
_LONG = "    const bool lng = j < cnt && m[j] == kFirst;"
_ROUND = "// A warp's round:"
_PRELOAD = "  load_group(pc, f0, g + lane, g1, w);\n  stage_block("
_NEXT = ("    uint32_t next[4];\n"
         "    load_group(pc, f0, g + kLcpThreads + lane, g1, next);")
_THREADS = "constexpr int kLcpThreads = 1024;"
_BOUNDS = "__launch_bounds__(kLcpThreads, 1)"
# wide: the first round as one piece, kFirst bytes a side from aligned
# 16-byte loads, the words shifted by selects and funnel shifts
_WIDE = """template <int kW>
__device__ __forceinline__ void stage_words(const unsigned char* st, int x,
                                            uint32_t (&v)[kW]) {
  constexpr int kQ = kW / 4 + 1;
  const uint4* q = reinterpret_cast<const uint4*>(st + (x & ~15));
  uint32_t a[4 * kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const uint4 t = q[i];
    a[4 * i] = t.x; a[4 * i + 1] = t.y; a[4 * i + 2] = t.z;
    a[4 * i + 3] = t.w;
  }
  const int k = (x >> 2) & 3, sh = 8 * (x & 3);
#pragma unroll
  for (int i = 0; i + 2 < 4 * kQ; ++i) a[i] = (k & 2) ? a[i + 2] : a[i];
#pragma unroll
  for (int i = 0; i + 3 < 4 * kQ; ++i) a[i] = (k & 1) ? a[i + 1] : a[i];
#pragma unroll
  for (int i = 0; i < kW; ++i) v[i] = __funnelshift_r(a[i], a[i + 1], sh);
}

__device__ __forceinline__ int first_round(const unsigned char* st, int p,
                                           int c) {
  constexpr int kW = kFirst / 4;
  uint32_t a[kW], b[kW];
  stage_words<kW>(st, p, a);
  stage_words<kW>(st, c, b);
  int m = kFirst;
#pragma unroll
  for (int i = kW - 1; i >= 0; --i) {
    const uint32_t d = a[i] ^ b[i];
    if (d) m = 4 * i + ((__ffs(d) - 1) >> 3);
  }
  return m;
}

"""
_COVER = """    for (int j = j0 + warp * share + lane; j < j1; j += 32) {
      if (i < 0) {
        int lo = 0, hi = n;   // the last op whose first covered byte <= j
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (first[mid] <= j) lo = mid + 1; else hi = mid;
        }
        i = lo - 1;
        at = min(stage[i].z & 0xFFFF, kWindow) - first[i];
      } else if (i + 1 < n && first[i + 1] <= j) {
        do ++i; while (i + 1 < n && first[i + 1] <= j);
        at = min(stage[i].z & 0xFFFF, kWindow) - first[i];
      }
      atomicMax(&last[at + j], (int)(c0 - t0) + i);
    }
"""
# search: each covered byte's op by its own binary search, the threads
# striding over the round's bytes
_SEARCH = """    for (int j = threadIdx.x; j < total; j += kThreads) {
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (first[mid] <= j) lo = mid + 1; else hi = mid;
      }
      i = lo - 1;
      at = min(stage[i].z & 0xFFFF, kWindow) - first[i];
      atomicMax(&last[at + j], (int)(c0 - t0) + i);
    }
"""
_ROUNDS = "  for (long long c0 = t0; c0 < t1; c0 += kMergeStage) {"
_RESOLVE = "    if (t < 0) continue;"
_S = "constexpr int kMergeStage = 1024;"
_SKIP = "    const int j0 = full < 0 ? 0 : first[full];"

# name -> (source, substitutions); the lcp ablations run at the chosen
# split unless SPLITS names CTAs an SM for them
ABLATIONS = {
    "lcp empty": (ENC_SRC, ((_STAGE, "  if (n < 0)" + _STAGE[1:]),
                            (_FIRST, "    m[j] = (int)(w[j] & 7);"))),
    "lcp stage": (ENC_SRC, ((_FIRST, "    m[j] = (int)(w[j] & 7);"),)),
    "lcp nopipe": (ENC_SRC, (
        (_PRELOAD, "  stage_block("),
        (_NEXT, "    load_group(pc, f0, g + lane, g1, w);\n"
                "    uint32_t next[4] = {w[0], w[1], w[2], w[3]};"))),
    "lcp noqueue": (ENC_SRC, ((_LONG, (
        "    if (j < cnt && m[j] == kFirst) m[j] = lane_lcp(st, p, c, kFirst,"
        " kCap);\n    const bool lng = false;")),)),
    "lcp nobatch": (ENC_SRC, (("constexpr int kBatch = 16;",
                               "constexpr int kBatch = 1 << 30;"),)),
    "lcp first16": (ENC_SRC, (("constexpr int kFirst = 32;",
                               "constexpr int kFirst = 16;"),)),
    "lcp wide": (ENC_SRC, ((_ROUND, _WIDE + _ROUND),
                           (_FIRST, "    m[j] = first_round(st, p, c);"))),
    "lcp threads256": (ENC_SRC, ((_THREADS, _THREADS.replace("1024", "256")),
                                 (_BOUNDS, _BOUNDS.replace("1)", "3)")))),
    "lcp threads512": (ENC_SRC, ((_THREADS, _THREADS.replace("1024", "512")),
                                 (_BOUNDS, _BOUNDS.replace("1)", "2)")))),
    "window_merge empty": (ATTIC_SRC, ((_ROUNDS, _ROUNDS.replace(
        "c0 < t1", "c0 < t0")),)),
    "window_merge cover": (ATTIC_SRC, ((_RESOLVE, "    acc[q] = (uint32_t)t;"
                                        "\n    continue;"),)),
    "window_merge s256": (ATTIC_SRC, ((_S, _S.replace("1024", "256")),)),
    "window_merge noskip": (ATTIC_SRC, ((_SKIP, "    const int j0 = 0;"),)),
    "window_merge search": (ATTIC_SRC, ((_COVER, _SEARCH),
                                        (_SKIP, "    const int j0 = 0;"))),
}
SPLITS = {"lcp threads256": 3, "lcp threads512": 2}
COMPARED = ("lcp nopipe", "lcp noqueue", "lcp nobatch", "lcp first16",
            "lcp wide", "lcp threads256", "lcp threads512",
            "window_merge s256", "window_merge noskip",
            "window_merge search")
_ENTRY = re.compile(r"int (zxc_\w+)\(([^)]*)\)")


def median_ms(fn) -> float:
    import chip_smoke as S
    return statistics.median(S.device_ms(fn) for _ in range(REPEATS))


def ablated(name: str) -> str:
    """This checkout's source with ablation ``name``'s substitutions."""
    path, subs = ABLATIONS[name]
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"lcp_merge_ab: {name}: source text not found: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def signatures(source: str) -> dict:
    """The entries' parameters: (name, ctypes type) each."""
    out = {}
    for name, params in _ENTRY.findall(source):
        sig = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            kind = (ctypes.c_void_p if "*" in words else ctypes.c_longlong
                    if "long" in words else ctypes.c_int)
            sig.append((words[-1], kind))
        out[name] = sig
    return out


class Lib:
    """One built source (under ``build/<subdir>``): its entries called by
    their parameters' names; ``log`` holds nvcc's and ptxas's output."""

    def __init__(self, name: str, source: str, subdir: str = "lcp_merge_ab"):
        from zxc_tpu_torch.buildlib import build_shared
        from zxc_tpu_torch.ops import _build
        d = os.path.join(ROOT, "build", subdir)
        os.makedirs(d, exist_ok=True)
        stem = re.sub(r"\W", "_", name)
        path = os.path.join(d, stem + ".cu")
        with open(path, "w") as f:
            f.write(source)
        so, self.log = build_shared(path, f"{subdir}_{stem}",
                                    [_build._nvcc()] + _build.NVCC_FLAGS)
        self.lib = ctypes.CDLL(so)
        self.sigs = signatures(source)

    def call(self, entry: str, **vals) -> None:
        sig = self.sigs[entry]
        fn = getattr(self.lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [k for _, k in sig]
        vals["stream"] = torch.cuda.current_stream().cuda_stream
        rc = fn(*(vals[n] for n, _ in sig))
        if rc:
            raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def lcp_call(lib: Lib, blk, pc, split: int):
    def call():
        out = torch.empty(pc.shape, dtype=torch.int32, device="cuda")
        B, L = blk.shape
        lib.call("zxc_lcp", blk=blk.data_ptr(), pc=pc.data_ptr(),
                 out=out.data_ptr(), B=B, L=L, n=L, NP=pc.shape[1],
                 split=split)
        return out
    return call


def merge_call(lib: Lib, args, mode: int):
    wstart, ops, lit8 = args

    def call():
        B = ops.shape[0]
        out = torch.empty((B, BLOCK), dtype=torch.uint8, device="cuda")
        lib.call("zxc_window_merge", wstart=wstart.data_ptr(),
                 ops=ops.data_ptr(), cap=ops.shape[1] * 32,
                 lit=lit8.data_ptr(), rl=lit8.shape[1], out=out.data_ptr(),
                 B=B, block=BLOCK, mode=mode)
        return out
    return call


def cover_group(ops_per_window: int, RL: int, seed: int = 0):
    """A group of DISPATCH blocks whose ops each cover the whole window
    (dlo 0, dhi 1,024), ``ops_per_window`` a window, random srow, net and
    fills, packed as ``pack_blocks_v4`` lays ops out."""
    rng = np.random.default_rng(seed)
    NW = BLOCK // 1024
    n = NW * ops_per_window
    cap = (-(-n * 4 // 128) + 24) * 32
    ops = np.zeros((DISPATCH, cap, 4), np.int32)
    ops[:, :n, 0] = rng.integers(0, RL - 16, (DISPATCH, n))
    ops[:, :n, 1] = rng.integers(0, 2048, (DISPATCH, n))
    ops[:, :n, 2] = 1024 << 16
    ops[:, :n, 3] = np.where(rng.random((DISPATCH, n)) < 0.2, 7, 0)
    wstart = np.broadcast_to(np.arange(NW + 1) * ops_per_window,
                             (DISPATCH, NW + 1)).astype(np.int32).copy()
    lit8 = rng.integers(0, 256, (DISPATCH, RL, 128), dtype=np.uint8)
    return wstart, ops.reshape(DISPATCH, -1, 128), lit8


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of another "
                    "checkout")
    ap.add_argument("--out", help="also write the JSON object here")
    opts = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import chip_smoke as S
    if not torch.cuda.is_available():
        S.fail("lcp_merge_ab needs a CUDA card")
    smi = S.smi_line()
    print(f"card: {smi}", flush=True)
    import zxc_tpu_torch as Z
    from gen_corpus import gen_corpus
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.ops import attic as AT, batch as BT
    from zxc_tpu_torch.ops import encode as ENC, encode_kernels as EK

    sources = {}
    for who, root in (("change", ROOT), ("parent", opts.parent)):
        for path in (ENC_SRC, ATTIC_SRC):
            with open(os.path.join(root, path)) as f:
                sources[f"{who} {os.path.basename(path)}"] = f.read()
    sources.update((name, ablated(name)) for name in ABLATIONS)
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(lambda kv: Lib(*kv),
                                        sources.items())))
    result = {"card": smi, "ab": {}, "ablations": {}, "stats": {}}

    def ab(name, kind, call_of, plain):
        """parent, change, change, parent; both equal to ``plain``."""
        src = "encode.cu" if kind == "lcp" else "attic.cu"
        calls = {w: call_of(libs[f"{w} {src}"]) for w in ("parent", "change")}
        want = plain()
        for who, call in calls.items():
            S.check(torch.equal(call(), want), f"{name}: the {who} differs "
                    "from the plain version")
        times = {}
        for who in ("parent", "change", "change", "parent"):
            times.setdefault(who, []).append(median_ms(calls[who]))
        result["ab"][name] = times
        print(f"{name}: back to back ms parent {times['parent'][0]:.4f}, "
              f"change {times['change'][0]:.4f}, change "
              f"{times['change'][1]:.4f}, parent {times['parent'][1]:.4f}",
              flush=True)
        return want

    def ablate(name, rows):
        """Each (label, call, plain or None) timed between two runs of the
        change."""
        out = {}
        for label, call, plain in rows:
            if plain is not None:
                S.check(torch.equal(call(), plain()), f"{label} differs from "
                        "the plain version")
            out[label] = median_ms(call)
        result["ablations"][name] = out
        print(f"{name} ablations, ms back to back: " + "; ".join(
            f"{k} {v:.4f}" for k, v in out.items()), flush=True)

    # -- lcp ---------------------------------------------------------------
    data = gen_corpus(32 << 20)
    n_cand = frame.level_params(LEVEL).n_candidates
    grp = torch.from_numpy(np.frombuffer(data, np.uint8, DISPATCH * BLOCK)
                           .reshape(DISPATCH, BLOCK).copy()).cuda()
    rnd = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (DISPATCH, BLOCK), dtype=np.uint8)).cuda()
    pc = ENC.lcp_inputs(grp, n_cand)[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = EK.lcp_plan(DISPATCH, pc.shape[1], sms)
    result["lcp_split"] = split
    inputs = {"first group": (grp, pc),
              "all-equal blocks": (torch.full_like(grp, 0x41), pc),
              "random blocks": (rnd, ENC.lcp_inputs(rnd, n_cand)[0])}
    for label, (blk, p) in inputs.items():
        want = ab(f"lcp {label}", "lcp", lambda L, b=blk, q=p: lcp_call(
            L, b, q, split), lambda b=blk, q=p: EK.lcp_reference(b, q))
        first, cap = EK.lcp_shares(want)
        result["stats"][f"lcp {label}"] = {"first_round": first, "cap": cap}
        print(f"  lcp {label}: {first:.6f} of {want.numel()} pairs end in "
              f"the first {EK.LCP_FIRST} bytes, {cap:.6f} reach {EK.CAP}",
              flush=True)
    for label in ("first group", "all-equal blocks"):
        blk, p = inputs[label]

        def plain(b=blk, q=p):
            return EK.lcp_reference(b, q)
        rows = [(f"split {s}", lcp_call(libs["change encode.cu"], blk, p, s),
                 plain) for s in (max(1, split // 2), split, 2 * split)]
        rows += [(name.split()[1], lcp_call(
                      libs[name], blk, p,
                      SPLITS[name] * sms // DISPATCH if name in SPLITS
                      else split), plain if name in COMPARED else None)
                 for name in ABLATIONS if name.startswith("lcp")]
        ablate(f"lcp {label}", rows)

    # -- the window merge ----------------------------------------------------
    arc = Z.compress(data, Z.EncodeOpts(level=LEVEL, block_size=BLOCK,
                                        threads=os.cpu_count() or 1))
    plan = BT.plan_frame(arc)
    first = slice(0, DISPATCH)
    sub = BT.FramePlan(plan.block_size, ll=plan.ll[first], ml=plan.ml[first],
                       off=plan.off[first], lit=plan.lit[first],
                       totals=plan.totals[first], dict_buf=plan.dict_buf)
    pieces, lits = BT.resolve_serial(sub)
    totals = list(sub.totals)
    groups = {}
    for mode in (4, 5, 6, 7):
        host, _ = AT.pack_blocks_v4(
            pieces, lits, totals, BLOCK, split_src=mode >= 5,
            pad_unroll={6: AT.UNROLL, 7: AT.UNROLL7}.get(mode, 0))
        groups[f"mode {mode}"] = (mode, host)
    RL = groups["mode 4"][1][2].shape[1]
    groups["mode 4, every op the whole window"] = (4, cover_group(COVER_OPS,
                                                                  RL))
    for label, (mode, host) in groups.items():
        args = [torch.from_numpy(a).cuda() for a in host]
        ab(f"window_merge {label}", "merge",
           lambda L, a=args, m=mode: merge_call(L, a, m),
           lambda a=args, m=mode: AT.window_merge_reference(
               *a, block=BLOCK, mode=m))
        if mode == 4:
            ablate(f"window_merge {label}", [
                (name.split()[1], merge_call(libs[name], args, 4),
                 (lambda a=args: AT.window_merge_reference(
                     *a, block=BLOCK, mode=4)) if name in COMPARED else None)
                for name in ABLATIONS if name.startswith("window_merge")])

    # -- the compress_device archive ------------------------------------------
    mine = hashlib.sha256(Z.ops.compress_device(
        data[:4 << 20], level=LEVEL, block_size=BLOCK)).hexdigest()
    r = subprocess.run([sys.executable, "-c", ARCHIVE], cwd=opts.parent,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=opts.parent))
    S.check(r.returncode == 0, f"the parent's compress_device failed: "
            f"{r.stderr[-2000:]}")
    theirs = r.stdout.strip().splitlines()[-1]
    result["archive_sha256"] = {"change": mine, "parent": theirs}
    print(f"compress_device, first 4 MiB, level 3: sha256 change {mine}, "
          f"parent {theirs}", flush=True)
    S.check(mine == theirs, "compress_device archives differ from the "
            "parent's")
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
