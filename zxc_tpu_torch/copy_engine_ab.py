"""Times the copy engine's kernels of this checkout against another
checkout's on one NVIDIA card, with the tile routine's cluster sizes swept
and steps of its slot loop taken out, to set ``copy_engine.tile_plan``.

    python3 -m zxc_tpu_torch.copy_engine_ab [--parent DIR] [--out FILE]

Builds this checkout's ``csrc/copy_engine.cu``, ablations of it (below)
and, with ``--parent``, another checkout's source (for example ``git
archive`` of the parent commit unpacked under ``build/``). Each library's
entries are called with the arguments their signatures name, so a source
whose entries take no cluster size or no scratch runs too. Groups: the
first dispatch group (16 blocks) of the pinned 32 MiB corpus
(``tools/gen_corpus.py``) at level 3 as each path ships it: v25 the
64 KiB archive resolved with ``self_ref=True`` (``serial.pack_blocks_v25``),
v26 and v19 the cold prep of the 64 KiB archive, v13 the 4 KiB archive as
``ops/serial.py`` packs it, the quad modes (12, 14-17, 20, 21, 23, 24)
the 64 KiB archive as ``attic_quad`` packs it, v13 on v12's packing of
the 64 KiB blocks (``probes.v13_bisect``'s paired mode) and v12's four
ablations (``probes.v12_ablate2``). Each kernel runs at this checkout's
``tile_plan`` (the parent's entries take none) in the order parent,
change, change, parent, each output equal to its plain version. Then,
this checkout only: v13, v19, v15 and v21 at cluster sizes 1, 2, 4 and 8
(outputs equal to the plain versions), and v13 and v19 at each size with
one step of the tile routine taken out (outputs wrong, not compared):
``empty`` (no slot loop: clear, walk, cluster sum, store), ``ballot`` (no
slot past the ballot), ``noadd`` (no slot adds), ``noload`` (no
source-row loads), ``noatomic`` (plain shared-memory adds, racy) and
``nodsmem`` (each rank sums its own tile C times: the cluster sum without
its distributed-shared-memory reads). Times: one CUDA-event pair around
20 calls queued behind a spin (``torch.cuda._sleep``), so the card never
waits for the host; each number is the median of 3 such. Prints the
card's name and power limit, one line a kernel and, last, one JSON object
(also written to ``--out``). Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("zxc_tpu_torch", "csrc", "copy_engine.cu")
SPIN_CYCLES = 50_000_000      # ~25 ms of the card's clock
QUEUED, REPEATS = 20, 3
DISPATCH = 16
BLOCK, SMALL_BLOCK = 64 << 10, 4 << 10
CLUSTERS = (1, 2, 4, 8)
OTHER_MODES = (12, 14, 16, 17, 20, 23, 24)
SWEPT = ("v13", "v19", "v15", "v21")
_LOOP = ("  add_slots<kRows, kLitRows, kLayout, kAblate>(a, b, t, range, "
         "a.K, lg, first,")
_ATOMIC = "if (((cover >> (8 * c)) & 0xff) && v) atomicAdd(trow + c, v);"
_LOAD = ": kRowsKind == kOutRows ? __ldcg(p) : __ldg(p);"
# steps of the tile routine taken out one at a time
STEPS = {
    "empty": ((_LOOP, "  if (t < 0)" + _LOOP[1:]),),
    "ballot": (("    while (todo) {", "    while (todo && t < 0) {"),),
    "noadd": (("        if (slot[n] < 0) cover = 0;", "        cover = 0;"),),
    "noload": ((_LOAD, ": (uint32_t)(size_t)p;"),),
    "noatomic": ((_ATOMIC, _ATOMIC.replace("atomicAdd(trow + c, v)",
                                           "trow[c] += v")),),
    "nodsmem": (("ld_peer(tile4 + r * part + k, (r + p) % C)",
                 "tile4[r * part + k]"),),
}
_ENTRY = re.compile(r"int (zxc_copy_engine_\w+)\(([^)]*)\)")


def back_to_back(fn) -> float:
    """Device ms of one call of ``fn``: the median of REPEATS event pairs,
    each around QUEUED calls queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(QUEUED):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / QUEUED)
    return statistics.median(times)


def signatures(source: str) -> dict[str, list[tuple[str, object]]]:
    """Each ``zxc_copy_engine_*`` entry's parameters: (name, ctypes type)."""
    out = {}
    for name, params in _ENTRY.findall(source):
        sig = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            kind = (ctypes.c_void_p if "*" in words else ctypes.c_int64
                    if "int64_t" in words else ctypes.c_int)
            sig.append((words[-1], kind))
        out[name] = sig
    return out


def build(name: str, source: str):
    """``source`` built as its own library; returns (library, its entries'
    signatures)."""
    from zxc_tpu_torch.buildlib import build_shared
    from zxc_tpu_torch.ops import _build
    d = os.path.join(ROOT, "build", "copy_engine_ab")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"ce_{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = ctypes.CDLL(build_shared(path, f"ce_ab_{name}",
                                   [_build._nvcc()] + _build.NVCC_FLAGS)[0])
    return lib, signatures(source)


class Group:
    """One kernel's first group on the card: its entry, tensors, integer
    arguments, output rows and plain version."""

    def __init__(self, entry, tensors: dict, ints: dict, rows: int, ref):
        self.entry, self.tensors, self.ints = entry, tensors, ints
        self.rows, self.ref = rows, ref

    def caller(self, lib, sigs, cluster=None):
        """A call of ``lib``'s entry on this group with a fresh output (and
        scratch, where the entry takes one) each call."""
        sig = sigs[self.entry]
        fn = getattr(lib, self.entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [k for _, k in sig]
        B, NT = self.ints["B"], self.ints["NT"]
        ints = dict(self.ints, NST=NT, cluster=cluster)

        def call():
            out = torch.empty((B, NT * self.rows, 128), dtype=torch.uint8,
                              device="cuda")
            sync = torch.empty(1 + B * NT, dtype=torch.int32, device="cuda")
            vals = {k: t.data_ptr() for k, t in self.tensors.items()}
            vals.update(ints, out=out.data_ptr(), sync=sync.data_ptr(),
                        stream=torch.cuda.current_stream().cuda_stream)
            rc = fn(*(vals[n] for n, _ in sig))
            if rc:
                raise RuntimeError(f"{self.entry} launch failed: cudaError "
                                   f"{rc}")
            return out
        return call


def groups() -> dict[str, Group]:
    """The kernels' first groups: v19, v26, v25, v13, the quad modes, v13
    on v12's packing of the 64 KiB blocks (``probes.v13_bisect``'s paired
    mode) and v12's ablations."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from gen_corpus import gen_corpus
    import zxc_tpu_torch as Z
    from zxc_tpu_torch.ops import attic_quad as AQ, batch as BT
    from zxc_tpu_torch.ops import copy_engine as CE
    from zxc_tpu_torch.ops import device_pipeline as DP, probes as P
    from zxc_tpu_torch.ops import serial as S

    data = gen_corpus(32 << 20)
    threads = os.cpu_count() or 1
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=BLOCK,
                                        threads=threads))
    arc4 = Z.compress(data, Z.EncodeOpts(level=3, block_size=SMALL_BLOCK,
                                         threads=threads))

    def first_group(a, self_ref=False):
        plan = BT.plan_frame(a)
        first = slice(0, DISPATCH)
        sub = BT.FramePlan(plan.block_size, ll=plan.ll[first],
                           ml=plan.ml[first], off=plan.off[first],
                           lit=plan.lit[first], totals=plan.totals[first],
                           dict_buf=plan.dict_buf)
        return (list(sub.totals),) + BT.resolve_serial(sub,
                                                       self_ref=self_ref)

    def group(entry, host, rows, ref, K=2, **extra):
        """``host``: CPU tensors (the cold prep) or numpy arrays (the
        packers)."""
        args = (tuple(t.cuda() for t in host)
                if isinstance(host[0], torch.Tensor)
                else CE.group_from_numpy(*host, device="cuda"))
        names = ("qs", "qbase", "pctrl", "tq", "lit8")
        B, W = args[0].shape
        NT = (W - 1) // 2 if extra.get("mode") == 20 else W - 1
        ints = dict(B=B, NT=NT, MAXQ=args[1].shape[1],
                    G32=args[2].shape[1] // K, K=K,
                    RLP=args[4].shape[1], **extra)
        return Group(entry, dict(zip(names, args)), ints, rows,
                     lambda: ref(*args))

    out = {}
    walk = DP.walk_frame(arc)
    for v in (19, 26):
        pipe = DP.DevicePipeline(walk, arc, K=2, dispatch=DISPATCH,
                                 variant=v)
        pipe.size_shapes()
        out[f"v{v}"] = group(f"zxc_copy_engine_v{v}", pipe.prep_group(0)[1],
                             128, CE.REFERENCES[v])
    totals, pieces, lits = first_group(arc, self_ref=True)
    out["v25"] = group("zxc_copy_engine_v25",
                       S.pack_blocks_v25(pieces, lits, totals, BLOCK), 128,
                       CE.v25_reference)
    totals4, pieces4, lits4 = first_group(arc4)
    (g13,) = S.pack_groups(pieces4, lits4, totals4, SMALL_BLOCK, True,
                           DISPATCH)
    out["v13"] = group("zxc_copy_engine_v13", g13, 32, CE.v13_reference, K=1)
    totals, pieces, lits = first_group(arc)
    for v in (15, 21) + OTHER_MODES:
        mode, pack, _ = AQ.VARIANTS[v]
        m = CE.QUAD_MODES[mode]
        out[f"v{v}"] = group(
            "zxc_copy_engine_quad", pack(pieces, lits, totals, BLOCK),
            m.rows, lambda *a, mode=mode: CE.quad_reference(*a, mode=mode),
            K=2 if m.multi else 1, mode=mode)
    v12 = S.pack_blocks_v12(pieces, lits, totals, BLOCK, quad_align=2)
    out["v13_bisect paired"] = group("zxc_copy_engine_v13", v12, 32,
                                     CE.v13_reference, K=1)
    v12 = S.pack_blocks_v12(pieces, lits, totals, BLOCK, quad_align=1)
    for name, k in CE.QUAD_ABLATIONS.items():
        out[f"v12_ablate2 {name}"] = group(
            "zxc_copy_engine_quad_ablate", v12, 32,
            lambda *a, name=name: P.v12_ablate2_reference(*a, name), K=1,
            ablate=k)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout")
    ap.add_argument("--out", help="also write the JSON object here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("copy_engine_ab: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from zxc_tpu_torch.ops import copy_engine as CE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(ROOT, SRC)) as f:
        change = f.read()
    sources = {"change": change}
    for name, subs in STEPS.items():
        s = change
        for old, new in subs:
            if old not in s:
                print(f"copy_engine_ab: ablation {name}: source text not "
                      "found", file=sys.stderr)
                sys.exit(1)
            s = s.replace(old, new)
        sources[name] = s
    if opts.parent:
        with open(os.path.join(opts.parent, SRC)) as f:
            sources["parent"] = f.read()
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(lambda kv: build(*kv),
                                        sources.items())))
    G = groups()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = (["parent", "change", "change", "parent"] if opts.parent
             else ["change", "change"])
    result = {"card": smi, "ab": {}, "sweep": {}, "plan": {}}
    for name, g in G.items():
        rows = g.rows
        C = CE.tile_plan(g.ints["B"], g.ints["NT"], rows, sms).C
        tiled = "cluster" in dict(libs["change"][1][g.entry])
        result["plan"][name] = C if tiled else None
        want = g.ref()
        times = {}
        for who in order:
            lib, sigs = libs[who]
            call = g.caller(lib, sigs, C)
            if not torch.equal(call(), want):
                print(f"copy_engine_ab: {name} of {who} differs from its "
                      "plain version", file=sys.stderr)
                sys.exit(1)
            times.setdefault(who, []).append(back_to_back(call))
        result["ab"][name] = times
        print(f"{name} (B={g.ints['B']} NT={g.ints['NT']} MAXQ="
              f"{g.ints['MAXQ']} RLP={g.ints['RLP']}"
              + (f", C={C}" if tiled else "") + "), ms back to back: "
              + "; ".join(f"{w} " + " ".join(f"{t:.4f}" for t in ts)
                          for w, ts in times.items()), flush=True)
        if not tiled or name not in SWEPT:
            continue
        sweep = {}
        for c in CLUSTERS:
            call = g.caller(*libs["change"], c)
            if not torch.equal(call(), want):
                print(f"copy_engine_ab: {name} at C={c} differs from its "
                      "plain version", file=sys.stderr)
                sys.exit(1)
            sweep[c] = {"change": back_to_back(call)}
            if name in ("v13", "v19"):
                for k in STEPS:
                    sweep[c][k] = back_to_back(g.caller(*libs[k], c))
        result["sweep"][name] = sweep
        print(f"{name} sweep, ms back to back by cluster size: "
              + "; ".join(f"C={c} " + " ".join(f"{k} {v:.4f}"
                                               for k, v in s.items())
                          for c, s in sweep.items()), flush=True)
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
