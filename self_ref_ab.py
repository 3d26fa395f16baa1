#!/usr/bin/env python3
"""v26's copy-engine kernel against an earlier checkout's, and against
ablations of its own source, on one card.

    python3 self_ref_ab.py [--parent DIR] [--ablate]

Builds ``zxc_tpu_torch/csrc/copy_engine.cu`` of this checkout and, with
``--parent``, of another checkout (for example ``git archive`` of the
parent commit unpacked under ``build/``), and times the entry
``zxc_copy_engine_v26`` of each back to back (``chip_smoke.device_ms``:
20 calls queued behind a spin, one event pair) on the first dispatch
group of the pinned corpus (``tools/gen_corpus.py``) at level 3 as the
cold prep ships it: at 64 KiB blocks (16 blocks of 4 supertiles) and at
512 KiB blocks (16 of 32). Order: parent, change, change, parent. Every
output must equal ``copy_engine.v26_reference``. With ``--ablate`` it
also builds this checkout's source with one step of the (supertile,
block) kernel taken out, and times each between the change's runs (their
outputs are wrong and not compared):

* ``pass1``: pass 2 never runs (lists, pass 1, tile store, flags);
* ``pass2``: pass 1 never runs (the waits and pass 2 stay);
* ``nowait``: no CTA waits on a flag (pass 2 reads what is stored);
* ``noatomic``: plain shared-memory adds in place of atomicAdd (racy);
* ``empty``: neither pass runs (lists, tile store, flag hand-offs).

It prints the card's name and power limit, and each time in ms.
"""
import argparse
import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join("zxc_tpu_torch", "csrc", "copy_engine.cu")
_P1 = "    add_batches<kFlat, false>(a, b, t, L.q[0], L.qb[0], L.n[0], tile);"
_P2 = "      add_batches<kFlat, true>(a, b, t, L.q[1], L.qb[1], L.n[1], tile);"
_OFF1 = (_P1, "    if (t < 0)" + _P1[3:])
_OFF2 = (_P2, "      if (t < 0)" + _P2[5:])
ABLATIONS = {
    "pass1": (_OFF2,),
    "pass2": (_OFF1,),
    "nowait": (("for (int k = threadIdx.x; k < t; k += blockDim.x)",
                "for (int k = threadIdx.x; k < 0; k += blockDim.x)"),),
    "noatomic": (("if (((cover >> (8 * c)) & 0xff) && v) atomicAdd(trow + c,"
                  " v);", "if (((cover >> (8 * c)) & 0xff) && v) trow[c] "
                  "+= v;"),),
    "empty": (_OFF1, _OFF2),
}


def build(name: str, source: str):
    """``source`` built into ``build/self_ref_ab/`` as its own library;
    returns (library, whether its v26 entry takes the sync scratch)."""
    from zxc_tpu_torch.buildlib import build_shared
    from zxc_tpu_torch.ops import _build
    d = os.path.join(ROOT, "build", "self_ref_ab")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"ce_{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = ctypes.CDLL(build_shared(path, f"ab_{name}",
                                   [_build._nvcc()] + _build.NVCC_FLAGS)[0])
    sync = "int32_t* sync" in source
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zxc_copy_engine_v26.restype = ci
    lib.zxc_copy_engine_v26.argtypes = ([vp] * (7 if sync else 6)
                                        + [ci] * 6 + [vp])
    return lib, sync


def caller(lib, sync: bool, args):
    """A call of ``lib``'s v26 entry on the group ``args`` (tensors on the
    card), with a fresh output (and scratch) each call."""
    import torch
    from zxc_tpu_torch.ops import copy_engine as CE
    B, NST, MAXQ, G32, RLP = CE._dims(*args, 2)

    def call():
        out = torch.empty((B, NST * 128, 128), dtype=torch.uint8,
                          device="cuda")
        extra = ([torch.empty(1 + B * NST, dtype=torch.int32,
                              device="cuda")] if sync else [])
        rc = lib.zxc_copy_engine_v26(
            *(t.data_ptr() for t in (*args, out, *extra)), B, NST, MAXQ,
            G32, 2, RLP, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"v26 launch failed: cudaError {rc}")
        return out
    return call


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of an earlier checkout")
    ap.add_argument("--ablate", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    import chip_smoke as C
    import zxc_tpu_torch as Z
    from zxc_tpu_torch.ops import copy_engine as CE
    from zxc_tpu_torch.ops import device_pipeline as DP
    from gen_corpus import gen_corpus

    if not torch.cuda.is_available():
        C.fail("CUDA is not available: this script needs an NVIDIA card")
    print(f"card: {C.smi_line()}", flush=True)
    with open(os.path.join(ROOT, SRC)) as f:
        change = f.read()
    sources = {"change": change}
    if opts.parent:
        with open(os.path.join(opts.parent, SRC)) as f:
            sources["parent"] = f.read()
    if opts.ablate:
        for name, subs in ABLATIONS.items():
            s = change
            for old, new in subs:
                C.check(old in s, f"ablation {name}: source text not found")
                s = s.replace(old, new)
            sources[name] = s
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(lambda kv: build(*kv),
                                        sources.items())))
    order = ["change"] + [n for n in sources if n not in ("change",
                                                          "parent")]
    order = order + ["change"]
    if opts.parent:
        order = ["parent"] + order + ["parent"]
    data = gen_corpus(32 << 20)
    for block in (64 << 10, 512 << 10):
        arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=block,
                                            threads=os.cpu_count() or 1))
        pipe = DP.DevicePipeline(DP.walk_frame(arc), arc, K=2, dispatch=16,
                                 variant=26)
        pipe.size_shapes()
        args = tuple(t.cuda() for t in pipe.prep_group(0)[1])
        want = CE.v26_reference(*args)
        times = {n: [] for n in sources}
        for name in order:
            call = caller(*libs[name], args)
            if name in ("change", "parent"):
                C.check(torch.equal(call(), want),
                        f"{name} differs from the plain version")
            times[name].append(C.device_ms(call))
        print(f"v26, {block >> 10} KiB blocks (B=16 NST={pipe.NST} "
              f"MAXQ={pipe.MAXQ} RLP={pipe.RLP}), ms back to back: "
              + "; ".join(f"{n} " + " ".join(f"{t:.4f}" for t in ts)
                          for n, ts in times.items()), flush=True)


if __name__ == "__main__":
    main()
