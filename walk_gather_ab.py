#!/usr/bin/env python3
"""The parse walk and the grid gather of this checkout against another
checkout's, on one card.

    python3 walk_gather_ab.py --parent DIR

Builds ``zxc_tpu_torch/csrc/encode.cu`` and ``csrc/gather.cu`` of the
checkout at DIR (for example ``git archive`` of an earlier commit
unpacked under ``build/``), whose entries are the one-thread walk
``zxc_parse_walk(step, nseq, pos, B, P, CAP, stream)`` and the grid form of
``zxc_gather_axis1(..., esize, tile_cols, stream)``, and times them back to
back (``chip_smoke.device_ms``: 20 calls queued behind a spin, one event
pair) against this checkout's ``encode_kernels.parse_walk`` and
``probes.gather_grid``, in the order parent, change, change, parent:

* the walk on the first dispatch group of the pinned corpus
  (``tools/gen_corpus.py``) at level 3, 16 blocks of 64 KiB as
  ``compress_device`` feeds it, and on 16 rows of 65,536 steps of 5, where
  walks started apart never meet;
* the grid gather on x (8, 65536) int32, idx (8, 524288), tile 8192 (the
  probe's shape), beside ``torch.gather`` on an int64 index made
  beforehand.

Every output must equal the plain version. Then ``compress_device`` of the
corpus's first 4 MiB at level 3 with 64 KiB blocks, by this checkout and
by the one at DIR (in a process of its own), must give the same archive.
With ``--ablate`` it also builds this checkout's sources with one phase
taken out or done another way, and times each beside the change (no
output of theirs is compared; those with a phase taken out are wrong):

* ``walk_stage``: the walk stops after the stage and the record bitmap;
* ``walk_spec``: after the speculative walks;
* ``walk_sync``: after the synchronizing rounds (no count, scan, write);
* ``grid_fill``: the cluster gather fills the row and takes no column;
* ``grid_onecopy``: the row's slice filled by one bulk copy, not 16 KiB
  pieces;
* ``grid_dsmem``: each CTA of a cluster takes its own share of the
  cluster's columns and reads every element from the CTA that holds it,
  through distributed shared memory (``mapa``, ``ld.shared::cluster``),
  in place of answering only the indices of its own slice;

and the grid gather's L2 form at the probe's shape. It prints the card's
name and power limit, each time in ms, and the archives' sha256.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

ARCHIVE = """
import hashlib, sys
sys.path[:0] = ['.', 'tools']
from gen_corpus import gen_corpus
import zxc_tpu_torch as Z
arc = Z.ops.compress_device(gen_corpus(32 << 20)[:4 << 20], level=3,
                            block_size=65536)
print(hashlib.sha256(arc).hexdigest())
"""


_SYNC = "  if (mine) clear_marks(M, c0, c1);\n  __syncthreads();\n"
_SPEC = ("  if (mine) exits[k] = ex = walk_marking(row, M, G, c0, c1);\n"
         "  __syncthreads();\n")
_STOP = "  if (P > 0) return;\n"
_OWNER = """  owner_passes(idx + i * NI, out + i * NI, j0, min(j0 + cols, NI), part,
               (int)lo, n, N, rank == 0);
"""
# each CTA its share of the cluster's columns, every element read from the
# CTA that holds it through distributed shared memory
_DSMEM = """  cluster.sync();
  const int K = (int)cluster.num_blocks();
  const uint32_t base = shared_addr(part);
  const auto row = [&](int k) -> T {
    if ((unsigned)k >= (unsigned)N) return T(0);
    const int r = k / slice;
    uint32_t a, v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a)
                 : "r"(base + (uint32_t)((k - r * slice) * (int)sizeof(T))),
                   "r"(r));
    if constexpr (sizeof(T) == 4) {
      asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
    } else {
      unsigned short h;
      asm volatile("ld.shared::cluster.u8 %0, [%1];" : "=h"(h) : "r"(a));
      v = h;
    }
    return (T)v;
  };
  const long long sub = (cols + K - 1) / K;
  const long long j1 = min(min(j0 + (rank + 1) * sub, j0 + cols), NI);
  for (long long cb = j0 + rank * sub; cb < j1;
       cb += (long long)blockDim.x * kGridCols)
    gather_pass_scalar<kGridCols>(idx + i * NI, out + i * NI, cb, j1, row);
  cluster.sync();
"""
ABLATIONS = {
    "walk_stage": ("encode", ((_SYNC, _SYNC + _STOP),)),
    "walk_spec": ("encode", ((_SPEC, _SPEC + _STOP),)),
    "walk_sync": ("encode", (("  // (5) count, scan, write",
                              _STOP + "  // (5) count, scan, write"),)),
    "grid_fill": ("gather", (("  owner_passes(idx + i * NI",
                               "  if (N < 0) owner_passes(idx + i * NI"),)),
    "grid_onecopy": ("gather", (("kFillPiece = 16 << 10;",
                                  "kFillPiece = 1 << 30;"),)),
    "grid_dsmem": ("gather", ((_OWNER, _DSMEM),)),
}


def build(name: str, source: str) -> ctypes.CDLL:
    """``source`` built as its own library under
    ``build/walk_gather_ab/``."""
    from zxc_tpu_torch.buildlib import build_shared
    from zxc_tpu_torch.ops import _build
    d = os.path.join(ROOT, "build", "walk_gather_ab")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    return ctypes.CDLL(build_shared(path, f"ab_{name}",
                                    [_build._nvcc()] + _build.NVCC_FLAGS)[0])


def source(checkout: str, stem: str) -> str:
    with open(os.path.join(checkout, "zxc_tpu_torch", "csrc",
                           f"{stem}.cu")) as f:
        return f.read()


def ablated(name: str) -> str:
    """This checkout's source with ablation ``name``'s substitutions."""
    stem, subs = ABLATIONS[name]
    src = source(ROOT, stem)
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: source text not found: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout with the one-thread walk")
    ap.add_argument("--ablate", action="store_true",
                    help="also time this checkout with a phase taken out")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as S
    import zxc_tpu_torch as Z
    from gen_corpus import gen_corpus
    from zxc_tpu_torch.codec import frame
    from zxc_tpu_torch.ops import encode as ENC, encode_kernels as EK
    from zxc_tpu_torch.ops import probes as P
    if not torch.cuda.is_available():
        S.fail("walk_gather_ab needs a CUDA card")
    print(S.smi_line(), flush=True)
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    enc = build("encode_parent", source(args.parent, "encode"))
    gat = build("gather_parent", source(args.parent, "gather"))
    enc.zxc_parse_walk.restype = ci
    enc.zxc_parse_walk.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    gat.zxc_gather_axis1.restype = ci
    gat.zxc_gather_axis1.argtypes = [vp] * 3 + [ci, ci, i64, ci, i64, vp]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def parent_walk(step):
        B, Pn = step.shape
        cap = Pn // 5 + 1
        nseq = torch.empty(B, dtype=torch.int32, device="cuda")
        pos = torch.empty((B, cap), dtype=torch.int32, device="cuda")
        S.check(enc.zxc_parse_walk(step.data_ptr(), nseq.data_ptr(),
                                   pos.data_ptr(), B, Pn, cap, stream()) == 0,
                "the parent's walk did not launch")
        return nseq, pos

    def parent_grid(x, idx, tile):
        out = torch.empty(idx.shape, dtype=x.dtype, device="cuda")
        S.check(gat.zxc_gather_axis1(x.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), x.shape[0], x.shape[1],
                                     idx.shape[1], x.element_size(), tile,
                                     stream()) == 0,
                "the parent's grid gather did not launch")
        return out

    def walk_with(lib, step):
        """This checkout's walk launched from ``lib``."""
        B, Pn = step.shape
        plan = EK.walk_plan(Pn)
        nseq = torch.empty(B, dtype=torch.int32, device="cuda")
        pos = torch.empty((B, Pn // 5 + 1), dtype=torch.int32, device="cuda")
        bits = torch.empty((B, 2 * plan.words), dtype=torch.int32,
                           device="cuda")
        S.check(lib.zxc_parse_walk(
            step.data_ptr(), nseq.data_ptr(), pos.data_ptr(),
            bits.data_ptr(), None, B, Pn, Pn // 5 + 1, plan.chunk,
            int(plan.shared), plan.smem, EK.WALK_MAX_ROUNDS, stream()) == 0,
            "an ablated walk did not launch")

    def grid_with(lib, x, idx, plan):
        out = torch.empty(idx.shape, dtype=x.dtype, device="cuda")
        S.check(lib.zxc_gather_grid(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), plan.M, plan.N,
            plan.NI, plan.esize, int(plan.form == "cluster"), plan.K,
            plan.clusters, plan.slice, plan.cols, int(plan.vec), plan.smem,
            plan.threads, stream()) == 0,
            "an ablated grid gather did not launch")

    def ablations(prefix, call):
        """Each ablation of ``prefix`` timed between two runs of
        ``call(lib)`` on the change's own library."""
        from zxc_tpu_torch.ops import _build
        for name in (n for n in ABLATIONS if n.startswith(prefix)):
            lib = build(name, ablated(name))
            (_build._bind_encode if prefix == "walk"
             else _build._bind_gather)(lib, vp, ci)
            own = (_build.encode_kernels() if prefix == "walk"
                   else _build.gather_kernels())
            t = [S.device_ms(lambda L=L: call(L)) for L in (own, lib, own)]
            print(f"  ablation {name}: {t[1]:.4f} ms back to back (change "
                  f"{t[0]:.4f}, {t[2]:.4f})", flush=True)

    def ab(name, parent, change, plain, err, extra=()):
        for fn, who in ((parent, "parent"), (change, "change")):
            S.check(err(fn(), plain()) == 0, f"{name}: the {who} differs "
                    "from the plain version")
        times = [S.device_ms(f) for f in (parent, change, change, parent)]
        more = "".join(f", {k} {S.device_ms(f):.4f}" for k, f in extra)
        print(f"{name}: back to back ms parent {times[0]:.4f}, change "
              f"{times[1]:.4f}, change {times[2]:.4f}, parent {times[3]:.4f}"
              f"{more}", flush=True)

    BLOCK = S.BLOCK
    data = gen_corpus(32 << 20)
    params = frame.level_params(3)
    grp = torch.from_numpy(np.frombuffer(data, np.uint8, 16 * BLOCK).reshape(
        16, BLOCK).copy()).cuda()
    lens = ENC.find_matches_device_lcp_batch(grp, params.n_candidates)[0]
    steps = {"corpus L3": ENC.walk_steps(lens, params.lazy, params.min_emit),
             "all 5": torch.full((16, BLOCK), 5, dtype=torch.int32,
                                 device="cuda")}
    for mode, step in steps.items():
        ab(f"parse_walk {mode}", lambda s=step: parent_walk(s),
           lambda s=step: EK.parse_walk(s),
           lambda s=step: EK.parse_walk_reference(s), S.walk_err)
        if args.ablate:
            ablations("walk", lambda L, s=step: walk_with(L, s))
    M, N, NI, T = S.GRID_SHAPE
    x, idx = S.gather_inputs(1, M, N, NI)
    idx64 = idx.long()
    ab("gather_grid", lambda: parent_grid(x, idx, T),
       lambda: P.gather_grid(x, idx, T),
       lambda: P.gather_axis1_reference(x, idx),
       lambda a, b: int((a - b).abs().max()),
       extra=(("torch.gather", lambda: torch.gather(x, 1, idx64)),))
    if args.ablate:
        plan = P.gather_grid_plan(x, idx, torch.empty_like(idx))
        ablations("grid", lambda L: grid_with(L, x, idx, plan))
        l2 = P.l2_plan(M, N, NI, 4, True, 256, 1)
        from zxc_tpu_torch.ops import _build
        print(f"  the L2 form at the probe's shape: "
              f"{S.device_ms(lambda: grid_with(_build.gather_kernels(), x, idx, l2)):.4f}"
              " ms back to back", flush=True)

    mine = hashlib.sha256(Z.ops.compress_device(
        data[:4 << 20], level=3, block_size=BLOCK)).hexdigest()
    r = subprocess.run([sys.executable, "-c", ARCHIVE], cwd=args.parent,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=args.parent))
    S.check(r.returncode == 0, f"the parent's compress_device failed: "
            f"{r.stderr[-2000:]}")
    theirs = r.stdout.strip().splitlines()[-1]
    print(f"compress_device, first 4 MiB, level 3: sha256 change {mine}, "
          f"parent {theirs}", flush=True)
    S.check(mine == theirs, "compress_device archives differ from the "
            "parent's")
    print("walk_gather_ab: ok", flush=True)


if __name__ == "__main__":
    main()
