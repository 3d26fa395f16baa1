"""Times the lane sum (modes 9-11 and the lane probes) and the piece-serial
kernel (v1-v3) of this checkout against another checkout's on one NVIDIA
card, with ablations of this checkout's two kernels.

    python3 -m zxc_tpu_torch.attic_ab --parent DIR [--out FILE]

Builds this checkout's ``csrc/attic.cu``, text substitutions of it (below)
and the source of the checkout at DIR (for example ``git archive`` of the
parent commit unpacked under ``build/``), each as its own library, in
parallel; the entries are called with the arguments their signatures name.
Inputs: the first 16 blocks of the pinned 32 MiB corpus's 64 KiB archive
(``tools/gen_corpus.py``, level 3), resolved as ``ops.decompress`` resolves
them and packed as ``attic.pack_blocks`` (the piece-serial kernel, v1
without and v2/v3 with the fill) and ``pack_blocks_v9/v10/v11`` pack them;
the lane probes (``probes.V10_PROBE_MODES`` and ``V12_ABLATE_MODES``) on
v10's packing; and hand-made worst cases of the same shape: every lane
slot of v10's packing spanning all 128 lanes, windows of 1,024 one-byte
pieces and windows of 1,024 pieces with one start, and one piece spanning
each block. Each runs in the order parent, change, change, parent, every
output equal to its plain version; v1 and v3 also on the first 4 MiB (4
groups, checked, not timed). Times: one CUDA-event pair around 20 calls
queued behind a spin (``chip_smoke.device_ms``); each number is the
median of 3 such.

Ablations, this checkout only (outputs of ``empty`` and ``nolit`` are not
compared):

* lane sum ``empty``: the control loads and the store; ``u1`` / ``u8``:
  the cover's bytes 1 or 8 at a time a lane (4 chosen); ``warps32``: CTAs
  of 32 warps, a tile each; ``cover``: every chunk by cover;
  ``coveronly``: the slot loop taken out of the source (its registers
  too); ``slots``: every chunk by the slot loop (every lane tests every
  slot of its sublane against its 4 lanes, one slot at a time, a slot's
  4 rotated bytes from two aligned words joined by a funnel shift, v9's
  low bytes from int4 loads; the kernel picks it for a chunk whose slots
  cover more than 48 lanes on average); ``slots u4`` / ``slots u8``: 4 or
  8 slots' loads in flight together; ``slots bytes``: 4 byte loads a
  slot; on
  modes 9, 10 and 11's first group, the all-lanes group and the floor
  probe (every lane of every slot);
* piece-serial ``empty``: the launch, the owner map's barriers, its scan
  and the store (no search, stage or literal load); ``nosearch``: each
  window's first piece given (an argument the host computes), the stage
  starting there; ``thread0search``: the earlier form's binary search by
  thread 0 for the window's first piece while the CTA waits, on the new
  stage; ``nolit``: the resolve without the
  literal loads; on the first group (v2) and the worst cases.

Prints the card's name and power limit first, the ptxas lines of this
checkout's kernels (and of ``coveronly``), a line a measurement, and one
JSON object last (also written to ``--out``). Needs a CUDA card; exits 1
without one. An edit of the substituted source lines makes it stop with
"source text not found".
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zxc_tpu_torch.lcp_merge_ab import Lib, median_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("zxc_tpu_torch", "csrc", "attic.cu")
BLOCK, DISPATCH = 64 << 10, 16
WINDOW = 1024

_CHUNK = ("    lane_chunk<kProbe, kV9>(c, vrow, nc, (int)((c0 - b0) & 3), k, "
          "lb, rl,")
_UNROLL = "constexpr int kLaneUnroll = 4;"
_WARPS = "constexpr int kLaneWarps = 8;"
_SEARCH = ("  int r0 = first_candidate(pb, n, w0);   // then the last round's "
           "first")
_LIT = "    v[q] = ok ? (uint32_t)__ldg(lb + idx) : 0u;"
_PIECE_SIG = ("    long long lit_row, uint8_t* __restrict__ out, int block,\n"
              "    int fill_from_s) {")
_PIECE_LAUNCH = ("      npieces, totals, pcs, cap, lit, lit_row, out, block, "
                 "fill_from_s);")
_PIECE_ENTRY = "                     int fill_from_s, void* stream) {"
_SLOT_LANES = "constexpr int kSlotLanes = 48;"
_SLOT_UNROLL = "constexpr int kSlotUnroll = 1;"
_PICK = """  if (total > kSlotLanes * nc)
    slot_bytes<kV9, kProbe != kFloor>(sl, nc, lb, rl, sum);
  else
    cover_bytes<kV9>(sl, len, incl, total, lb, rl, sum);"""
_SLOT_LOADS = """      if (kLoads && kV9) {
        const int4* row = reinterpret_cast<const int4*>(lb) + r * 32;
        q0[u] = __ldg(row + (e >> 2));
        q1[u] = __ldg(row + (((e >> 2) + 1) & 31));
      } else if (kLoads) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(lb) + r * 32;
        w0[u] = __ldg(row + (e >> 2));
        w1[u] = __ldg(row + (((e >> 2) + 1) & 31));
      }
"""
_SLOT_JOIN = """      if (kV9 && kLoads) {
        w0[u] = low_bytes(q0[u]);
        w1[u] = low_bytes(q1[u]);
      }
"""
# bytes: a slot's 4 rotated bytes by 4 byte loads (v9: each int32's low
# byte), packed in place of the two words
_BYTE_LOADS = """      w0[u] = w1[u] = 0u;
      sh[u] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = r * 128 + ((e + q) & 127);
        const uint32_t x = kV9
            ? (uint32_t)__ldg(reinterpret_cast<const int32_t*>(lb) + at)
            : (uint32_t)__ldg(lb + at);
        w0[u] |= (x & 255u) << (8 * q);
      }
"""
_T0 = """  __shared__ int first0;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n;   // the first piece with o > w0
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pb[4 * mid] <= w0) lo = mid + 1; else hi = mid;
    }
    first0 = max(lo - 1, 0);
  }
  __syncthreads();
  int r0 = first0;"""

# name -> substitutions of this checkout's attic.cu
ABLATIONS = {
    "lane empty": ((_CHUNK, "    sum[lane] += c + vrow;\n    if (0) "
                    + _CHUNK[4:]),),
    "lane u1": ((_UNROLL, _UNROLL.replace("4;", "1;")),),
    "lane u8": ((_UNROLL, _UNROLL.replace("4;", "8;")),),
    "lane warps32": ((_WARPS, _WARPS.replace("8;", "32;")),),
    "lane cover": ((_SLOT_LANES, _SLOT_LANES.replace("48;", "1 << 20;")),),
    "lane slots": ((_SLOT_LANES, _SLOT_LANES.replace("48;", "-1;")),),
    "lane coveronly": ((_PICK, "  cover_bytes<kV9>(sl, len, incl, total, "
                               "lb, rl, sum);"),),
    "lane slots u4": ((_SLOT_LANES, _SLOT_LANES.replace("48;", "-1;")),
                      (_SLOT_UNROLL, _SLOT_UNROLL.replace("1;", "4;"))),
    "lane slots u8": ((_SLOT_LANES, _SLOT_LANES.replace("48;", "-1;")),
                      (_SLOT_UNROLL, _SLOT_UNROLL.replace("1;", "8;"))),
    "lane slots bytes": ((_SLOT_LANES, _SLOT_LANES.replace("48;", "-1;")),
                         (_SLOT_LOADS, _BYTE_LOADS), (_SLOT_JOIN, "")),
    "piece empty": ((_SEARCH, "  int r0 = n;"),),
    "piece nosearch": (
        (_SEARCH, "  int r0 = max(i0s[blockIdx.y * gridDim.x + "
                  "blockIdx.x], 0);"),
        (_PIECE_SIG, _PIECE_SIG.replace("fill_from_s)", "fill_from_s, "
                                        "const int32_t* i0s)")),
        (_PIECE_LAUNCH, _PIECE_LAUNCH.replace("fill_from_s);",
                                              "fill_from_s, i0s);")),
        (_PIECE_ENTRY, _PIECE_ENTRY.replace(
            "void* stream", "const int32_t* i0s, void* stream"))),
    "piece thread0search": ((_SEARCH, _T0),),
    "piece nolit": ((_LIT, "    v[q] = ok ? (uint32_t)idx : 0u;"),),
}
UNCOMPARED = ("lane empty", "piece empty", "piece nolit")


def ablated(name: str) -> str:
    """This checkout's source with ablation ``name``'s substitutions."""
    with open(os.path.join(ROOT, SRC)) as f:
        src = f.read()
    for old, new in ABLATIONS[name]:
        if old not in src:
            raise SystemExit(f"attic_ab: {name}: source text not found: "
                             f"{old!r}")
        src = src.replace(old, new, 1)
    return src


def piece_call(lib: Lib, args, fill: bool, i0s=None):
    npieces, totals, pcs, lit8 = args

    def call():
        B = pcs.shape[0]
        out = torch.empty((B, BLOCK), dtype=torch.uint8, device="cuda")
        lib.call("zxc_piece_serial", npieces=npieces.data_ptr(),
                 totals=totals.data_ptr(), pcs=pcs.data_ptr(),
                 cap=pcs.shape[1] * 32, lit=lit8.data_ptr(),
                 lit_row=lit8.shape[1] * 128, out=out.data_ptr(), B=B,
                 block=BLOCK, fill_from_s=int(fill),
                 i0s=0 if i0s is None else i0s.data_ptr())
        return out
    return call


def lane_call(lib: Lib, group, probe: int = 0):
    mode, ts, rows, pctrl, lit, layers = group

    def call():
        B = pctrl.shape[0]
        out = torch.empty((B, BLOCK), dtype=torch.uint8, device="cuda")
        common = dict(ts=0 if ts is None else ts.data_ptr(),
                      pctrl=pctrl.data_ptr(), g32=pctrl.shape[1],
                      lit=lit.data_ptr(), rl=lit.shape[1],
                      out=out.data_ptr(), B=B, block=BLOCK)
        if probe:
            lib.call("zxc_lane_sum_probe", probe=probe, **common)
        else:
            lib.call("zxc_lane_sum", rows=0 if rows is None
                     else rows.data_ptr(), rows_len=0 if rows is None
                     else rows.shape[1], mode=mode, layers=layers, **common)
        return out
    return call


def lane_plain(group, probe: str | None = None):
    from zxc_tpu_torch.ops import attic as AT
    mode, ts, rows, pctrl, lit, layers = group
    return lambda: AT.lane_sum_reference(pctrl, lit, BLOCK, mode, ts=ts,
                                         rows=rows, layers=layers,
                                         probe=probe)


def first_pieces(pcs: np.ndarray, npieces: np.ndarray) -> np.ndarray:
    """Each window's first piece (the last with o <= w0, -1 for none),
    (B, BLOCK / 1024) int32: ``nosearch``'s argument."""
    B = len(pcs)
    o = pcs.reshape(B, -1, 4)[..., 0]
    w0 = np.arange(BLOCK // WINDOW) * WINDOW
    return np.stack([np.searchsorted(o[b, :max(int(npieces[b]), 0)], w0,
                                     side="right") - 1
                     for b in range(B)]).astype(np.int32)


def piece_worst_cases(lits, RL: int, seed: int = 0) -> dict:
    """Hand-made piece groups of DISPATCH blocks: windows of 1,024
    one-byte pieces alternating with windows of 1,024 pieces that all
    start at the window's first byte (the last one covers it), and one
    piece spanning each block; random c, s and k, packed as
    ``pack_blocks`` packs them."""
    from zxc_tpu_torch.ops import attic as AT
    rng = np.random.default_rng(seed)
    nw = BLOCK // WINDOW
    w0 = np.arange(nw) * WINDOW
    po = np.where((np.arange(nw) % 2)[:, None] == 0,
                  w0[:, None] + np.arange(WINDOW), w0[:, None]).reshape(-1)
    groups = {}
    for label, o in (("1,024 pieces a window", po),
                     ("one piece a block", np.zeros(1, np.int64))):
        m = len(o)
        pieces = [(o.astype(np.int32),
                   rng.integers(0, 4000, m).astype(np.int32),
                   (o + rng.integers(-100, 100, m)).astype(np.int32),
                   rng.choice([1, 3, 64, 500], m).astype(np.int32))
                  for _ in range(DISPATCH)]
        groups[label] = AT.pack_blocks(pieces, lits, [BLOCK] * DISPATCH,
                                       BLOCK)[0]
    return groups


def all_lanes(pctrl: np.ndarray) -> np.ndarray:
    """v10's control with every live slot spanning lanes 0-127 (s 0,
    e1 127), rows and rotations kept."""
    c = pctrl.astype(np.int64) & 0xFFFFFFFF
    live = ((c >> 7) & 127) <= ((c >> 14) & 127)
    full = (c & 127) | (127 << 14) | (c >> 21 << 21)
    return np.where(live, full, c).astype(np.uint32).view(np.int32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of another "
                    "checkout")
    ap.add_argument("--out", help="also write the JSON object here")
    opts = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import chip_smoke as S
    if not torch.cuda.is_available():
        S.fail("attic_ab needs a CUDA card")
    smi = S.smi_line()
    print(f"card: {smi}", flush=True)
    import zxc_tpu_torch as Z
    from gen_corpus import gen_corpus
    from zxc_tpu_torch.ops import attic as AT, batch as BT, probes as P
    from zxc_tpu_torch.ops import serial

    sources = {}
    for who, root in (("change", ROOT), ("parent", opts.parent)):
        with open(os.path.join(root, SRC)) as f:
            sources[who] = f.read()
    sources.update((name, ablated(name)) for name in ABLATIONS)
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(
            lambda kv: Lib(*kv, subdir="attic_ab"), sources.items())))
    for who in ("change", "lane coveronly"):
        for line in libs[who].log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas ({who}): {line.strip()}", flush=True)
    result = {"card": smi, "ab": {}, "ablations": {}}

    def ab(name, call_of, plain):
        """parent, change, change, parent; both equal to ``plain``."""
        calls = {w: call_of(libs[w]) for w in ("parent", "change")}
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

    def ablate(kind, name, call_of, plain):
        """This checkout's kernel and each of ``kind``'s ablations on one
        group (``call_of(lib)``), each compared with ``plain`` unless it
        takes a step out."""
        out = {"change": median_ms(call_of(libs["change"]))}
        want = plain()
        for abl in ABLATIONS:
            if not abl.startswith(kind + " "):
                continue
            label, call = abl.split(" ", 1)[1], call_of(libs[abl])
            if abl not in UNCOMPARED:
                S.check(torch.equal(call(), want), f"{name} {label} differs "
                        "from the plain version")
            out[label] = median_ms(call)
        result["ablations"][name] = out
        print(f"{name} ablations, ms back to back: " + "; ".join(
            f"{k} {v:.4f}" for k, v in out.items()), flush=True)

    # -- inputs ---------------------------------------------------------------
    data = gen_corpus(32 << 20)
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=BLOCK,
                                        threads=os.cpu_count() or 1))
    plan = BT.plan_frame(arc)
    first = slice(0, 4 * DISPATCH)
    sub = BT.FramePlan(plan.block_size, ll=plan.ll[first], ml=plan.ml[first],
                       off=plan.off[first], lit=plan.lit[first],
                       totals=plan.totals[first], dict_buf=plan.dict_buf)
    pieces4, lits4 = BT.resolve_serial(sub)
    totals4 = list(sub.totals)
    g = slice(0, DISPATCH)
    pieces, lits, totals = pieces4[g], lits4[g], totals4[g]

    # -- the piece-serial kernel ----------------------------------------------
    def cuda(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]

    host = AT.pack_blocks(pieces, lits, totals, BLOCK)[0]
    pgroups = {"first group": host}
    pgroups.update(piece_worst_cases(lits, host[3].shape[1]))
    for label, h in pgroups.items():
        args = cuda(h)
        i0s = torch.from_numpy(first_pieces(h[2], h[0])).cuda()
        for fill in ((False, True) if label == "first group" else (True,)):
            v = "v1" if not fill else "v2/v3"

            def plain(a=args, f=fill):
                return AT.piece_serial_reference(*a, block=BLOCK,
                                                 fill_from_s=f)
            ab(f"piece_serial {v} {label}",
               lambda L, a=args, f=fill: piece_call(L, a, f), plain)
            if fill:
                ablate("piece", f"piece_serial {label}",
                       lambda L, a=args, i=i0s: piece_call(L, a, True, i),
                       plain)
    for fill in (False, True):          # v1 and v3 over the first 4 MiB
        for h in AT.pack_groups(pieces4, lits4, totals4, BLOCK, DISPATCH):
            args = cuda(h)
            S.check(torch.equal(piece_call(libs["change"], args, fill)(),
                                AT.piece_serial_reference(
                                    *args, block=BLOCK, fill_from_s=fill)),
                    f"piece_serial fill={fill} differs on the first 4 MiB")
    print("piece_serial v1 and v3 on the first 4 MiB: equal to the plain "
          "version", flush=True)

    # -- the lane sum ---------------------------------------------------------
    nb, ts, rows, pctrl9, lit32 = AT.pack_blocks_v9(pieces, lits, totals,
                                                    BLOCK)
    _, ts10, pctrl10, lit8 = AT.pack_blocks_v10(pieces, lits, totals, BLOCK)
    layers = AT.v11_layers(serial.lane_ops_blocks(pieces, totals))
    pctrl11, lit11 = AT.pack_blocks_v11(pieces, lits, totals, BLOCK,
                                        LAYERS=layers)
    lgroups = {
        "mode 9": (9, *cuda((ts, rows, pctrl9, lit32)), 0),
        "mode 10": (10, *cuda((ts10,)), None, *cuda((pctrl10, lit8)), 0),
        "mode 11": (11, None, None, *cuda((pctrl11, lit11)), layers),
        "mode 10, every slot all 128 lanes": (
            10, *cuda((ts10,)), None, *cuda((all_lanes(pctrl10), lit8)), 0),
    }
    for label, grp in lgroups.items():
        ab(f"lane_sum {label}", lambda L, g=grp: lane_call(L, g),
           lane_plain(grp))
        ablate("lane", f"lane_sum {label}",
               lambda L, g=grp: lane_call(L, g), lane_plain(grp))
    grp = lgroups["mode 10"]
    ablate("lane", "lane_sum probe floor (every lane of every slot)",
           lambda L: lane_call(L, grp, AT.LANE_PROBES["floor"]),
           lane_plain(grp, "floor"))
    for name, modes in (("v10_probe", P.V10_PROBE_MODES),
                        ("v12_ablate", P.V12_ABLATE_MODES)):
        for m in modes:
            probe = P.lane_probe_kind(name, m, grp[4])
            if probe is None:
                continue
            ab(f"{name} {m}", lambda L, p=probe: lane_call(
                L, grp, AT.LANE_PROBES[p]), lane_plain(grp, probe))
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
