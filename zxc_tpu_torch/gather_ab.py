"""Times the row-wise gather (``gather_axis1`` at the six shapes of
``tools/tpu_pallas_gather_probe.py``), the grid gather (``gather_grid``)
and form b of the row gather (``dma_b``) of this checkout against another
checkout's on one NVIDIA card, with variants of this checkout's kernels.

    python3 -m zxc_tpu_torch.gather_ab --parent DIR [--out FILE]

Builds this checkout's ``csrc/gather.cu``, variants of it (below) and the
source of the checkout at DIR (for example ``git archive`` of the parent
commit unpacked under ``build/``), each as its own library, in parallel;
the entries are called with the arguments their signatures name, so the
parent's ``zxc_gather_axis1`` runs as it was. Inputs: random int32 tables
(values 0-99) and uint8 tables (0-255) with indices inside the row, from
numpy seeds, at the probe's shapes: x (8, 8K), (8, 64K), (8, 512K), (64,
64K), (256, 8K) int32 and (8, 64K) uint8, each with a square index; the
grid gather at ``chip_smoke.GRID_SHAPE`` (x (8, 64K), idx (8, 512K)); the
row gather at ``chip_smoke.DMA_SHAPE`` (table (4096, 128), 1,024 rows).
Each runs in the order parent, change, change, parent, every output equal
to its plain version, beside ``torch.gather`` / ``torch.index_select`` on
an int64 index made beforehand. Times: one CUDA-event pair around 20
calls queued behind a spin (``chip_smoke.device_ms``); each number is the
median of 3 such.

Variants, this checkout only:

* at every shape (and at x (8, 64K) with idx (8, 128K) and (8, 256K),
  where the index reads each row element 2 and 4 times over): the plan
  ``grid_plan`` ships, the cluster form (its clusters a row as the rule
  sets them, and as many as fill the SMs) and the L2 form at CTAs of 64,
  128, 256 and 512 threads, each 1, 2, 4 or 8 passes of 16 columns a
  thread (``GridPlan``s built here);
* the L2 form at (8, 512K) in the shipped geometry with the table reads
  under an L2 evict-last policy (``evict_last``), with a bulk L2 prefetch
  of each CTA's share of its row first (``prefetch``) and with 32 columns
  a thread (``cols32``, ``kGridL2Cols``), text substitutions of
  ``gather.cu``; a cluster of 16 CTAs of 128 KiB holding the whole row
  (``kMaxCluster`` 16, the non-portable cluster size allowed); and the
  shipped kernel on other indices: each row's first eighth (a 2 MiB
  table) and idx[i, j] = j (the streams alone; outputs not compared);
* ``dma_b`` at 1, 2, 4, 8, 16 and 32 rows (warps) a CTA, and ``empty``:
  the same grid and index loads, no copy (output not compared).

Prints the card's name and power limit first, the ptxas lines of this
checkout's kernels, a line a measurement, and one JSON object last (also
written to ``--out``). Needs a CUDA card; exits 1 without one. An edit
of the substituted source lines makes it stop with "source text not
found".
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zxc_tpu_torch.lcp_merge_ab import Lib, median_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("zxc_tpu_torch", "csrc", "gather.cu")
# the probe's shapes: (M, N, dtype), each with idx (M, N)
SHAPES = ((8, 1 << 13, np.int32), (8, 1 << 16, np.int32),
          (8, 1 << 19, np.int32), (64, 1 << 16, np.int32),
          (256, 1 << 13, np.int32), (8, 1 << 16, np.uint8))
BIG = 2                              # (8, 512K): the L2 form's shape
L2_SHAPES = (0, 1, 2, 3, 4, 5)       # the shapes of the L2 form's variants
ROWS_SWEEP = (1, 2, 4, 8, 16, 32)
# the L2 form's geometries swept at every shape: threads a CTA and passes
# of threads * 16 columns a CTA
L2_PASSES = (1, 2, 4, 8)
# the cluster form against the L2 form where the index reads each row
# element 2 and 4 times over (x (8, 64K), idx (8, 128K) and (8, 256K))
READS = (2, 4)
_ROW = """  __device__ __forceinline__ T operator()(int k) const {
    return (unsigned)k < (unsigned)N ? __ldg(x + k) : T(0);
  }"""
# evict_last: the table reads under an L2 evict-last policy
_EVICT_LAST = """  __device__ __forceinline__ T operator()(int k) const {
    uint64_t pol;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
    if ((unsigned)k >= (unsigned)N) return T(0);
    uint32_t v;
    if constexpr (sizeof(T) == 4)
      asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
          : "=r"(v) : "l"(x + k), "l"(pol));
    else
      asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
          : "=r"(v) : "l"(x + k), "l"(pol));
    return (T)v;
  }"""
_L2_ROW = "  const GlobalTableRow<T> row{x + i * N, N};"
# prefetch: thread 0 of each CTA first prefetches the CTA's share of row i
# into L2 by bulk prefetches of up to 16 KiB
_PREFETCH = """  if (threadIdx.x == 0) {
    const unsigned long long r = (unsigned long long)(x + i * N);
    const long long bytes = (long long)N * sizeof(T);
    const long long share = (bytes + gridDim.x - 1) / gridDim.x;
    const unsigned long long hi =
        (r + min(bytes, (long long)(blockIdx.x + 1) * share)) & ~15ull;
    for (unsigned long long a = (r + blockIdx.x * share + 15) & ~15ull;
         a < hi; a += 16384)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                   :: "l"(a), "r"((unsigned)min(16384ull, hi - a))
                   : "memory");
  }
"""
# source variants of the L2 form: (substitutions, constants)
L2_VARIANTS = {
    "evict_last": (((_ROW, _EVICT_LAST),), {}),
    "prefetch": (((_L2_ROW, _PREFETCH + _L2_ROW),), {}),
    "cols32": ((), {"kGridL2Cols": "32"}),
}
_CONST = r"(constexpr \w+ {name} = )([^;]+);"
_LAUNCH = "  cudaLaunchConfig_t cfg = {};"
_NONPORTABLE = """  e = cudaFuncSetAttribute(gather_grid_cluster_kernel<T>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
"""
_COPY = ("  copy_row<kVec>(table + (ok ? (long long)r * C : 0), out + g * C, "
         "C, ok,")


def substituted(src: str, label: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"gather_ab: {label}: source text not found: "
                             f"{old!r}")
        src = src.replace(old, new, 1)
    return src


def with_constants(src: str, label: str, values: dict) -> str:
    """``src`` with each constant of ``values`` set to its value."""
    for name, value in values.items():
        pat = re.compile(_CONST.format(name=name))
        if not pat.search(src):
            raise SystemExit(f"gather_ab: {label}: source text not found: "
                             f"constexpr {name}")
        src = pat.sub(lambda m: f"{m.group(1)}{value};", src, count=1)
    return src


def grid_call(lib: Lib, x, idx, plan):
    def call():
        out = torch.empty(idx.shape, dtype=x.dtype, device="cuda")
        lib.call("zxc_gather_grid", x=x.data_ptr(), idx=idx.data_ptr(),
                 out=out.data_ptr(), M=plan.M, N=plan.N, NI=plan.NI,
                 esize=plan.esize, form=int(plan.form == "cluster"),
                 K=plan.K, clusters=plan.clusters, slice=plan.slice,
                 cols=plan.cols, vec=int(plan.vec), smem=plan.smem,
                 threads=plan.threads)
        return out
    return call


def axis1_call(lib: Lib, x, idx):
    """The earlier entry of the row-wise gather, ``zxc_gather_axis1``."""
    def call():
        out = torch.empty(idx.shape, dtype=x.dtype, device="cuda")
        lib.call("zxc_gather_axis1", x=x.data_ptr(), idx=idx.data_ptr(),
                 out=out.data_ptr(), M=x.shape[0], N=x.shape[1],
                 NI=idx.shape[1], esize=x.element_size())
        return out
    return call


def rows_call(lib: Lib, table, idx, plan):
    def call():
        out = torch.empty((len(idx), table.shape[1]), dtype=torch.int32,
                          device="cuda")
        lib.call("zxc_gather_rows", table=table.data_ptr(), R=len(table),
                 C=table.shape[1], idx=idx.data_ptr(), G=len(idx),
                 out=out.data_ptr(), form=1, grid=plan.grid,
                 rows_per_cta=plan.rows_per_cta, piece=plan.piece,
                 stages=plan.stages, bulk=int(plan.bulk), smem=plan.smem)
        return out
    return call


def cluster_plan(P, M: int, N: int, NI: int, esize: int, sms: int,
                 fill: bool):
    """The cluster form at the row's K: ``grid_plan``'s clusters a row
    (enough to fill ``sms`` SMs with at least one pass of 16 columns a
    thread each), or with ``fill`` as many as fill the SMs with at least
    1,024 columns each; None where a row needs more than 8 CTAs."""
    v = 16 // esize
    K = 1
    while K <= P.GRID_MAX_CLUSTER and -(-N // K) * esize > P.GRID_MAX_SLICE:
        K *= 2
    if N == 0 or K > P.GRID_MAX_CLUSTER:
        return None
    slice_ = -(-(-(-N // K)) // v) * v
    per = P.GRID_THREADS * (1 if fill else P.GRID_COLS)
    clusters = max(1, min(sms // max(1, M * K), -(-NI // per)))
    return P.GridPlan(M, N, NI, esize, "cluster", K, clusters, slice_,
                      -(-NI // clusters), False, slice_ * esize,
                      P.GRID_THREADS)


def l2_geometries(P, M: int, N: int, NI: int, esize: int) -> dict:
    """The swept L2 geometries: label -> plan; more passes only where a
    CTA's columns stay within the row."""
    out = {}
    for threads in P.GRID_L2_THREADS:
        for passes in L2_PASSES:
            if passes == 1 or threads * P.GRID_L2_COLS * passes <= NI:
                out[f"l2 {threads}x{passes}"] = P.l2_plan(
                    M, N, NI, esize, True, threads, passes)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of another "
                    "checkout")
    ap.add_argument("--out", help="also write the JSON object here")
    opts = ap.parse_args()
    sys.path[:0] = [ROOT]
    import chip_smoke as S
    if not torch.cuda.is_available():
        S.fail("gather_ab needs a CUDA card")
    smi = S.smi_line()
    print(f"card: {smi}", flush=True)
    from zxc_tpu_torch.ops import probes as P
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    with open(os.path.join(ROOT, SRC)) as f:
        mine = f.read()
    with open(os.path.join(opts.parent, SRC)) as f:
        sources = {"change": mine, "parent": f.read()}
    for label, (subs, values) in L2_VARIANTS.items():
        sources[f"l2 {label}"] = with_constants(
            substituted(mine, label, subs), label, values)
    sources["cluster16"] = substituted(
        with_constants(mine, "cluster16", {"kMaxCluster": "16"}),
        "cluster16", ((_LAUNCH, _NONPORTABLE + _LAUNCH),))
    sources["rows empty"] = substituted(
        mine, "rows empty", ((_COPY, "  if (r == -2147483647) "
                              + _COPY[2:]),))
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(
            lambda kv: Lib(*kv, subdir="gather_ab"), sources.items())))
    for line in libs["change"].log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas (change): {line.strip()}", flush=True)
    result = {"card": smi, "sms": sms, "ab": {}, "plan": {}, "bound_ms": {},
              "library": {}, "forms": {}, "l2_variants": {},
              "l2_inputs": {}, "rows": {}}

    def equal(name, call, want):
        S.check(torch.equal(call(), want), f"{name} differs from the plain "
                "version")

    def ab(name, calls, want, library):
        """parent, change, change, parent; both equal to ``want``."""
        for who, call in calls.items():
            equal(f"{name}: the {who}", call, want)
        times = {}
        for who in ("parent", "change", "change", "parent"):
            times.setdefault(who, []).append(median_ms(calls[who]))
        result["ab"][name] = times
        result["library"][name] = median_ms(library)
        print(f"{name}: back to back ms parent {times['parent'][0]:.4f}, "
              f"change {times['change'][0]:.4f}, change "
              f"{times['change'][1]:.4f}, parent {times['parent'][1]:.4f}; "
              f"library {result['library'][name]:.4f}; bound "
              f"{result['bound_ms'][name]:.6f}", flush=True)

    def timed(name, table: dict, calls: dict, want, compared=True):
        out = {}
        for label, call in calls.items():
            if compared:
                equal(f"{name} {label}", call, want)
            out[label] = median_ms(call)
        table[name] = out
        print(f"{name}, ms back to back: " + "; ".join(
            f"{k} {v:.4f}" for k, v in out.items()), flush=True)

    def forms(name, x, idx, plan, want):
        """The shipped plan, the cluster form (grid_plan's rule and
        filling the SMs) and the swept L2 geometries, on the change."""
        (M, N), NI, esize = x.shape, idx.shape[1], x.element_size()
        plans = {"shipped": plan}
        rule = cluster_plan(P, M, N, NI, esize, sms, False)
        fill = cluster_plan(P, M, N, NI, esize, sms, True)
        for label, cp in (("cluster", rule), ("cluster fill", fill)):
            if cp is not None and (label == "cluster" or cp != rule):
                plans[f"{label} K={cp.K} x{cp.clusters}"] = cp
        plans.update(l2_geometries(P, M, N, NI, esize))
        timed(name, result["forms"], {
            k: grid_call(libs["change"], x, idx, p)
            for k, p in plans.items()}, want)

    # -- gather_axis1 at the probe's shapes, and its forms --------------------
    for k, (M, N, dt) in enumerate(SHAPES):
        x, idx = S.gather_inputs(10 + k, M, N, N, dt)
        name = f"gather_axis1 ({M}, {N}) {np.dtype(dt).name}"
        want = P.gather_axis1_reference(x, idx)
        result["bound_ms"][name] = (P.gather_bytes_moved(x, idx)
                                    / S.HBM_BYTES_PER_S * 1e3)
        plan = P.gather_grid_plan(x, idx, torch.empty_like(want))
        result["plan"][name] = plan._asdict()
        print(f"{name}: {plan}", flush=True)
        idx64 = idx.long()
        ab(name, {"parent": axis1_call(libs["parent"], x, idx),
                  "change": grid_call(libs["change"], x, idx, plan)}, want,
           lambda: torch.gather(x, 1, idx64))
        forms(name, x, idx, plan, want)
        if k != BIG:
            continue
        esize = x.element_size()
        calls = {"change": grid_call(libs["change"], x, idx, plan)}
        for label in L2_VARIANTS:        # the same CTAs and columns
            calls[label] = grid_call(libs[f"l2 {label}"], x, idx, plan)
        timed(name, result["l2_variants"], calls, want)
        # the same kernel on other indices: within each row's first
        # eighth (a 2 MiB table), and idx[i, j] = j (the streams alone)
        near = torch.remainder(idx, N // 8)
        seq = torch.arange(N, dtype=torch.int32, device="cuda").expand(
            M, N).contiguous()
        timed(f"{name} other indices", result["l2_inputs"], {
            "first eighth": grid_call(libs["change"], x, near, plan),
            "sequential": grid_call(libs["change"], x, seq, plan)}, None,
            compared=False)
        c16 = P.GridPlan(M, N, N, esize, "cluster", 16, 1, N // 16, N,
                         False, N // 16 * esize, P.GRID_THREADS)
        try:
            timed(f"{name} cluster of 16", result["l2_variants"],
                  {"cluster16": grid_call(libs["cluster16"], x, idx, c16)},
                  want)
        except RuntimeError as e:       # a refused launch
            result["l2_variants"][f"{name} cluster of 16"] = str(e)
            print(f"{name} cluster of 16: {e}", flush=True)

    # -- gather_grid at the probe's grid shape --------------------------------
    M, N, NI, T = S.GRID_SHAPE
    x, idx = S.gather_inputs(1, M, N, NI)
    want = P.gather_axis1_reference(x, idx)
    plan = P.gather_grid_plan(x, idx, torch.empty_like(want))
    name = f"gather_grid ({M}, {N}) idx ({M}, {NI})"
    result["bound_ms"][name] = (P.gather_bytes_moved(x, idx)
                                / S.HBM_BYTES_PER_S * 1e3)
    result["plan"][name] = plan._asdict()
    print(f"{name}: {plan}", flush=True)
    idx64 = idx.long()
    ab(name, {"parent": grid_call(libs["parent"], x, idx, plan),
              "change": grid_call(libs["change"], x, idx, plan)}, want,
       lambda: torch.gather(x, 1, idx64))
    forms(name, x, idx, plan, want)
    for reads in READS:
        x, idx = S.gather_inputs(20 + reads, M, N, reads * N)
        plan = P.gather_grid_plan(x, idx, torch.empty_like(idx))
        forms(f"x ({M}, {N}) idx ({M}, {reads * N})", x, idx, plan,
              P.gather_axis1_reference(x, idx))

    # -- dma_b ----------------------------------------------------------------
    table, idx = S.dma_inputs()
    G, C = len(idx), table.shape[1]
    want = P.gather_rows_reference(table, idx)
    name = f"dma_b table {tuple(table.shape)} G={G}"
    result["bound_ms"][name] = (P.rows_bytes_moved(table, idx)
                                / S.HBM_BYTES_PER_S * 1e3)
    plan = P.row_plan(G, C, "b")
    parent_plan = P.RowPlan(G, C, G, 1, C, 0, False, 0)
    idx64 = idx.long()
    ab(name, {"parent": rows_call(libs["parent"], table, idx, parent_plan),
              "change": rows_call(libs["change"], table, idx, plan)}, want,
       lambda: torch.index_select(table, 0, idx64))
    timed(name, result["rows"], {
        f"rows {k}": rows_call(libs["change"], table, idx,
                               P.warp_row_plan(G, C, True, k))
        for k in ROWS_SWEEP}, want)
    timed(f"{name} empty", result["rows"], {
        "change": rows_call(libs["change"], table, idx, plan),
        "empty": rows_call(libs["rows empty"], table, idx, plan)}, want,
        compared=False)
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
