// Copy-engine decode kernels for Hopper (sm_90a): v19, v25, v26, v27, v13,
// the attic's quad-tile generations v12, v14-v17, v20, v21, v23, v24 and
// the ablations of v12's quad body that tools/tpu_v12_ablate2.py times.
//
// Replaces the Pallas kernels of the JAX package:
//   v19: zxc_tpu/ops/pallas_decode.py _make_kernel_v19 / v19_kernel
//   v25: zxc_tpu/ops/pallas_decode.py _make_kernel_v25 / v25_kernel
//   v26: zxc_tpu/ops/pallas_decode.py _make_kernel_v26 / v26_kernel
//   v27: zxc_tpu/ops/pallas_decode.py _make_kernel_v27 / v27_kernel
//   v13: zxc_tpu/ops/pallas_decode.py _kernel_v13 / v13_kernel
//   v12, v14, v15, v16, v17: tools/kernel_attic.py _kernel_v12 / v12_kernel,
//        _kernel_v14 / v14_kernel, ..., _kernel_v17 / v17_kernel
//   v20, v21, v23, v24: tools/kernel_attic.py _make_kernel_v20 /
//        v20_kernel (also the v22 packer's kernel), ..., v24_kernel
//   tools/tpu_v12_ablate2.py make_body / build (modes nopt, statwin, nomm,
//        mmonly; its full mode is v12) and tools/tpu_v13_bisect.py
//        make_body / build (the same function as v12 or, paired, v13: its
//        shifted-iota compares select the same rows, rolls and lanes)
//
// What they compute (the contract, not the TPU formulation). For block b
// and tile t of kRows rows (128; 32 for v13, v12 and v14), a (kRows,128)
// int32 tile starts at 0. The kernel runs the quads of [qs[b,t], qs[b,t+1])
// that the body's loop reaches (Walk below): pairs for v19, v26, v27, v13,
// v15, v17, v21, v23 and v24 (an odd trailing quad is skipped), every quad
// for v12, multiples of 4 for v16, fours then ones for v14. v20 splits a
// supertile at qs[b,2t+1]: the pairs of [qs[b,2t], qs[b,2t+1]) read plane
// 0 only, those of [qs[b,2t+1], qs[b,2t+2]) all K planes. Slot i (0..127)
// of quad q reads, for each plane j < K (K = 1 for v13 and v12-v17), the
// control word
//   w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127], bat = 4q + (i>>5)
// (v23: row (bat>>7)*32K + 32j + (i&31)). Its source row is qbase[b,q] +
// (w_0 >>> 21) (logical shift) and its target row tq[b,q,i] (uint8; int32
// for v13, v12, v14-v17 and v20). Lane l is covered by plane
// j when ((w_j>>7)&127) <= l <= ((w_j>>14)&127); the roll is that of the
// highest covering plane, and a covered lane adds win[src, (l + roll) & 127]
// into tile[tgt, l]. After its quads the tile is stored to output rows
// t*kRows .. t*kRows+kRows-1, reduced mod 256 (uint8: what every consumer
// of the JAX kernel's int32 output does with it; v17's int8 carriers and
// v24's f32 accumulator give the same sums mod 256 on every plan whose sums
// stay below 2^24).
//   v19, v13 and the attic modes: the window is lit8[b] (RLP rows).
//   v26: window rows < RLP are lit8[b]; row RLP + r is this block's own
//        output row r once its supertile has been stored, else 0 (the JAX
//        kernel zeroes that region at block start and appends each tile
//        after it is complete).
//   v27: v26 whose rows < RLP are flat[loff[b] + r] (one ragged lit
//        buffer for the whole group); a row with loff[b] < 0 or
//        loff[b] + r >= ROWS_TOT reads 0.
//   v25: the window is chosen per quad: lit8[b] when qbase[b,q] <
//        OUT_QB_FLAG (1 << 24); else this block's own output, source row
//        qbase[b,q] - OUT_QB_FLAG + (w_0 >>> 21), which reads 0 unless it
//        lies in a supertile already stored (below t*128). The JAX kernel
//        reads whatever its output buffer holds there (INT32_MIN in
//        interpret mode); no packed plan reads such a row.
// The ablations of v12 (32-row tiles, every quad, one plane, int32 tq)
// change one step each: nopt adds slot i into tile row i & 31 (no target
// permute); statwin reads window row (w_0 >>> 21) whatever qbase says;
// nomm has slot i read lit8 row qbase + i (no row gather), adds the 11-bit
// row field to each byte before the roll, and rounds each masked value to
// bf16 (nearest even) before the sum, as the TPU body's bf16 permute does;
// mmonly adds the gathered row unrolled and unmasked into tile row i & 31.
// A slot whose window-relative row exceeds 127, whose source row lies
// outside the window, whose target row lies outside the tile or whose quad
// lies outside [0, MAXQ) contributes nothing, so no control can make the
// kernel read or write outside its buffers or loop past MAXQ quads.
//
// What bounds it on the card: the work is an indexed gather and scatter
// over a few MB per dispatch group (control + windows + output), far
// below both the H100's 3.35 TB/s and its integer rate. The time goes to
// the SMs' issue of each slot's shuffles, masks and shared atomics (about
// 120 instructions a slot of two planes), to the latency of a warp's
// chain of slots where a tile has few, to the SMs a group fills (1024
// threads at 64 registers take an SM's register file, so one CTA an SM)
// and, for v25/v26/v27, to the chain of a block's supertiles through the
// rows they read back (PERF.md, P6).
//
// One slot loop serves every kernel (add_slots): a warp takes an item,
// the 32 slots 32u..32u+31 of batch u of one quad, or a half or quarter
// of them (pass 2 of the grid kernel always; the tile routine when a
// tile's items are fewer than its cluster's warps). Each lane loads its
// slot's control words (planes 0 and 1; planes past kRegPlanes are read
// per slot) and target row in one instruction each, a ballot drops slots
// that add nothing (filler, out-of-range rows and targets, rows the pass
// does not read), and the warp issues kInflight source-row loads (one
// 4-byte word a lane, coalesced) before it rotates each row with two
// shuffles and a funnel shift per plane and adds it into an int32 tile in
// shared memory with atomicAdd, so the add semantics hold exactly for any
// control. The kInflight slots run as straight-line code, with no branch
// between them, so their shuffles overlap. The quads come from a
// contiguous range (the tile routine) or from a list in shared memory
// (the grid kernel).
//
// The tile routine (v19, v13, the attic modes, the ablations: tiled_kernel)
// runs one tile on a cluster of C CTAs (C from copy_engine.tile_plan: more
// than 1 only where B*NT leaves most SMs idle). CTA rank r adds the items
// r, r + C, ... of the tile's walk into its own tile; after a cluster
// barrier it sums rows [r*kRows/C, (r+1)*kRows/C) over the C tiles through
// distributed shared memory in 16-byte reads (mapa, ld.shared::cluster)
// and stores them mod 256; a second barrier keeps each tile alive until
// its peers have read it.
//
// v25/v26/v27 (self_ref_grid_kernel) run one CTA per (supertile, block).
// A supertile depends on earlier ones only through slots that read the
// block's own output. A CTA lists its quads in shared memory by the rows
// their windows reach (one qbase load a quad): list 0 reads lit rows
// (< RLP), list 1 stored output rows (v26/v27: window rows RLP + r; v25:
// flagged quads, whose base is put in v26's coordinates, qbase -
// OUT_QB_FLAG + RLP). It adds list 0's slots (pass 1, no wait), and only if
// list 1 is not empty waits on the ready flags of supertiles 0..t-1 of its
// block and adds list 1's slots (pass 2, reading output rows through L2
// with __ldcg, row r only below t*128); then it stores its tile and
// publishes its own flag (__threadfence + release store; waiters poll with
// acquire loads, and every reader waits on each flag it needs, so a flag
// set without a wait misleads no one). CTAs take (t, b) from an atomic
// ticket in t-major order, so a CTA waits only on CTAs that took smaller
// tickets and are already resident: no deadlock whatever the grid size.
// The ticket and flags live in a per-call scratch the entry zeroes on the
// launch stream. TMA and wgmma are later work.
//
// These replaced two earlier designs (PERF.md, P6, has their times): v25
// on one CTA a block with its supertiles in order, reading earlier ones
// back after a block-wide barrier, and a tile routine that ran one slot at
// a time a warp (control word, row, shuffles, atomics, then the next), one
// CTA a tile.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBytes = 128;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kOutQbFlag = 1 << 24;   // v25: qbase of an output quad
constexpr int kMaxCluster = 8;            // CTAs a tile, the portable size

// The window rows one pass of the slot loop reads: lit8[b]; v27's flat
// buffer from row loff[b]; or the block's stored output (window row RLP + r
// is output row r, readable below t*128)
enum Rows { kLitRows = 0, kFlatRows = 1, kOutRows = 2 };
// tools/tpu_v12_ablate2.py's modes (kNone: the full body)
enum Ablate { kNone = 0, kNoPt = 1, kStatWin = 2, kNoMM = 3, kMMOnly = 4 };
// How a tile walks the quads of a range [q0, q1) (the JAX bodies' loops):
// kOnes, kPairs and kFours run f * floor((q1 - q0) / f) quads from q0, none
// when that is negative (f = 1, 2, 4); kFoursThenOnes (v14) runs
// 4 * floor((q1 - q0) / 4) from q0 and then one at a time from
// q0 + 4 * floor((q1 - q0) / 4) up to q1: every quad of [q0, q1), and for
// q1 < q0 the ((q1 - q0) mod 4) quads just below q1.
enum Walk { kOnes = 1, kPairs = 2, kFours = 4, kFoursThenOnes = 5 };
// Where plane j of slot i of batch bat sits in pctrl: plane-major, row
// j*G32 + 32*(bat>>7) + (i&31); or v23's interleaved rows,
// (bat>>7)*32K + 32j + (i&31). Column bat & 127 in both.
enum Layout { kPlaneMajor = 0, kInterleaved = 1 };

template <typename TQ>
struct Args {
  const int32_t* qs;     // (B, QW): NT+1 columns, 2*NT+1 for a split walk
  const int32_t* qbase;  // (B, MAXQ)
  const int32_t* loff;   // (B,) v27 only
  const int32_t* pctrl;  // (B, K*G32, 128)
  const TQ* tq;          // (B, MAXQ, 128)
  const uint8_t* lit8;   // (B, RLP, 128); v27: flat (ROWS_TOT, 128)
  uint8_t* out;          // (B, NT*kRows, 128); read back by v25/v26/v27
  int NT, QW, MAXQ, G32, K, RLP;
  int64_t rows_tot;      // v27 only
};

// the quads [lo, hi) that a range [q0, q1) runs under walk kWalk
template <int kWalk>
__device__ __forceinline__ void quad_range(int64_t q0, int64_t q1,
                                           int64_t& lo, int64_t& hi) {
  const int64_t d = q1 - q0;
  if (kWalk == kFoursThenOnes) {
    const int64_t n4 = d >> 2;             // floor, as the JAX shift
    lo = q0 + 4 * (n4 < 0 ? n4 : 0);
    hi = q1;
  } else {
    const int64_t n = d >> (kWalk == kOnes ? 0 : kWalk == kPairs ? 1 : 2);
    lo = q0;
    hi = q0 + kWalk * (n < 0 ? 0 : n);
  }
}

template <int kLayout>
__device__ __forceinline__ size_t ctrl_index(int j, int bat, int i, int K,
                                             int G32) {
  const int row = kLayout == kInterleaved
      ? ((bat >> 7) * K + j) * 32 + (i & 31)
      : j * G32 + 32 * (bat >> 7) + (i & 31);
  return (size_t)row * kRowBytes + (bat & 127);
}

// an integer rounded to bf16, nearest even (exact below 2^8)
__device__ __forceinline__ int bf16_round(int v) {
  return (int)__bfloat162float(__float2bfloat16_rn((float)v));
}

constexpr int kRegPlanes = 2;   // control planes a lane holds for its slot
constexpr int kInflight = 8;    // source-row loads a warp keeps in flight
// pass 2 splits each 32-slot batch in 2^kOutLg parts, one a warp (a
// CTA's few output-reading quads are the chain's critical work, so they
// spread over more warps)
constexpr int kOutLg = 2;
// the tile routine splits batches in up to 2^kMaxLg parts when a tile's
// items are fewer than its cluster's warps
constexpr int kMaxLg = 2;
// polls of a ready flag (over 100 ns each) before the kernel traps: a
// wait that long means a fault, not a slow supertile
constexpr int64_t kSpinLimit = int64_t(1) << 28;

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// plane word w of a slot over the warp's source row (lane l holds bytes
// 4l..4l+3): where w covers lane bytes, the rolled bytes replace val's
// and cover marks them (a later plane overrides an earlier one). No
// branch, so the steps of a warp's slots can overlap; a plane that covers
// no lane changes nothing.
__device__ __forceinline__ void apply_plane(uint32_t w, uint32_t word,
                                            int lane, uint32_t& val,
                                            uint32_t& cover) {
  const int lo_l = (w >> 7) & 127;
  const int hi_l = (w >> 14) & 127;
  const int roll = w & 127;
  const int from = lane + (roll >> 2);
  const uint32_t w_lo = __shfl_sync(kFull, word, from & 31);
  const uint32_t w_hi = __shfl_sync(kFull, word, (from + 1) & 31);
  const uint32_t rot = __funnelshift_r(w_lo, w_hi, 8 * (roll & 3));
  // bytes [first, end) of this lane, empty where lo_l > hi_l
  const int first = min(max(lo_l - 4 * lane, 0), 4);
  const int end = max(min(hi_l - 4 * lane + 1, 4), first);
  const uint32_t m = (uint32_t)(((1ull << (8 * end)) - 1)
                                & ~((1ull << (8 * first)) - 1));
  val = (val & ~m) | (rot & m);
  cover |= m;
}

// The quads [lo, lo + n) of one block (the tile routine's walk, clipped to
// [0, MAXQ)); a warp loads its quad's qbase
struct QuadRange {
  const int32_t* qbase;   // the block's row of qbase
  int lo, n;
  __device__ int quad(int k) const { return lo + k; }
  __device__ int64_t base(int k) const { return __ldg(qbase + lo + k); }
};

// The n quads listed in shared memory with their bases in window rows
struct QuadList {
  const int* q;
  const int* qb;
  int n;
  __device__ int quad(int k) const { return q[k]; }
  __device__ int64_t base(int k) const { return qb[k]; }
};

// Adds into the shared tile (kTileRows rows) the slots of the quads of Qs
// whose source rows are window rows of kind kRowsKind, reading nk planes of
// control (kNk: 1 or 2 planes, all in registers; 0: nk planes, planes past
// kRegPlanes read a slot at a time). Items it = first, first + stride, ...
// of 4 << lg per quad: part it % 2^lg of batch (it >> lg) & 3 of quad
// it >> (2 + lg), a part being 32 >> lg slots of the batch. Every branch
// on a slot's values below is taken by the whole warp. No barrier.
template <int kTileRows, int kRowsKind, int kLayout, int kAblate, int kNk,
          typename TQ, typename Quads>
__device__ void add_slots_k(const Args<TQ>& a, int b, int t, const Quads& Qs,
                            int nk, int lg, int first, int stride,
                            int32_t* tile) {
  constexpr int kHeld = kNk == 0 ? kRegPlanes : kNk;   // planes in registers
  const int lane = threadIdx.x & 31;
  const int32_t* pc_b = a.pctrl + (size_t)b * a.K * a.G32 * kRowBytes;
  const TQ* tq_b = a.tq + (size_t)b * a.MAXQ * kRowBytes;
  const int64_t stored = (int64_t)t * 128;
  // lit rows: window row r is row lit_base + r, readable below lit_end
  // (v27: none for a block with loff < 0); output rows: r - RLP
  int64_t lit_base = (int64_t)b * a.RLP;
  int64_t lit_end = lit_base + a.RLP;
  if (kRowsKind == kFlatRows) {
    lit_base = a.loff[b];
    lit_end = lit_base < 0 ? 0 : a.rows_tot;
  }
  const uint8_t* rows = kRowsKind == kOutRows
      ? a.out + (size_t)b * a.NT * 128 * kRowBytes : a.lit8;

  const int items = Qs.n << (2 + lg);
  for (int it = first; it < items; it += stride) {
    const int q = Qs.quad(it >> (2 + lg));
    const int64_t qb = Qs.base(it >> (2 + lg));
    const int u = (it >> lg) & 3;
    const int bat = 4 * q + u;
    const int i = 32 * u + lane;
    uint32_t w[kHeld];
    bool covers = kAblate == kMMOnly || kNk == 0;   // past kHeld: unchecked
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      w[j] = (uint32_t)__ldg(
          pc_b + ctrl_index<kLayout>(j, bat, i, a.K, a.G32));
      covers |= ((w[j] >> 7) & 127) <= ((w[j] >> 14) & 127);
    }
    const int tgt = kAblate == kNoPt || kAblate == kMMOnly
        ? lane : (int)__ldg(tq_b + (size_t)q * kRowBytes + i);
    const uint32_t rowrel = w[0] >> 21;
    const int64_t src = (kAblate == kStatWin ? 0 : qb)
        + (kAblate == kNoMM ? (int64_t)i : (int64_t)rowrel);
    const int64_t row = kRowsKind == kOutRows ? src - a.RLP : lit_base + src;
    const bool readable = kRowsKind == kOutRows
        ? src >= a.RLP && row < stored
        : src >= 0 && src < a.RLP && row >= 0 && row < lit_end;
    unsigned todo = __ballot_sync(
        kFull, covers && (kAblate == kNoMM || rowrel < 128) && tgt >= 0
                   && tgt < kTileRows && readable);
    todo &= (kFull >> (32 - (32 >> lg))) << ((32 >> lg) * (it & ((1 << lg)
                                                                 - 1)));
    const uint32_t my_row = (uint32_t)row;   // < 2^32 wherever readable

    while (todo) {
      // the next kInflight slots: all their rows first, then each slot's
      // rolled, masked bytes and adds, in straight-line code (no branch
      // between the slots, so their steps overlap); a slot index past the
      // last live slot adds nothing
      uint32_t word[kInflight];
      int slot[kInflight];
#pragma unroll
      for (int n = 0; n < kInflight; ++n) {
        slot[n] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const uint32_t r = __shfl_sync(kFull, my_row, max(slot[n], 0));
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            rows + (size_t)r * kRowBytes) + lane;
        word[n] = slot[n] < 0 ? 0u
                  : kRowsKind == kOutRows ? __ldcg(p) : __ldg(p);
      }
#pragma unroll
      for (int n = 0; n < kInflight; ++n) {
        const int s = max(slot[n], 0);
        const int tg = __shfl_sync(kFull, tgt, s);
        uint32_t val = 0, cover = 0;
        if (kAblate == kMMOnly) {   // the gathered row as it is, every lane
          val = word[n];
          cover = kFull;
        } else {
#pragma unroll
          for (int j = 0; j < kHeld; ++j)
            apply_plane(__shfl_sync(kFull, w[j], s), word[n], lane, val,
                        cover);
          if (kNk == 0)
            for (int j = kRegPlanes; j < nk; ++j)
              apply_plane((uint32_t)__ldg(pc_b + ctrl_index<kLayout>(
                              j, bat, 32 * u + s, a.K, a.G32)),
                          word[n], lane, val, cover);
        }
        if (slot[n] < 0) cover = 0;
        const int rr = kAblate == kNoMM
            ? (int)(__shfl_sync(kFull, w[0], s) >> 21) : 0;
        int32_t* trow = tile + tg * kRowBytes + 4 * lane;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int v = (val >> (8 * c)) & 0xff;
          if (kAblate == kNoMM) v = bf16_round(v + rr);
          if (((cover >> (8 * c)) & 0xff) && v) atomicAdd(trow + c, v);
        }
      }
    }
  }
}

// add_slots_k for nk planes of control (1, 2 or more)
template <int kTileRows, int kRowsKind, int kLayout = kPlaneMajor,
          int kAblate = kNone, typename TQ, typename Quads>
__device__ void add_slots(const Args<TQ>& a, int b, int t, const Quads& Qs,
                          int nk, int lg, int first, int stride,
                          int32_t* tile) {
  if (nk == 1)
    add_slots_k<kTileRows, kRowsKind, kLayout, kAblate, 1>(
        a, b, t, Qs, nk, lg, first, stride, tile);
  else if (nk == 2)
    add_slots_k<kTileRows, kRowsKind, kLayout, kAblate, 2>(
        a, b, t, Qs, nk, lg, first, stride, tile);
  else
    add_slots_k<kTileRows, kRowsKind, kLayout, kAblate, 0>(
        a, b, t, Qs, nk, lg, first, stride, tile);
}

// ---- the tile routine: one tile on a cluster of C CTAs ---------------------

__device__ __forceinline__ int4 ld_peer(const int4* p, int rank) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t low_bytes(int4 v) {
  return (uint32_t)(v.x & 0xff) | ((uint32_t)(v.y & 0xff) << 8)
         | ((uint32_t)(v.z & 0xff) << 16) | ((uint32_t)(v.w & 0xff) << 24);
}

// [lo, hi) clipped to [0, MAXQ)
template <typename TQ>
__device__ QuadRange clipped(const Args<TQ>& a, int b, int64_t lo,
                             int64_t hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi < a.MAXQ ? hi : a.MAXQ;
  return {a.qbase + (size_t)b * a.MAXQ, (int)lo, hi > lo ? (int)(hi - lo) : 0};
}

// log2 of the parts a batch is split in: the fewest (1, 2 or 4) that give
// each of the cluster's `stride` warps an item, for a range of n quads
__device__ __forceinline__ int parts_lg(int n, int stride) {
  int lg = 0;
  while (lg < kMaxLg && (n << (2 + lg)) < stride) ++lg;
  return lg;
}

// Grid (NT * C, B), clusters of (C, 1, 1): CTA rank r of tile t's cluster
// clears its int32 tile, adds the items r, r + C, ... of the tile's walk
// (kSplit, v20: the pair-floored [qs[2t], qs[2t+1]) with plane 0 only,
// then the pair-floored [qs[2t+1], qs[2t+2]) with all K planes; else
// [qs[t], qs[t+1]) under kWalk), and stores rows [r*kRows/C,
// (r+1)*kRows/C) of the cluster's sum mod 256.
template <int kRows, typename TQ, int kWalk = kPairs,
          int kLayout = kPlaneMajor, bool kSplit = false, int kAblate = kNone>
__global__ void __launch_bounds__(kThreads) tiled_kernel(Args<TQ> a, int C) {
  extern __shared__ int4 tile4[];
  int32_t* tile = reinterpret_cast<int32_t*>(tile4);
  const int b = blockIdx.y;
  const int t = blockIdx.x / C;
  const int r = blockIdx.x % C;   // the CTA's rank in its cluster
  for (int k = threadIdx.x; k < kRows * kRowBytes / 4; k += blockDim.x)
    tile4[k] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int32_t* qs_b = a.qs + (size_t)b * a.QW;
  const int first = (threadIdx.x >> 5) * C + r;
  const int stride = (blockDim.x >> 5) * C;
  int64_t lo, hi;
  if (kSplit) {
    quad_range<kPairs>(qs_b[2 * t], qs_b[2 * t + 1], lo, hi);
    const QuadRange plane0 = clipped(a, b, lo, hi);
    add_slots<kRows, kLitRows, kLayout, kAblate>(
        a, b, t, plane0, 1, parts_lg(plane0.n, stride), first, stride, tile);
    quad_range<kPairs>(qs_b[2 * t + 1], qs_b[2 * t + 2], lo, hi);
  } else {
    quad_range<kWalk>(qs_b[t], qs_b[t + 1], lo, hi);
  }
  const QuadRange range = clipped(a, b, lo, hi);
  const int lg = parts_lg(range.n, stride);
  add_slots<kRows, kLitRows, kLayout, kAblate>(a, b, t, range, a.K, lg, first,
                                               stride, tile);

  // every rank's adds are done (C = 1: the CTA's)
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();
  const int part = kRows * kRowBytes / 4 / C;   // int4 of the rank's rows
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      a.out + ((size_t)b * a.NT * kRows + (size_t)t * kRows) * kRowBytes)
      + r * part;
  for (int k = threadIdx.x; k < part; k += blockDim.x) {
    int4 s = tile4[r * part + k];
    for (int p = 1; p < C; ++p) {
      const int4 v = ld_peer(tile4 + r * part + k, (r + p) % C);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dst[k] = low_bytes(s);
  }
  if (C > 1) cg::this_cluster().sync();   // peers still read this tile
}

template <typename TQ>
int launch_tiles(void (*kernel)(Args<TQ>, int), int rows, const Args<TQ>& a,
                 int B, int C, void* stream) {
  if (C < 1 || C > kMaxCluster || rows % C) return (int)cudaErrorInvalidValue;
  const int smem = rows * kRowBytes * 4;   // int32 tile
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.NT * C), (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- v25/v26/v27: one CTA per (supertile, block) ---------------------------

constexpr int kChunk = kThreads;   // quads a CTA lists in one scan

// One scan's quads by the rows their windows reach: list 0 (pass 1) those
// reaching lit rows (qbase < RLP), list 1 (pass 2) those reaching stored
// output rows, with their bases in window rows (output row r at RLP + r).
struct QuadLists {
  int n[2];
  int q[2][kChunk];
  int qb[2][kChunk];
};

// Lists the quads [c0, min(c0 + kChunk, qhi)) of block b for supertile t:
// one qbase load a thread; ends with a barrier. v26/v27: list 1 holds the
// quads whose window rows [qb, qb + 127] reach RLP .. RLP + t*128 - 1 (a
// quad may be on both lists). kQuadFlag (v25): list 1 holds the flagged
// quads (qbase >= OUT_QB_FLAG) whose first output row qbase - OUT_QB_FLAG
// lies below t*128, at base qbase - OUT_QB_FLAG + RLP; a flagged quad is
// never on list 0, and an unflagged quad whose window passes RLP reads
// only its rows below RLP.
template <bool kQuadFlag>
__device__ void list_quads(const Args<uint8_t>& a, int b, int t, int64_t c0,
                           int64_t qhi, QuadLists& L) {
  if (threadIdx.x < 2) L.n[threadIdx.x] = 0;
  __syncthreads();
  const int64_t q = c0 + threadIdx.x;
  if (threadIdx.x < kChunk && q < qhi) {
    const int qb = __ldg(a.qbase + (size_t)b * a.MAXQ + q);
    const int64_t stored = (int64_t)t * 128;
    const bool lists[2] = {
        qb < a.RLP,
        kQuadFlag ? qb >= kOutQbFlag && qb - kOutQbFlag < stored
                  : (int64_t)qb + 127 >= a.RLP && qb < a.RLP + stored};
    const int bases[2] = {qb, kQuadFlag ? (int)(qb - kOutQbFlag + a.RLP)
                                        : qb};
    for (int p = 0; p < 2; ++p)
      if (lists[p]) {
        const int k = atomicAdd(&L.n[p], 1);
        L.q[p][k] = (int)q;
        L.qb[p][k] = bases[p];
      }
  }
  __syncthreads();
}

// Adds into the shared tile the slots of the n listed quads (lq, lqb:
// quad, base) whose source row this pass reads: kOut false, window rows
// < RLP (lit8[b], or v27's flat rows at loff[b]); kOut true, window rows
// RLP + r with r below t*128, this block's stored output. No barrier.
template <bool kFlat, bool kOut>
__device__ void add_batches(const Args<uint8_t>& a, int b, int t,
                            const int* lq, const int* lqb, int n,
                            int32_t* tile) {
  add_slots<128, kOut ? kOutRows : kFlat ? kFlatRows : kLitRows>(
      a, b, t, QuadList{lq, lqb, n}, a.K, kOut ? kOutLg : 0,
      threadIdx.x >> 5, blockDim.x >> 5, tile);
}

// sync: [0] the ticket, then B*NT ready flags (b-major), all 0 at launch
template <bool kFlat, bool kQuadFlag>
__global__ void __launch_bounds__(kThreads) self_ref_grid_kernel(
    Args<uint8_t> a, int B, int32_t* sync) {
  extern __shared__ __align__(16) int32_t tile[];
  __shared__ int ticket;
  __shared__ QuadLists L;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  for (int k = threadIdx.x; k < 128 * kRowBytes; k += blockDim.x)
    tile[k] = 0;
  __syncthreads();
  const int t = ticket / B;
  const int b = ticket % B;
  int32_t* flags = sync + 1 + (size_t)b * a.NT;
  const int32_t* qs_b = a.qs + (size_t)b * a.QW;
  int64_t lo, hi;
  quad_range<kPairs>(qs_b[t], qs_b[t + 1], lo, hi);
  lo = lo < 0 ? 0 : lo;
  hi = hi < a.MAXQ ? hi : a.MAXQ;

  // one scan unless the range holds more than kChunk quads
  bool waited = false;
  for (int64_t c0 = lo; c0 < hi; c0 += kChunk) {
    list_quads<kQuadFlag>(a, b, t, c0, hi, L);
    add_batches<kFlat, false>(a, b, t, L.q[0], L.qb[0], L.n[0], tile);
    if (L.n[1] > 0) {
      if (!waited) {
        // supertiles 0..t-1 of this block hold smaller tickets: their
        // CTAs are resident or done. A CTA that reads no output rows
        // does not wait; every reader waits on each flag itself.
        for (int k = threadIdx.x; k < t; k += blockDim.x)
          for (int64_t n = 0; ld_acquire(flags + k) == 0; ++n) {
            if (n == kSpinLimit) __trap();   // a flag that never comes
            __nanosleep(100);
          }
        __syncthreads();
        waited = true;
      }
      add_batches<kFlat, true>(a, b, t, L.q[1], L.qb[1], L.n[1], tile);
    }
    __syncthreads();   // the tile's adds are done; the lists are free
  }

  uint32_t* dst = reinterpret_cast<uint32_t*>(
      a.out + ((size_t)b * a.NT * 128 + (size_t)t * 128) * kRowBytes);
  for (int k = threadIdx.x; k < 128 * kRowBytes / 4; k += blockDim.x)
    dst[k] = low_bytes(reinterpret_cast<const int4*>(tile)[k]);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flags + t, 1);
  }
}

template <bool kFlat, bool kQuadFlag = false>
int launch_self_ref_grid(const Args<uint8_t>& a, int B, int32_t* sync,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      sync, 0, (1 + (size_t)B * a.NT) * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = 128 * kRowBytes * 4;   // int32 tile
  e = cudaFuncSetAttribute(self_ref_grid_kernel<kFlat, kQuadFlag>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  self_ref_grid_kernel<kFlat, kQuadFlag><<<B * a.NT, kThreads, smem, s>>>(
      a, B, sync);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t (0 = launched). Shapes are checked by
// the Python wrapper; B == 0 launches nothing. The tile routine's entries
// (v19, v13, quad, quad_ablate) take the cluster size C of
// copy_engine.tile_plan: 1 to 8 CTAs a tile, dividing the tile's rows
// (else cudaErrorInvalidValue).
int zxc_copy_engine_v19(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, int cluster,
                        void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, 0};
  return launch_tiles(tiled_kernel<128, uint8_t>, 128, a, B, cluster,
                      stream);
}

// v25, v26 and v27: sync is the call's scratch of 1 + B*NST int32 (ticket
// and ready flags), zeroed here on the stream before the launch. v25 is
// v26's schedule with its lists chosen by qbase's OUT_QB_FLAG (RLP must
// lie below the flag).
int zxc_copy_engine_v25(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int32_t* sync,
                        int B, int NST, int MAXQ, int G32, int K, int RLP,
                        void* stream) {
  if (B == 0 || NST == 0) return 0;
  if (RLP >= kOutQbFlag) return (int)cudaErrorInvalidValue;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, 0};
  return launch_self_ref_grid<false, true>(a, B, sync, stream);
}

int zxc_copy_engine_v26(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int32_t* sync,
                        int B, int NST, int MAXQ, int G32, int K, int RLP,
                        void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, 0};
  return launch_self_ref_grid<false>(a, B, sync, stream);
}

int zxc_copy_engine_v27(const int32_t* qs, const int32_t* qbase,
                        const int32_t* loff, const int32_t* pctrl,
                        const uint8_t* tq, const uint8_t* flat, uint8_t* out,
                        int32_t* sync, int B, int NST, int MAXQ, int G32,
                        int K, int RLP, int64_t rows_tot, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, loff, pctrl, tq, flat, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, rows_tot};
  return launch_self_ref_grid<true>(a, B, sync, stream);
}

int zxc_copy_engine_v13(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const int32_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NT,
                        int MAXQ, int G32, int RLP, int cluster,
                        void* stream) {
  if (B == 0 || NT == 0) return 0;
  Args<int32_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NT, NT + 1, MAXQ, G32, 1, RLP, 0};
  return launch_tiles(tiled_kernel<32, int32_t>, 32, a, B, cluster, stream);
}

// The attic's quad-tile generations as modes of the tile routine: mode
// 12, 14 (32-row tiles), 15, 16, 17, 20 (128-row supertiles; int32 tq)
// and 21, 23, 24 (uint8 tq). K is 1 for modes 12-17. Modes 17 and 15 are
// one function (v17's int8 carriers give v15's sums mod 256), and so are
// 21, 24 and v19 (v21 merges matmuls, v24 carries f32).
int zxc_copy_engine_quad(const int32_t* qs, const int32_t* qbase,
                         const int32_t* pctrl, const void* tq,
                         const uint8_t* lit8, uint8_t* out, int B, int NT,
                         int MAXQ, int G32, int K, int RLP, int mode,
                         int cluster, void* stream) {
  if (B == 0 || NT == 0) return 0;
  const int QW = mode == 20 ? 2 * NT + 1 : NT + 1;
  Args<int32_t> a32{qs, qbase, nullptr, pctrl,
                    static_cast<const int32_t*>(tq), lit8, out,
                    NT, QW, MAXQ, G32, K, RLP, 0};
  Args<uint8_t> a8{qs, qbase, nullptr, pctrl,
                   static_cast<const uint8_t*>(tq), lit8, out,
                   NT, QW, MAXQ, G32, K, RLP, 0};
  const int C = cluster;
  switch (mode) {
    case 12:
      return launch_tiles(tiled_kernel<32, int32_t, kOnes>, 32, a32, B, C,
                          stream);
    case 14:
      return launch_tiles(tiled_kernel<32, int32_t, kFoursThenOnes>, 32, a32,
                          B, C, stream);
    case 15:
    case 17:
      return launch_tiles(tiled_kernel<128, int32_t>, 128, a32, B, C, stream);
    case 16:
      return launch_tiles(tiled_kernel<128, int32_t, kFours>, 128, a32, B, C,
                          stream);
    case 20:
      return launch_tiles(
          tiled_kernel<128, int32_t, kPairs, kPlaneMajor, true>, 128, a32, B,
          C, stream);
    case 21:
    case 24:
      return launch_tiles(tiled_kernel<128, uint8_t>, 128, a8, B, C, stream);
    case 23:
      return launch_tiles(tiled_kernel<128, uint8_t, kPairs, kInterleaved>,
                          128, a8, B, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tools/tpu_v12_ablate2.py's ablations of v12 (32-row tiles, every quad,
// one plane, int32 tq): ablate 1 nopt, 2 statwin, 3 nomm, 4 mmonly.
int zxc_copy_engine_quad_ablate(const int32_t* qs, const int32_t* qbase,
                                const int32_t* pctrl, const int32_t* tq,
                                const uint8_t* lit8, uint8_t* out, int B,
                                int NT, int MAXQ, int G32, int RLP,
                                int ablate, int cluster, void* stream) {
  if (B == 0 || NT == 0) return 0;
  Args<int32_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NT, NT + 1, MAXQ, G32, 1, RLP, 0};
  const int C = cluster;
  switch (ablate) {
    case kNoPt:
      return launch_tiles(tiled_kernel<32, int32_t, kOnes, kPlaneMajor,
                                       false, kNoPt>, 32, a, B, C, stream);
    case kStatWin:
      return launch_tiles(tiled_kernel<32, int32_t, kOnes, kPlaneMajor,
                                       false, kStatWin>, 32, a, B, C, stream);
    case kNoMM:
      return launch_tiles(tiled_kernel<32, int32_t, kOnes, kPlaneMajor,
                                       false, kNoMM>, 32, a, B, C, stream);
    case kMMOnly:
      return launch_tiles(tiled_kernel<32, int32_t, kOnes, kPlaneMajor,
                                       false, kMMOnly>, 32, a, B, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
