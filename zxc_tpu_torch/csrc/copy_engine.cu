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
// below both the H100's 3.35 TB/s and its integer rate. The tile
// routine's time goes to latency: each slot is a chain of dependent loads
// (control word -> source row -> shared-memory atomics), one slot in
// flight a warp. v26/v27's time goes to the SMs' issue of each slot's
// shuffles and shared atomics (a batch's row loads overlap), to the SMs a
// group fills (1024 threads at 64 registers take an SM's register file,
// so one CTA an SM) and to the chain of a block's supertiles through the
// rows they read back (PERF.md, P6).
// Design of the tile routine (v19, v13, v25 and the attic modes): one warp
// per slot, 4 lanes per thread. The warp loads the 128-byte source row
// once (one 4-byte word per thread, coalesced) and rotates it with two
// shuffles and a funnel shift per plane; the tile lives in shared memory
// as int32 and takes atomicAdd, so the add semantics hold exactly for any
// control. v19, v13 and the attic modes grid over (tile, block), one CTA
// each; v25 loops over supertiles inside one CTA with __syncthreads()
// between them, reading earlier supertiles back from global memory.
// Design of v26/v27 (self_ref_grid_kernel): one CTA per (supertile,
// block), the same int32 tile. A supertile depends on earlier ones only
// through slots whose source row is >= RLP (the block's own output). A
// CTA lists its quads in shared memory by the rows their windows reach
// (one qbase load a quad), adds the slots that read lit rows (pass 1, no
// wait), and only if some quad reaches stored output rows waits on the
// ready flags of supertiles 0..t-1 of its block and adds those slots
// (pass 2); then it stores its tile and publishes its own flag
// (__threadfence + release store; waiters poll with acquire loads and
// read output rows through L2 with __ldcg, and every reader waits on
// each flag it needs, so a flag set without a wait misleads no one). CTAs
// take (t, b) from an atomic ticket in t-major order, so a CTA waits only
// on CTAs that took smaller tickets and are already resident: no deadlock
// whatever the grid size. The ticket and flags live in a per-call
// scratch the entry zeroes on the launch stream. In pass 1 a warp takes
// the 32 slots of one (quad, batch) pair, in pass 2 a quarter of them (a
// CTA's few output-reading quads are the chain's critical work, so they
// spread over more warps): each lane loads its slot's control words and
// target row in one instruction each, a ballot drops slots that add
// nothing (filler, out-of-range rows, rows the pass does not read), and
// the warp issues kInflight source-row loads before it rotates and adds
// them; planes that cover no lane are skipped. TMA and wgmma are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kOutQbFlag = 1 << 24;   // v25: qbase of an output quad

// kQuadSelfRef (v25): lit8, or the block's stored output for a flagged quad.
// kSelfRef and kFlatSelfRef are v26's and v27's windows in the tile
// routine, which no entry launches since they run self_ref_grid_kernel;
// they go with v25's move to that schedule.
enum Window { kLit = 0, kSelfRef = 1, kFlatSelfRef = 2, kQuadSelfRef = 3 };
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
  uint8_t* out;          // (B, NT*kRows, 128); read back by v26/v27
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

// adds the slots of quads [q_lo, q_hi), clipped to [0, MAXQ), reading
// nplanes planes of control, into the shared tile; no barrier
template <int kRows, int kWin, int kLayout, int kAblate, typename TQ>
__device__ void add_quads(const Args<TQ>& a, int b, int t, int64_t q_lo,
                          int64_t q_hi, int nplanes, int32_t* tile) {
  const int NR = a.NT * kRows;
  const int64_t qlo = q_lo < 0 ? 0 : q_lo;
  const int64_t qhi = q_hi < a.MAXQ ? q_hi : a.MAXQ;
  const int64_t nslots = qhi > qlo ? (qhi - qlo) * 128 : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int32_t* pc_b = a.pctrl + (size_t)b * a.K * a.G32 * kRowBytes;
  const uint8_t* out_b = a.out + (size_t)b * NR * kRowBytes;
  const int64_t win_rows =
      kWin == kLit || kWin == kQuadSelfRef ? a.RLP : (int64_t)a.RLP + NR;
  const int64_t stored_rows = (int64_t)t * kRows;   // v25/v26/v27 only
  // v27: this block's rows of the flat buffer; an out-of-range window row
  // reads 0, which adds nothing
  int64_t lit_base = (int64_t)b * a.RLP;
  int64_t lit_rows = (int64_t)(b + 1) * a.RLP;
  if (kWin == kFlatSelfRef) {
    lit_base = a.loff[b];
    lit_rows = lit_base < 0 ? 0 : a.rows_tot;
  }

  // every branch below depends only on the slot, so it is warp-uniform
  // and the full-mask shuffles stay legal
  for (int64_t s = warp; s < nslots; s += nwarps) {
    const int64_t q = qlo + (s >> 7);
    const int i = (int)(s & 127);
    const int bat = 4 * (int)q + (i >> 5);
    const uint32_t w0 =
        (uint32_t)pc_b[ctrl_index<kLayout>(0, bat, i, a.K, a.G32)];
    const uint32_t rowrel = w0 >> 21;
    const int64_t tgt = kAblate == kNoPt || kAblate == kMMOnly
        ? (int64_t)(i & 31)
        : (int64_t)a.tq[((size_t)b * a.MAXQ + q) * kRowBytes + i];
    const int64_t qb = a.qbase[(size_t)b * a.MAXQ + q];
    // v25: a flagged quad reads the block's own output rows stored so far
    const bool from_out = kWin == kQuadSelfRef && qb >= kOutQbFlag;
    const int64_t src =
        (kAblate == kStatWin ? 0 : from_out ? qb - kOutQbFlag : qb)
        + (kAblate == kNoMM ? (int64_t)i : (int64_t)rowrel);
    if ((kAblate != kNoMM && rowrel >= 128) || tgt < 0 || tgt >= kRows
        || src < 0 || src >= (from_out ? stored_rows : win_rows))
      continue;

    uint32_t word = 0;
    if (from_out) {
      word = reinterpret_cast<const uint32_t*>(out_b + src * kRowBytes)[lane];
    } else if (src < a.RLP) {
      const int64_t row = lit_base + src;
      if (row >= 0 && row < lit_rows)
        word = reinterpret_cast<const uint32_t*>(
            a.lit8 + row * kRowBytes)[lane];
    } else if (src - a.RLP < stored_rows) {   // v26/v27: own output rows
      word = reinterpret_cast<const uint32_t*>(
          out_b + (src - a.RLP) * kRowBytes)[lane];
    }

    uint32_t val = 0;
    unsigned cover = 0;
    if (kAblate == kMMOnly) {   // the gathered row as it is, every lane
      val = word;
      cover = 0xf;
      nplanes = 0;
    }
    for (int j = 0; j < nplanes; ++j) {
      const uint32_t w = j == 0 ? w0
          : (uint32_t)pc_b[ctrl_index<kLayout>(j, bat, i, a.K, a.G32)];
      const int roll = w & 127;
      const int lo_l = (w >> 7) & 127;
      const int hi_l = (w >> 14) & 127;
      // bytes (4*lane + roll + c) & 127, c = 0..3, of the source row
      const int idx0 = (4 * lane + roll) & 127;
      const uint32_t lo = __shfl_sync(kFull, word, idx0 >> 2);
      const uint32_t hi = __shfl_sync(kFull, word, ((idx0 >> 2) + 1) & 31);
      const uint32_t rot = __funnelshift_r(lo, hi, 8 * (idx0 & 3));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int l = 4 * lane + c;
        if (lo_l <= l && l <= hi_l) {   // highest covering plane wins
          val = (val & ~(0xffu << (8 * c))) | (rot & (0xffu << (8 * c)));
          cover |= 1u << c;
        }
      }
    }
    int32_t* trow = tile + tgt * kRowBytes + 4 * lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int v = (val >> (8 * c)) & 0xff;
      if (kAblate == kNoMM) v = bf16_round(v + (int)rowrel);
      if (((cover >> c) & 1) && v) atomicAdd(trow + c, v);
    }
  }
}

// One tile: cleared, its quads added (kSplit, v20: the pair-floored
// [qs[2t], qs[2t+1]) with plane 0 only, then the pair-floored
// [qs[2t+1], qs[2t+2]) with all K planes; else [qs[t], qs[t+1]) under
// kWalk), stored mod 256.
template <int kRows, int kWin, typename TQ, int kWalk = kPairs,
          int kLayout = kPlaneMajor, bool kSplit = false, int kAblate = kNone>
__device__ void run_tile(const Args<TQ>& a, int b, int t, int32_t* tile) {
  const int NR = a.NT * kRows;
  for (int k = threadIdx.x; k < kRows * kRowBytes; k += blockDim.x)
    tile[k] = 0;
  __syncthreads();

  const int32_t* qs_b = a.qs + (size_t)b * a.QW;
  int64_t lo, hi;
  if (kSplit) {
    quad_range<kPairs>(qs_b[2 * t], qs_b[2 * t + 1], lo, hi);
    add_quads<kRows, kWin, kLayout, kAblate>(a, b, t, lo, hi, 1, tile);
    quad_range<kPairs>(qs_b[2 * t + 1], qs_b[2 * t + 2], lo, hi);
  } else {
    quad_range<kWalk>(qs_b[t], qs_b[t + 1], lo, hi);
  }
  add_quads<kRows, kWin, kLayout, kAblate>(a, b, t, lo, hi, a.K, tile);
  __syncthreads();

  uint32_t* dst = reinterpret_cast<uint32_t*>(
      a.out + ((size_t)b * NR + (size_t)t * kRows) * kRowBytes);
  for (int k = threadIdx.x; k < kRows * kRowBytes / 4; k += blockDim.x) {
    const int32_t* v = tile + 4 * k;
    dst[k] = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8)
             | ((uint32_t)(v[2] & 0xff) << 16)
             | ((uint32_t)(v[3] & 0xff) << 24);
  }
  // the stores must be visible to the next supertile's window reads
  // (v25/v26/v27), and the tile must not be cleared while still being read
  __syncthreads();
}

// one CTA per (tile, block)
template <int kRows, typename TQ, int kWalk = kPairs,
          int kLayout = kPlaneMajor, bool kSplit = false, int kAblate = kNone>
__global__ void __launch_bounds__(kThreads) tiled_kernel(Args<TQ> a) {
  extern __shared__ int32_t tile[];
  run_tile<kRows, kLit, TQ, kWalk, kLayout, kSplit, kAblate>(
      a, blockIdx.y, blockIdx.x, tile);
}

// one CTA per block, supertiles in order (self-referential window)
template <int kWin>
__global__ void __launch_bounds__(kThreads) self_ref_kernel(
    Args<uint8_t> a) {
  extern __shared__ int32_t tile[];
  for (int t = 0; t < a.NT; ++t)
    run_tile<128, kWin>(a, blockIdx.x, t, tile);
}

// ---- v26/v27: one CTA per (supertile, block) ------------------------------

constexpr int kRegPlanes = 2;   // control planes a lane holds for its slot
constexpr int kInflight = 8;    // source-row loads a warp keeps in flight
// pass 2's 32-slot batches are split in kOutParts parts, one a warp
constexpr int kOutParts = 4;
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
// and cover marks them (a later plane overrides an earlier one)
__device__ __forceinline__ void apply_plane(uint32_t w, uint32_t word,
                                            int lane, uint32_t& val,
                                            uint32_t& cover) {
  const int lo_l = (w >> 7) & 127;
  const int hi_l = (w >> 14) & 127;
  if (lo_l > hi_l) return;   // covers no lane; w is warp-uniform
  const int roll = w & 127;
  const int from = lane + (roll >> 2);
  const uint32_t w_lo = __shfl_sync(kFull, word, from & 31);
  const uint32_t w_hi = __shfl_sync(kFull, word, (from + 1) & 31);
  const uint32_t rot = __funnelshift_r(w_lo, w_hi, 8 * (roll & 3));
  const int first = max(lo_l - 4 * lane, 0);      // bytes [first, end)
  const int end = min(hi_l - 4 * lane + 1, 4);
  if (first < end) {
    const uint32_t m = (0xffffffffu >> (8 * (4 - end)))
                       & (0xffffffffu << (8 * first));
    val = (val & ~m) | (rot & m);
    cover |= m;
  }
}

constexpr int kChunk = kThreads;   // quads a CTA lists in one scan

// One scan's quads by the window rows [qb, qb + 127] they reach: list 0
// (pass 1) those reaching lit rows (< RLP), list 1 (pass 2) those reaching
// stored output rows (RLP .. RLP + t*128 - 1); a quad may be on both.
struct QuadLists {
  int n[2];
  int q[2][kChunk];
  int qb[2][kChunk];
};

// Lists the quads [c0, min(c0 + kChunk, qhi)) of block b for supertile t:
// one qbase load a thread; ends with a barrier.
__device__ void list_quads(const Args<uint8_t>& a, int b, int t, int64_t c0,
                           int64_t qhi, QuadLists& L) {
  if (threadIdx.x < 2) L.n[threadIdx.x] = 0;
  __syncthreads();
  const int64_t q = c0 + threadIdx.x;
  if (threadIdx.x < kChunk && q < qhi) {
    const int qb = __ldg(a.qbase + (size_t)b * a.MAXQ + q);
    const bool lists[2] = {qb < a.RLP,
                           (int64_t)qb + 127 >= a.RLP
                               && qb < (int64_t)a.RLP + (int64_t)t * 128};
    for (int p = 0; p < 2; ++p)
      if (lists[p]) {
        const int k = atomicAdd(&L.n[p], 1);
        L.q[p][k] = (int)q;
        L.qb[p][k] = qb;
      }
  }
  __syncthreads();
}

// Adds into the shared tile the slots of the n listed quads (lq, lqb:
// quad, qbase) whose source row this pass reads: kOut false, window rows
// < RLP (lit8[b], or v27's flat rows at loff[b]); kOut true, window rows
// RLP + r with r below t*128, this block's stored output. No barrier.
template <bool kFlat, bool kOut>
__device__ void add_batches(const Args<uint8_t>& a, int b, int t,
                            const int* lq, const int* lqb, int n,
                            int32_t* tile) {
  constexpr int kParts = kOut ? kOutParts : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int32_t* pc_b = a.pctrl + (size_t)b * a.K * a.G32 * kRowBytes;
  const uint8_t* tq_b = a.tq + (size_t)b * a.MAXQ * kRowBytes;
  const int64_t stored = (int64_t)t * 128;
  // pass 1: window row r is row lit_base + r of lit8, readable below
  // lit_end (v27: 0 for a block with loff < 0); pass 2: output row r - RLP
  int64_t lit_base = (int64_t)b * a.RLP;
  int64_t lit_end = lit_base + a.RLP;
  if (kFlat) {
    lit_base = a.loff[b];
    lit_end = lit_base < 0 ? 0 : a.rows_tot;
  }
  const uint8_t* rows = kOut ? a.out + (size_t)b * a.NT * 128 * kRowBytes
                             : a.lit8;

  // one item = part it % kParts of the 32 slots 32u..32u+31 of a listed
  // quad q (batch bat = 4q + u); every branch on a slot's values below is
  // taken by the whole warp
  for (int it = warp; it < 4 * kParts * n; it += nwarps) {
    const int q = lq[it / (4 * kParts)];
    const int64_t qb = lqb[it / (4 * kParts)];
    const int u = (it / kParts) & 3;
    const int bat = 4 * q + u;
    const int i = 32 * u + lane;
    uint32_t w[kRegPlanes];
    bool covers = a.K > kRegPlanes;   // planes past kRegPlanes: not checked
#pragma unroll
    for (int j = 0; j < kRegPlanes; ++j) {
      w[j] = j < a.K ? (uint32_t)__ldg(
          pc_b + ctrl_index<kPlaneMajor>(j, bat, i, a.K, a.G32)) : 0u;
      covers |= j < a.K && ((w[j] >> 7) & 127) <= ((w[j] >> 14) & 127);
    }
    const int tgt = __ldg(tq_b + (size_t)q * kRowBytes + i);
    const uint32_t rowrel = w[0] >> 21;
    const int64_t src = qb + rowrel;
    const int64_t row = kOut ? src - a.RLP : lit_base + src;
    const bool readable = kOut
        ? src >= a.RLP && row < stored
        : src >= 0 && src < a.RLP && row >= 0 && row < lit_end;
    unsigned todo = __ballot_sync(
        kFull, covers && rowrel < 128 && tgt < 128 && readable);
    if (kParts > 1)
      todo &= (kFull >> (32 - 32 / kParts)) << (32 / kParts * (it % kParts));
    const uint32_t my_row = (uint32_t)row;   // < 2^32 wherever readable

    while (todo) {
      // the next kInflight slots: all their rows first, then the adds
      uint32_t word[kInflight];
      unsigned batch = 0;
#pragma unroll
      for (int n = 0; n < kInflight; ++n) {
        const int s = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        batch |= s < 0 ? 0u : 1u << s;
        const uint32_t r = __shfl_sync(kFull, my_row, s < 0 ? 0 : s);
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            rows + (size_t)r * kRowBytes) + lane;
        word[n] = s < 0 ? 0u : kOut ? __ldcg(p) : __ldg(p);
      }
#pragma unroll
      for (int n = 0; n < kInflight; ++n) {
        const int s = batch ? __ffs(batch) - 1 : -1;
        batch &= batch - 1;
        if (s < 0) break;
        const int tg = __shfl_sync(kFull, tgt, s);
        uint32_t val = 0, cover = 0;
#pragma unroll
        for (int j = 0; j < kRegPlanes; ++j)
          if (j < a.K)
            apply_plane(__shfl_sync(kFull, w[j], s), word[n], lane, val,
                        cover);
        for (int j = kRegPlanes; j < a.K; ++j)
          apply_plane((uint32_t)__ldg(pc_b + ctrl_index<kPlaneMajor>(
                          j, bat, 32 * u + s, a.K, a.G32)),
                      word[n], lane, val, cover);
        int32_t* trow = tile + tg * kRowBytes + 4 * lane;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int v = (val >> (8 * c)) & 0xff;
          if (((cover >> (8 * c)) & 0xff) && v) atomicAdd(trow + c, v);
        }
      }
    }
  }
}

// sync: [0] the ticket, then B*NT ready flags (b-major), all 0 at launch
template <bool kFlat>
__global__ void __launch_bounds__(kThreads) self_ref_grid_kernel(
    Args<uint8_t> a, int B, int32_t* sync) {
  extern __shared__ int32_t tile[];
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
    list_quads(a, b, t, c0, hi, L);
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
  for (int k = threadIdx.x; k < 128 * kRowBytes / 4; k += blockDim.x) {
    const int32_t* v = tile + 4 * k;
    dst[k] = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8)
             | ((uint32_t)(v[2] & 0xff) << 16)
             | ((uint32_t)(v[3] & 0xff) << 24);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flags + t, 1);
  }
}

template <bool kFlat>
int launch_self_ref_grid(const Args<uint8_t>& a, int B, int32_t* sync,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      sync, 0, (1 + (size_t)B * a.NT) * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = 128 * kRowBytes * 4;   // int32 tile
  e = cudaFuncSetAttribute(self_ref_grid_kernel<kFlat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  self_ref_grid_kernel<kFlat><<<B * a.NT, kThreads, smem, s>>>(a, B, sync);
  return (int)cudaGetLastError();
}

template <typename Kernel, typename A>
int launch(Kernel kernel, dim3 grid, int rows, const A& a, void* stream) {
  const int smem = rows * kRowBytes * 4;   // int32 tile
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t (0 = launched). Shapes are checked by
// the Python wrapper; B == 0 launches nothing.
int zxc_copy_engine_v19(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, 0};
  return launch(tiled_kernel<128, uint8_t>, dim3(NST, B), 128, a, stream);
}

// v25: v26's schedule (one CTA a block, supertiles in order) with the
// window chosen per quad by qbase's OUT_QB_FLAG
int zxc_copy_engine_v25(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, NST + 1, MAXQ, G32, K, RLP, 0};
  return launch(self_ref_kernel<kQuadSelfRef>, dim3(B), 128, a, stream);
}

// v26/v27: sync is the call's scratch of 1 + B*NST int32 (ticket and
// ready flags), zeroed here on the stream before the launch
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
                        int MAXQ, int G32, int RLP, void* stream) {
  if (B == 0 || NT == 0) return 0;
  Args<int32_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NT, NT + 1, MAXQ, G32, 1, RLP, 0};
  return launch(tiled_kernel<32, int32_t>, dim3(NT, B), 32, a, stream);
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
                         void* stream) {
  if (B == 0 || NT == 0) return 0;
  const int QW = mode == 20 ? 2 * NT + 1 : NT + 1;
  Args<int32_t> a32{qs, qbase, nullptr, pctrl,
                    static_cast<const int32_t*>(tq), lit8, out,
                    NT, QW, MAXQ, G32, K, RLP, 0};
  Args<uint8_t> a8{qs, qbase, nullptr, pctrl,
                   static_cast<const uint8_t*>(tq), lit8, out,
                   NT, QW, MAXQ, G32, K, RLP, 0};
  const dim3 grid(NT, B);
  switch (mode) {
    case 12:
      return launch(tiled_kernel<32, int32_t, kOnes>, grid, 32, a32, stream);
    case 14:
      return launch(tiled_kernel<32, int32_t, kFoursThenOnes>, grid, 32, a32,
                    stream);
    case 15:
    case 17:
      return launch(tiled_kernel<128, int32_t>, grid, 128, a32, stream);
    case 16:
      return launch(tiled_kernel<128, int32_t, kFours>, grid, 128, a32,
                    stream);
    case 20:
      return launch(tiled_kernel<128, int32_t, kPairs, kPlaneMajor, true>,
                    grid, 128, a32, stream);
    case 21:
    case 24:
      return launch(tiled_kernel<128, uint8_t>, grid, 128, a8, stream);
    case 23:
      return launch(tiled_kernel<128, uint8_t, kPairs, kInterleaved>, grid,
                    128, a8, stream);
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
                                int ablate, void* stream) {
  if (B == 0 || NT == 0) return 0;
  Args<int32_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NT, NT + 1, MAXQ, G32, 1, RLP, 0};
  const dim3 grid(NT, B);
  switch (ablate) {
    case kNoPt:
      return launch(tiled_kernel<32, int32_t, kOnes, kPlaneMajor, false,
                                 kNoPt>, grid, 32, a, stream);
    case kStatWin:
      return launch(tiled_kernel<32, int32_t, kOnes, kPlaneMajor, false,
                                 kStatWin>, grid, 32, a, stream);
    case kNoMM:
      return launch(tiled_kernel<32, int32_t, kOnes, kPlaneMajor, false,
                                 kNoMM>, grid, 32, a, stream);
    case kMMOnly:
      return launch(tiled_kernel<32, int32_t, kOnes, kPlaneMajor, false,
                                 kMMOnly>, grid, 32, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
