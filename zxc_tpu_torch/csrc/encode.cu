// Device encoder kernels for Hopper (sm_90a): the LCP match extender and
// the parse walk.
//
// Replaces the Pallas kernels of the JAX package:
//   lcp:        zxc_tpu/ops/pallas_encode.py _make_lcp_body / lcp_kernel
//   parse walk: zxc_tpu/ops/pallas_encode.py parse_walk_kernel
//
// LCP (what it computes, not the TPU formulation). Block b holds n bytes
// (blk row b, L >= n bytes, L % 16 == 0); z(x) is its byte x for
// 0 <= x < n and 0 for every other x. Pair i of block b is one int32 word
// w = pc[b,i], read as uint32 and packed as the JAX kernel packs it:
// p = w >> 16, c = w & 0xFFFF (a logical shift, so p reaches 65535). Its
// result is the first i in [0, 256) with z(p+i) != z(c+i), or 256 when
// the 256 bytes agree (the JAX kernel's ROUNDS = 2 compare rounds of 128
// bytes over its zero-padded block). The caller clamps to n - p. The
// one-hot MXU row fetches, lane rolls, diagonal extraction and column
// layout of the TPU kernel exist only because gathers are slow there; the
// words come here flat and give the same value per pair. Any word is a
// pair whose positions lie in [0, 65536), so none reads outside a buffer.
//
// What bounds it on the card: bytes. One dispatch group (16 blocks of
// 64 KiB, 5 candidates a position at level 3: 5,242,560 pairs) moves the
// blocks once (1 MiB), a 4-byte word in and a 4-byte result out per pair
// (42,989,056 B): 0.0128 ms at 3.35 TB/s. Past the bytes, the compares
// are shared-memory loads at random candidate addresses, whose bank
// conflicts grow with the bytes a pair compares: on the first group of
// the pinned corpus 99.995% of pairs differ within 32 bytes and 73%
// within 8, 0.0015% reach 256. Times below: lcp_merge_ab.py on an NVIDIA
// H100 80GB HBM3, 700.00 W, back to back. The earlier form of this kernel
// (17 CTAs a block each staging the block with 16-byte loads, a bound
// test on every 4-byte window, a warp as long as its longest pair) read
// 0.0485 ms on that group, 0.4432 on all-equal blocks.
//
// Design. (1) Stage: each CTA copies its block's first n & ~15 bytes into
// shared memory with cp.async.bulk (16 KiB pieces on one mbarrier) while
// its threads write the bytes from there to kMargin past it: the row's
// below n, zeros from n on (the row's bytes past n are never read). Every
// start is clamped to min(p, n), exact since a start at or past n reads
// 256 zeros either way, so no compare tests a bound. (2) Pair words by 16
// bytes: a thread loads 4 consecutive words as one int4, the next 4
// while it compares these (the first before the stage lands), and stores
// its 4 results as one int4; a row off 16 bytes has a scalar edge of at
// most 3 words at each end. (3) First round, in the pair's lane: up to
// kFirst bytes, 4 a step from 4-byte loads and a funnel shift a side, the
// lane stopping at its first difference. (4) A pair equal through kFirst
// bytes goes on its warp's queue (a ballot and a popcount a pair slot).
// The warp finishes the queue: 32 pairs at a time a pair a lane from byte
// kFirst on while kBatch or more are queued (all-equal data: every lane
// busy, in step), the rest a pair a warp step, lane l comparing bytes
// [8l, 8l + 8) from two 8-byte loads a side (contiguous across the warp)
// and the warp's minimum of the lanes' first differing byte, or 256, the
// result: a rare long pair costs one warp step and holds no other lane.
// (5) Grid: lcp_plan's split, one CTA of 1,024 threads an SM, 8 a block
// for a group: each stage serves 41 K pairs, and 32 warps an SM keep the
// loads in flight.
//
// Measured (first group / all-equal blocks, ms): the design 0.0269 /
// 0.1948, 2.1x its bound; the I/O alone (no stage, no compare) 0.0142,
// with the stage 0.0146; next words loaded only when taken 0.0295;
// long pairs finished in their lane 0.0318 / 0.1922; every queued pair a
// warp step 0.0267 / 0.3660; a first round of 16 bytes 0.0336; of 32
// bytes in one piece from 16-byte loads 0.0385; CTAs of 256 threads, 3
// an SM, 0.0320, of 512, 2 an SM, 0.0283; splits of 4 and 16 a block
// 0.0463 and 0.0295. What is left above the I/O is the first round's
// random-address shared loads.
//
// Parse walk. For block b, a cursor starts at 0 and, while it is below P,
// reads s = step[b, cursor]; when s > 1 it records the cursor at
// pos[b, min(j, CAP-1)] and counts j; then it advances by s clamped to
// [1, P] (a step below 1 advances by 1: the JAX kernel would never end).
// nseq[b] = j, unclamped; pos entries from min(j, CAP) on are left as they
// were (the JAX kernel leaves them too). Its bytes bound is the steps on
// the chain read once and the records written once (walk_bytes_moved, a
// few MB a group); the chain of up to P dependent steps is no floor,
// because the walk synchronizes itself: two walks started at different
// positions are the same walk from the first position both reach, and on
// real parses (misses step 1, matches 5 or more) they meet within a few
// steps. Design: one CTA of 1024 threads a block. (1) Stage: the row goes
// to shared memory as uint16 clamp(step, 1, max(P, 2)) - 1 (exact for
// P <= 65536: 128 KiB at most), with 8 loads of 16 bytes in flight a
// thread, and from the same registers a record bitmap G of P bits (the
// positions whose step is over 1) beside a visit bitmap M of P bits. (2)
// Speculate: [0, P) is cut into chunks of a multiple of 32 positions, one
// a thread, so no two threads write one bitmap word; each thread walks its
// chunk from the chunk's first position, marks what it visits in M and
// keeps its exit (the first position past the chunk). A walk passes a run
// of steps of 1 a word of G at a time. (3) Synchronize: chunk k's entry is
// chunk k-1's exit (chunk 0's is 0). Rounds run until no exit changes; in
// a round each chunk whose entry changed walks from the new entry and
// stops at the first marked position (the path from there is the marked
// one, whose exit it holds) or past the chunk; a walk that met no mark is
// a new path, whose marks replace the old ones, so M holds one path. A
// chunk whose entry lies past it has no positions: its exit is its entry.
// (4) Worst case: steps on which walks never meet (all 5, all 3) change
// most chunks every round; when a round changes more than half the
// chunks, or after max_rounds rounds, thread 0 finishes serially from the
// first chunk not settled over the staged row, taking a chunk's exit
// where its entry lies on the chunk's marked path. (5) Count, scan, write:
// each chunk walks from its true entry to its first marked position q;
// from q on its records are M & G (q's suffix of the marked path), counted
// by popcount; a block-wide scan gives each chunk its first j, and the
// chunk writes its records to pos; slot CAP-1 takes only the record
// j == nseq-1 when nseq > CAP-1. Rows of P > 65536 take the global-memory
// form of the same phases: steps read (clamped) from global memory, where
// they stay in L2, and both bitmaps in a per-call global scratch. What
// bounds it on the card (NVIDIA H100, walk_gather_ab.py --ablate): one SM a
// block, 16 of 132 SMs for a group, whose instruction issue the stage and
// the walks' divergent warps fill; the serial finish of the worst case is
// one dependent shared-memory load a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 256;          // 128 * ROUNDS of the JAX kernel
constexpr int kMaxBlock = 65536;   // shared-memory stage of one block
constexpr int kLcpThreads = 1024;
constexpr int kLcpWarps = kLcpThreads / 32;
constexpr int kFirst = 32;         // bytes of the first round, in the lane
// Staged bytes past n & ~15: the reads of a start s <= n end before
// s + 264 (the finish's last 8-byte pair of loads), n & ~15 >= n - 15.
constexpr int kMargin = kCap + 48;
constexpr int kQueue = 4 * 32;     // long pairs a warp queues in a round
constexpr int kBatch = 16;         // fewest queued pairs taken a lane each
constexpr uint32_t kFillPiece = 16 << 10;   // bytes a bulk copy
constexpr long long kSpinLimit = 1LL << 31;  // mbarrier polls before a trap
constexpr int kWalkThreads = 1024;      // one chunk a thread
constexpr int kWalkSharedMax = 65536;   // rows staged as uint16 in shared memory

// The LCP kernel's dynamic shared memory for blocks of n bytes.
__host__ __device__ constexpr int lcp_stage_bytes(int n) {
  return (n & ~15) + kMargin;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();   // a copy that never lands
  }
}

// The block's bytes [0, n & ~15) by bulk copies on the mbarrier `bar`
// (issued by thread 0), then bytes up to lcp_stage_bytes(n) by the
// threads: the row's below n, 0 from n on. Returns with the stage
// complete for every thread.
__device__ __forceinline__ void stage_block(unsigned char* st,
                                            const uint8_t* src, int n,
                                            uint64_t* bar) {
  const uint32_t nf = (uint32_t)(n & ~15);
  const uint32_t b = shared_addr(bar);
  if (nf && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(nf) : "memory");
    for (uint32_t o = 0; o < nf; o += kFillPiece)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(shared_addr(st) + o),
             "l"((uint64_t)__cvta_generic_to_global(src + o)),
             "r"(min(kFillPiece, nf - o)), "r"(b)
          : "memory");
  }
  for (int x = (int)nf + threadIdx.x; x < lcp_stage_bytes(n);
       x += kLcpThreads)
    st[x] = x < n ? src[x] : 0;
  __syncthreads();   // the barrier is initialised before anyone waits
  if (nf) mbar_wait(b, 0);
}

// The first differing byte of the stage's bytes from p and from c in
// [from, to), or `to` when they agree there: 4 bytes a step, one 4-byte
// load and a funnel shift a side, each lane stopping at its first
// difference.
__device__ __forceinline__ int lane_lcp(const unsigned char* st, int p,
                                        int c, int from, int to) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(st);
  const uint32_t* wp = w + ((p + from) >> 2);
  const uint32_t* wc = w + ((c + from) >> 2);
  const int sp = 8 * (p & 3), sc = 8 * (c & 3);
  uint32_t a0 = *wp, b0 = *wc;
#pragma unroll 2
  for (int r = from; r < to; r += 4) {
    const uint32_t a1 = *++wp, b1 = *++wc;
    const uint32_t d =
        __funnelshift_r(a0, a1, sp) ^ __funnelshift_r(b0, b1, sc);
    if (d) return r + ((__ffs(d) - 1) >> 3);
    a0 = a1;
    b0 = b1;
  }
  return to;
}

// the stage's 8 bytes x .. x+7, little endian, from two 8-byte loads
__device__ __forceinline__ uint64_t stage_u64(const unsigned char* st,
                                              int x) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(st + (x & ~7));
  const int sh = 8 * (x & 7);
  const uint64_t lo = w[0];
  return sh ? (lo >> sh) | (w[1] << (64 - sh)) : lo;
}

// The warp's finish of its `queued` long pairs, each result replacing the
// pair's word. While kBatch or more are left, 32 at a time a pair a lane
// from byte kFirst on (where many lanes hold a long pair they run in
// step); the rest a pair a warp step: lane l compares bytes [8l, 8l + 8)
// of both sides, and the warp's minimum of the lanes' first differing
// byte, or 256, is the result (a long pair among short ones holds no
// other lane).
__device__ __forceinline__ void warp_finish(const unsigned char* st, int n,
                                            uint32_t* queue, int queued,
                                            int lane) {
  int e = 0;
  for (; queued - e >= kBatch; e += 32) {
    if (e + lane < queued) {
      const uint32_t word = queue[e + lane];
      queue[e + lane] = (uint32_t)lane_lcp(
          st, min((int)(word >> 16), n), min((int)(word & 0xFFFFu), n),
          kFirst, kCap);
    }
  }
  for (; e < queued; ++e) {
    const uint32_t word = queue[e];
    const int p = min((int)(word >> 16), n);
    const int c = min((int)(word & 0xFFFFu), n);
    const uint64_t d =
        stage_u64(st, p + 8 * lane) ^ stage_u64(st, c + 8 * lane);
    const int r = __reduce_min_sync(
        ~0u, d ? 8 * lane + ((__ffsll((long long)d) - 1) >> 3) : kCap);
    __syncwarp();
    if (lane == 0) queue[e] = (uint32_t)r;
  }
}

// A warp's round: each lane's `cnt` (0-4; 4 where it is 16-byte aligned)
// pair words `w` from flat index f, through the first round and the
// warp's queue; results stored where the words were read.
__device__ __forceinline__ void lcp_round(const unsigned char* st, int n,
                                          uint32_t* queue,
                                          int32_t* __restrict__ out,
                                          long long f, int cnt,
                                          const uint32_t (&w)[4], int lane) {
  int m[4], slot[4];
  int queued = 0;   // the same in every lane
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = min((int)(w[j] >> 16), n);
    const int c = min((int)(w[j] & 0xFFFFu), n);
    m[j] = lane_lcp(st, p, c, 0, kFirst);
    const bool lng = j < cnt && m[j] == kFirst;
    const unsigned ask = __ballot_sync(~0u, lng);
    slot[j] = queued + __popc(ask & ((1u << lane) - 1u));
    if (lng) queue[slot[j]] = w[j];
    queued += __popc(ask);
  }
  if (queued) {
    __syncwarp();
    warp_finish(st, n, queue, queued, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cnt && m[j] == kFirst) m[j] = (int)queue[slot[j]];
    __syncwarp();   // every lane has its results before the queue is reused
  }
  if (cnt == 4) {
    __stcs(reinterpret_cast<int4*>(out + f),
           make_int4(m[0], m[1], m[2], m[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cnt) out[f + j] = m[j];
  }
}

// the 4 pair words of group g of a body from flat index f0, or 0s past g1
__device__ __forceinline__ void load_group(const int32_t* __restrict__ pc,
                                           long long f0, long long g,
                                           long long g1, uint32_t (&w)[4]) {
  int4 v = make_int4(0, 0, 0, 0);
  if (g < g1) v = __ldcs(reinterpret_cast<const int4*>(pc + f0 + 4 * g));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// grid (split, B): CTA x of block b takes the block's pair words in 4-word
// groups [x * per, (x + 1) * per) of the 16-byte aligned body, a lane's
// next group loaded while it compares the current one (the first before
// the stage lands); CTA 0's warp 0 also the at most 3 words before the
// body and 3 after it.
__global__ void __launch_bounds__(kLcpThreads, 1) lcp_kernel(
    const uint8_t* __restrict__ blk, long long L, int n,
    const int32_t* __restrict__ pc, int32_t* __restrict__ out,
    long long NP) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint32_t queues[kLcpWarps][kQueue];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* queue = queues[warp];
  const long long R = (long long)b * NP;
  const long long head = min((4 - (R & 3)) & 3, NP);
  const long long G = (NP - head) >> 2;
  const long long per = (G + gridDim.x - 1) / gridDim.x;
  const long long g0 = min(G, (long long)blockIdx.x * per);
  const long long g1 = min(G, g0 + per);
  const long long f0 = R + head;
  uint32_t w[4];
  long long g = g0 + warp * 32;
  load_group(pc, f0, g + lane, g1, w);
  stage_block(stage, blk + (long long)b * L, n, &bar);
  for (; g < g1; g += kLcpThreads) {
    uint32_t next[4];
    load_group(pc, f0, g + kLcpThreads + lane, g1, next);
    lcp_round(stage, n, queue, out, f0 + 4 * (g + lane),
              g + lane < g1 ? 4 : 0, w, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = next[j];
  }
  if (blockIdx.x == 0 && warp == 0) {   // the row's unaligned edges
    const long long tail = NP - head - 4 * G;
    const long long f = lane < head ? R + lane : R + 4 * G + lane;
    const int cnt = lane < head + tail ? 1 : 0;
    w[0] = cnt ? (uint32_t)__ldcs(pc + f) : 0u;
    w[1] = w[2] = w[3] = 0u;
    lcp_round(stage, n, queue, out, f, cnt, w, lane);
  }
}

// Dynamic shared memory of the walk's shared form for a row of P steps:
// the uint16 steps from a 16-byte boundary, then the words of the visit
// marks and of the record bitmap (encode_kernels.walk_plan computes the
// same bytes).
__host__ __device__ constexpr long long walk_smem(long long P) {
  return (2 * P + 15) / 16 * 16 + 8 * ((P + 31) / 32);
}

// A step clamped to [1, hi], hi = max(P, 2): it records where the step
// is over 1 and advances the same as one clamped to [1, P] (next() stops
// at P), also for P = 1.
__device__ __forceinline__ int walk_clamp(int v, int hi) {
  return v < 1 ? 1 : (v > hi ? hi : v);
}

// One block's row as the walk reads it: the clamped step at p, from the
// staged uint16 row (shared form: the step minus 1) or from global memory.
template <bool kShared>
struct WalkRow {
  const uint16_t* d;
  const int32_t* s;
  int P, hi;
  __device__ __forceinline__ int step(int p) const {
    if (kShared) return (int)d[p] + 1;
    return walk_clamp(__ldg(s + p), hi);
  }
  // the position after p; P for any position past the row
  __device__ __forceinline__ int next(int p, int st) const {
    return st >= P - p ? P : p + st;
  }
};

// the first position in [p, lim) whose bit is set, or lim
__device__ __forceinline__ int next_set(const uint32_t* bits, int p,
                                        int lim) {
  if (p >= lim) return lim;
  int w = p >> 5;
  const int last = (lim - 1) >> 5;
  uint32_t m = bits[w] & (~0u << (p & 31));
  while (!m) {
    if (++w > last) return lim;
    m = bits[w];
  }
  return min((w << 5) + __ffs(m) - 1, lim);
}

// set the bits of [p, q)
__device__ __forceinline__ void set_range(uint32_t* bits, int p, int q) {
  while (p < q) {
    const int lo = p & 31, n = min(32 - lo, q - p);
    bits[p >> 5] |= (n == 32 ? ~0u : ((1u << n) - 1u) << lo);
    p += n;
  }
}

// the words of chunk [c0, c1), c0 a multiple of 32: its thread's own
__device__ __forceinline__ void clear_marks(uint32_t* M, int c0, int c1) {
  for (int w = c0 >> 5; w <= (c1 - 1) >> 5; ++w) M[w] = 0u;
}

// The walk from p to the first position at or past c1, marking each
// position it visits in M; a run of steps of 1 (no bit in the record
// bitmap G) is marked a word at a time.
template <bool kShared>
__device__ int walk_marking(const WalkRow<kShared>& row, uint32_t* M,
                            const uint32_t* G, int p, int c1) {
  while (p < c1) {
    const int st = row.step(p);
    if (st > 1) {
      M[p >> 5] |= 1u << (p & 31);
      p = row.next(p, st);
    } else {
      const int r = next_set(G, p, c1);
      set_range(M, p, r);
      p = r;
    }
  }
  return p;
}

// The walk from p to its first marked position in [p, c1), which it
// returns (or its exit, at or past c1, when it meets no mark); n counts
// the records it passes before.
template <bool kShared>
__device__ int walk_to_mark(const WalkRow<kShared>& row, const uint32_t* M,
                            const uint32_t* G, int p, int c1, int& n) {
  while (p < c1) {
    const int st = row.step(p);
    if ((M[p >> 5] >> (p & 31)) & 1u) return p;
    if (st > 1) {
      ++n;
      p = row.next(p, st);
    } else {
      const int r = next_set(G, p, c1);
      const int m = next_set(M, p + 1, r);
      if (m < r) return m;
      p = r;
    }
  }
  return p;
}

// the records of the marked path from q to c1: the marked bits of G
__device__ __forceinline__ uint32_t marked_records(const uint32_t* M,
                                                   const uint32_t* G, int w,
                                                   int q, int c1) {
  uint32_t m = M[w] & G[w];
  if (w == q >> 5) m &= ~0u << (q & 31);
  if (w == (c1 - 1) >> 5 && (c1 & 31)) m &= (1u << (c1 & 31)) - 1u;
  return m;
}

template <bool kShared>
__global__ void __launch_bounds__(kWalkThreads) parse_walk_kernel(
    const int32_t* __restrict__ step, int P, int CAP, int chunk,
    int max_rounds, int32_t* __restrict__ nseq, int32_t* __restrict__ pos,
    uint32_t* __restrict__ gbits, int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int exits[kWalkThreads];
  __shared__ int sums[kWalkThreads / 32];
  __shared__ int first_changed;
  const int b = blockIdx.x, k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int32_t* sb = step + (long long)b * P;
  const int nch = (int)(((long long)P + chunk - 1) / chunk);
  const int words = (int)(((long long)P + 31) >> 5);
  const int hi = P < 2 ? 2 : P;
  WalkRow<kShared> row{nullptr, sb, P, hi};
  uint32_t *M, *G;
  // rows of a multiple of 32 steps from a 16-byte boundary: 16-byte loads
  const bool vec = kShared && !((uintptr_t)sb & 15) && !(P & 31);
  if (kShared) {
    M = reinterpret_cast<uint32_t*>(smem + (2 * P + 15) / 16 * 16);
  } else {
    M = gbits + (long long)b * 2 * words;
  }
  G = M + words;
  if (vec) {   // (1) stage, 8 loads of 16 bytes in flight a thread; the
               // record bitmap from them, 8 lanes a word
    uint16_t* d = reinterpret_cast<uint16_t*>(smem);
    const int n4 = P >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(sb);
    for (int i0 = warp * 32; i0 < n4; i0 += 8 * kWalkThreads) {
      int4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kWalkThreads + lane;
        v[u] = i < n4 ? __ldcs(s4 + i) : make_int4(1, 1, 1, 1);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kWalkThreads + lane;
        const ushort4 o = make_ushort4(
            walk_clamp(v[u].x, hi) - 1, walk_clamp(v[u].y, hi) - 1,
            walk_clamp(v[u].z, hi) - 1, walk_clamp(v[u].w, hi) - 1);
        uint32_t g = ((o.x > 0) | (o.y > 0) << 1 | (o.z > 0) << 2 |
                      (o.w > 0) << 3) << (4 * (lane & 7));
        g |= __shfl_xor_sync(~0u, g, 1);
        g |= __shfl_xor_sync(~0u, g, 2);
        g |= __shfl_xor_sync(~0u, g, 4);
        if (i < n4) {
          reinterpret_cast<ushort4*>(d)[i] = o;
          if (!(lane & 7)) G[i >> 3] = g;
        }
      }
    }
    row.d = d;
  } else {
    if (kShared) {   // (1) stage
      uint16_t* d = reinterpret_cast<uint16_t*>(smem);
      for (int i = k; i < P; i += kWalkThreads) d[i] = walk_clamp(sb[i], hi) - 1;
      row.d = d;
      __syncthreads();
    }
    // the record bitmap, a word a warp at a time
#pragma unroll 4
    for (int w = warp; w < words; w += kWalkThreads / 32) {
      const int p = (w << 5) + lane;
      const uint32_t g = __ballot_sync(~0u, p < P && row.step(p) > 1);
      if (lane == 0) G[w] = g;
    }
  }
  const bool mine = k < nch;
  const int c0 = mine ? k * chunk : P;
  const int c1 = mine ? (int)min((long long)c0 + chunk, (long long)P) : P;
  if (mine) clear_marks(M, c0, c1);
  __syncthreads();

  // (2) speculate from the chunk's first position
  int entry = c0, ex = c0;
  if (mine) exits[k] = ex = walk_marking(row, M, G, c0, c1);
  __syncthreads();

  // (3) synchronize; (4) the serial finish
  int rounds = 0, serial_from = -1;
  for (;;) {
    const int e = (mine && k > 0) ? exits[k - 1] : 0;
    if (k == 0) first_changed = nch;
    __syncthreads();
    bool changed = false;
    if (mine && e != entry) {
      entry = e;
      int nx = e;                        // past the chunk: no positions
      if (e < c1) {
        int n = 0;
        nx = walk_to_mark(row, M, G, e, c1, n);
        if (nx < c1) {
          nx = ex;                       // the marked path's exit
        } else {                         // a new path: its marks only
          clear_marks(M, c0, c1);
          walk_marking(row, M, G, e, c1);
        }
      } else {
        clear_marks(M, c0, c1);
      }
      if (nx != ex) {
        exits[k] = ex = nx;
        changed = true;
        atomicMin(&first_changed, k);
      }
    }
    ++rounds;
    const int n = __syncthreads_count(changed);
    if (n == 0) break;
    if (rounds >= max_rounds || 2 * n > nch) {
      if (k == 0) {   // every chunk before first_changed + 1 is settled
        int c = first_changed;
        int p = exits[c];
        serial_from = c + 1;
        for (++c; c < nch; ++c) {   // an entry on the marked path: its exit
          const int e1 = (int)min((long long)(c + 1) * chunk, (long long)P);
          if (p < e1 && ((M[p >> 5] >> (p & 31)) & 1u))
            p = exits[c];
          else
            while (p < e1) p = row.next(p, row.step(p));
          exits[c] = p;
        }
      }
      __syncthreads();
      break;
    }
  }

  // (5) count, scan, write from the true entries: the walk up to its
  // first marked position q, then the marked path's records from q on
  const int ent = k == 0 ? 0 : (mine ? exits[k - 1] : P);
  int cnt = 0;
  const int q = walk_to_mark(row, M, G, ent, c1, cnt);
  if (q < c1)
    for (int w = q >> 5; w <= (c1 - 1) >> 5; ++w)
      cnt += __popc(marked_records(M, G, w, q, c1));
  int inc = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += v;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int total = sums[kWalkThreads / 32 - 1];
  int j = (warp ? sums[warp - 1] : 0) + inc - cnt;
  int32_t* pb = pos + (long long)b * CAP;
  auto emit = [&](int p) {
    if (j < CAP - 1 || j == total - 1) pb[min(j, CAP - 1)] = p;
    ++j;
  };
  const int lim = min(q, c1);
  for (int p = ent; p < lim;) {
    const int st = row.step(p);
    if (st > 1) {
      emit(p);
      p = row.next(p, st);
    } else {
      p = next_set(G, p, lim);
    }
  }
  if (q < c1)
    for (int w = q >> 5; w <= (c1 - 1) >> 5; ++w)
      for (uint32_t m = marked_records(M, G, w, q, c1); m; m &= m - 1)
        emit((w << 5) + __ffs(m) - 1);
  if (k == 0) {
    nseq[b] = total;
    if (stats) {
      stats[2 * b] = rounds;
      stats[2 * b + 1] = serial_from;
    }
  }
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t (0 = launched) and launches on
// `stream`. Shapes, types and alignment are checked by the Python wrapper.

// blk (B, L) uint8 with L % 16 == 0, 0 <= n <= min(L, 65536); pc, out
// (B, NP) int32; blk, pc and out 16-byte aligned; `split` CTAs a block
// (encode_kernels.lcp_plan), 1 to 65535, and B at most 65535. A geometry
// the kernel cannot run gives cudaErrorInvalidValue.
int zxc_lcp(const uint8_t* blk, const int32_t* pc, int32_t* out, int B,
            long long L, int n, long long NP, int split, void* stream) {
  if (B < 0 || B > 65535 || NP < 0 || n < 0 || n > kMaxBlock || n > L ||
      (L & 15) || split < 1 || split > 65535 ||
      (((uintptr_t)blk | (uintptr_t)pc | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NP == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      lcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lcp_stage_bytes(kMaxBlock));
  if (e != cudaSuccess) return (int)e;
  lcp_kernel<<<dim3((unsigned)split, B), kLcpThreads, lcp_stage_bytes(n),
               (cudaStream_t)stream>>>(blk, L, n, pc, out, NP);
  return (int)cudaGetLastError();
}

// step (B, P) int32; nseq (B,) int32; pos (B, CAP) int32, CAP >= 1; only
// pos[b, :min(nseq[b], CAP)] is written. The geometry is
// encode_kernels.walk_plan's: chunks of `chunk` positions (a multiple of
// 32, at most 1024 chunks); `shared` 1 for the shared form (P <= 65536,
// `smem` bytes of dynamic shared memory), 0 for the global form, whose
// bitmaps are `bits`, a scratch of B * 2 * ceil(P / 32) words; the serial finish
// after `max_rounds` rounds. `stats` (B, 2) int32 or null: each block's
// rounds and the first chunk it walked serially (-1: none). A geometry the
// kernel cannot run gives cudaErrorInvalidValue.
int zxc_parse_walk(const int32_t* step, int32_t* nseq, int32_t* pos,
                   uint32_t* bits, int32_t* stats, int B, int P, int CAP,
                   int chunk, int shared, int smem, int max_rounds,
                   void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || P < 0 || CAP < 1 || max_rounds < 1 || chunk < 32 ||
      chunk % 32 || ((long long)P + chunk - 1) / chunk > kWalkThreads)
    return bad;
  if (shared ? (P > kWalkSharedMax || smem != walk_smem(P))
             : (smem != 0 || bits == nullptr))
    return bad;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const cudaError_t e = cudaFuncSetAttribute(
        parse_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    parse_walk_kernel<true><<<B, kWalkThreads, smem, s>>>(
        step, P, CAP, chunk, max_rounds, nseq, pos, nullptr, stats);
  } else {
    parse_walk_kernel<false><<<B, kWalkThreads, 0, s>>>(
        step, P, CAP, chunk, max_rounds, nseq, pos, bits, stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
