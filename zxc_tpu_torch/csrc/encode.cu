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
// 64 KiB, 5 candidates a position at level 3) moves the blocks once
// (1 MiB), a 4-byte word in and a 4-byte result out per pair (about
// 43 MB for 5.2 M pairs): some 13 us at 3.35 TB/s; the compares are a few
// integer operations a byte. Design: a CTA stages its block in shared
// memory (64 KiB at most, as 32-bit words) with 16-byte loads and masks
// the bytes past n; each thread then takes pairs, reads both sides as
// unaligned 4-byte windows (two shared words and a funnel shift, words
// past the block read 0) and stops at the first differing byte (__ffs of
// the XOR). Several CTAs share a block so the grid fills the card; each
// stages its own copy. Bank conflicts on random candidate addresses, and
// the warp waiting for its longest pair, are left for later work.
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
constexpr int kLcpThreads = 512;
constexpr int kMaxBlock = 65536;   // shared-memory stage of one block
constexpr int kWalkThreads = 1024;      // one chunk a thread
constexpr int kWalkSharedMax = 65536;   // rows staged as uint16 in shared memory

// 32-bit word k >= 0 of the zero-extended block (nw words hold bytes < n)
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int k,
                                            int nw) {
  return k < nw ? w[k] : 0u;
}

// bytes x .. x+3 of the zero-extended block, little endian, any x >= 0
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int x, int nw) {
  const int k = x >> 2;
  const int sh = (x & 3) * 8;
  return __funnelshift_r(word_at(w, k, nw), word_at(w, k + 1, nw), sh);
}

__global__ void __launch_bounds__(kLcpThreads) lcp_kernel(
    const uint8_t* __restrict__ blk, long long L, int n,
    const int32_t* __restrict__ pc, int32_t* __restrict__ out,
    long long NP) {
  extern __shared__ uint4 stage[];
  uint32_t* w = reinterpret_cast<uint32_t*>(stage);
  const int b = blockIdx.y;
  const int nw = (n + 3) >> 2;
  const int n16 = (n + 15) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(blk + (long long)b * L);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) stage[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0 && (n & 3))   // bytes n .. 4*nw-1 read 0
    w[nw - 1] &= (1u << (8 * (n & 3))) - 1u;
  __syncthreads();
  const long long row = (long long)b * NP;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < NP; i += (long long)gridDim.x * blockDim.x) {
    const uint32_t word = (uint32_t)pc[row + i];
    const int pp = (int)(word >> 16), cc = (int)(word & 0xFFFFu);
    int m = kCap;
    for (int r = 0; r < kCap; r += 4) {
      const uint32_t d = bytes4(w, pp + r, nw) ^ bytes4(w, cc + r, nw);
      if (d) {
        m = r + ((__ffs(d) - 1) >> 3);
        break;
      }
    }
    out[row + i] = m;
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

// blk (B, L) uint8 with L % 16 == 0 and a 16-byte aligned base,
// 0 <= n <= min(L, 65536); pc, out (B, NP) int32.
int zxc_lcp(const uint8_t* blk, const int32_t* pc, int32_t* out, int B,
            long long L, int n, long long NP, void* stream) {
  if (B == 0 || NP == 0) return 0;
  if (n < 0 || n > kMaxBlock || n > L || (L & 15)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = ((n + 15) >> 4) * 16;
  e = cudaFuncSetAttribute(lcp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxBlock);
  if (e != cudaSuccess) return (int)e;
  // about two waves of CTAs over the card, never more than the pairs need
  const long long per_block = (NP + kLcpThreads - 1) / kLcpThreads;
  long long split = (2LL * sms + B - 1) / B;
  if (split > per_block) split = per_block;
  if (split > 65535) split = 65535;
  lcp_kernel<<<dim3((unsigned)split, B), kLcpThreads, smem,
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
