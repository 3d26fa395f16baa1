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
// were (the JAX kernel leaves them too). What bounds it: not bytes (a few
// MB a group, about 1.5 us) but the dependent chain of up to P steps a
// block. Design: one CTA per block. Loads and the walk alternate: the CTA
// loads a 47.9 KiB shared tile of step that starts at the cursor (so a
// long match skips bytes it never needs), then one thread walks the tile
// with shared-memory loads while the others wait at the barrier, and the
// next tile starts where that walk left the cursor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 256;          // 128 * ROUNDS of the JAX kernel
constexpr int kLcpThreads = 512;
constexpr int kMaxBlock = 65536;   // shared-memory stage of one block
constexpr int kWalkThreads = 256;
constexpr int kWalkTile = 12256;   // int32 steps per tile (static smem < 48 KiB)

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

__global__ void __launch_bounds__(kWalkThreads) parse_walk_kernel(
    const int32_t* __restrict__ step, int P, int CAP,
    int32_t* __restrict__ nseq, int32_t* __restrict__ pos) {
  __shared__ int32_t tile[kWalkTile];
  __shared__ int cursor, count;
  const int b = blockIdx.x;
  const int32_t* sb = step + (long long)b * P;
  int32_t* pb = pos + (long long)b * CAP;
  if (threadIdx.x == 0) {
    cursor = 0;
    count = 0;
  }
  __syncthreads();
  while (true) {
    const int base = cursor;
    if (base >= P) break;
    const int len = min(kWalkTile, P - base);
    for (int i = threadIdx.x; i < len; i += blockDim.x) tile[i] = sb[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int q = base, j = count;
      const int end = base + len;
      while (q < end) {
        const int s = tile[q - base];
        if (s > 1) {
          pb[min(j, CAP - 1)] = q;
          ++j;
        }
        q += min(max(s, 1), P);
      }
      cursor = q;
      count = j;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) nseq[b] = count;
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
// pos[b, :min(nseq[b], CAP)] is written.
int zxc_parse_walk(const int32_t* step, int32_t* nseq, int32_t* pos, int B,
                   int P, int CAP, void* stream) {
  if (B == 0) return 0;
  if (P < 0 || CAP < 1) return (int)cudaErrorInvalidValue;
  parse_walk_kernel<<<B, kWalkThreads, 0, (cudaStream_t)stream>>>(
      step, P, CAP, nseq, pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
