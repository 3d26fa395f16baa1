// Piece-serial copy engine for Hopper (sm_90a): the attic route of
// ops.decompress(use_serial=True, variant=1|2|3).
//
// Replaces the Pallas kernel of the JAX package's attic:
//   tools/kernel_attic.py serial_kernel_wrapped (pallas_call at :272), with
//   the bodies _kernel (v1, :40), _kernel_v2 (:161) and _kernel_v3 (:282).
//
// What it computes (the function of the three bodies, not their TPU
// schedule of SMEM staging by DMA, 1024-byte windows and vreg rolls).
// Block b has n = npieces[b] pieces, each four int32 words [o, c, s, k] in
// pcs (32 pieces a 128-word row, pieces in order of o, o not decreasing),
// and T = totals[b] output bytes. For output byte p < T, piece i is the
// last one with o_i <= p, and
//   p0 = max(o_i, 1024 * floor(p / 1024))
//   out[p] = lit[c_i + rem(p0 - s_i, k_i) + (p - p0)]
// with rem truncating (jax.lax.rem) and int32 arithmetic that wraps. That
// is the chunk-anchored phase of the JAX bodies: on the resolver's
// device_pure plans it equals lit[c + (p - s) % k]. A k below 1 counts as
// 1 (pack_blocks stores max(k, 1)). With fill_from_s (v2 and v3) a piece
// whose stored k is 1 is a fill of the byte s & 255 (the bodies splat s);
// v1 reads lit for it as for any piece. A lit index outside the
// block's lit row reads 0; a byte with no piece (p < o_0) and every byte
// from T to the end of the row is 0. n is clamped to the pieces pcs holds,
// T to [0, block].
//
// What bounds it on the card: the bytes are small (16 bytes a piece, each
// literal byte once, the output once: a few MB a dispatch group of 16
// blocks, about a microsecond at 3.35 TB/s). The work per byte is a binary
// search over the window's pieces and a dependent lit load. Design: one
// CTA per (block, 1024-byte output window), as the JAX bodies walk their
// windows; thread 0 finds the window's piece range [i0, i1) with two binary
// searches and shares it; each of 256 threads then takes 4 consecutive
// bytes, searches its first byte's piece in [i0, i1), steps to the next
// piece where one starts inside its 4 bytes, and stores the 4 bytes as one
// 32-bit word. Pieces are disjoint, so every byte is written exactly once
// and no atomics are needed. Whether the searches or the lit loads set the
// time is measured, not assumed (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 1024;
constexpr int kThreads = kWindow / 4;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// first j in [lo, hi) with o[4j] > x (o[4j] <= x for every j before it)
__device__ __forceinline__ int upper_bound(const int32_t* o, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (o[4 * mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) piece_serial_kernel(
    const int32_t* __restrict__ npieces, const int32_t* __restrict__ totals,
    const int32_t* __restrict__ pcs, int cap, const uint8_t* __restrict__ lit,
    long long lit_row, uint8_t* __restrict__ out, int block,
    int fill_from_s) {
  __shared__ int range[2];
  const int b = blockIdx.y;
  const int w0 = blockIdx.x * kWindow;
  const int32_t* pb = pcs + (long long)b * cap * 4;
  const uint8_t* lb = lit + (long long)b * lit_row;
  const int n = min(max(npieces[b], 0), cap);
  const int T = min(max(totals[b], 0), block);
  if (threadIdx.x == 0) {
    const int i0 = max(upper_bound(pb, 0, n, w0) - 1, 0);
    // first j >= i0 with o_j >= w0 + kWindow: o_j > w0 + kWindow - 1
    range[0] = i0;
    range[1] = upper_bound(pb, i0, n, w0 + kWindow - 1);
  }
  __syncthreads();
  const int i0 = range[0], i1 = range[1];
  const int p = w0 + 4 * threadIdx.x;
  uint32_t word = 0;
  if (p < T) {
    int j = upper_bound(pb, i0, i1, p) - 1;   // -1: p lies before o_0
    for (int q = 0; q < 4 && p + q < T; ++q) {
      const int pq = p + q;
      while (j + 1 < i1 && pb[4 * (j + 1)] <= pq) ++j;
      if (j < 0) continue;
      const int4 pc = *reinterpret_cast<const int4*>(pb + 4 * j);
      const int k = max(pc.w, 1);
      uint32_t v;
      if (fill_from_s && pc.w == 1) {
        v = (uint32_t)pc.z & 255u;
      } else {
        const int p0 = max(pc.x, pq & ~(kWindow - 1));
        const int idx = wrap_add(wrap_add(pc.y, wrap_sub(p0, pc.z) % k),
                                 pq - p0);
        v = (idx >= 0 && idx < lit_row) ? lb[idx] : 0u;
      }
      word |= v << (8 * q);
    }
  }
  if (p < block)
    *reinterpret_cast<uint32_t*>(out + (long long)b * block + p) = word;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched) and launches on `stream`. Shapes,
// types and alignment are checked by the Python wrapper: npieces, totals
// (B,) int32; pcs (B, cap / 32, 128) int32 with a 16-byte aligned base;
// lit (B, lit_row) uint8; out (B, block) uint8 with block % 1024 == 0.
int zxc_piece_serial(const int32_t* npieces, const int32_t* totals,
                     const int32_t* pcs, int cap, const uint8_t* lit,
                     long long lit_row, uint8_t* out, int B, int block,
                     int fill_from_s, void* stream) {
  if (B == 0 || block == 0) return 0;
  if (B < 0 || block < 0 || block % kWindow || cap < 0 || lit_row < 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  piece_serial_kernel<<<dim3(block / kWindow, B), kThreads, 0,
                        (cudaStream_t)stream>>>(
      npieces, totals, pcs, cap, lit, lit_row, out, block, fill_from_s);
  return (int)cudaGetLastError();
}

}  // extern "C"
