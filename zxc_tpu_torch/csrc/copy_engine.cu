// Copy-engine decode kernels v19 and v26 for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package:
//   v19: zxc_tpu/ops/pallas_decode.py _make_kernel_v19 / v19_kernel
//   v26: zxc_tpu/ops/pallas_decode.py _make_kernel_v26 / v26_kernel
//
// What they compute (the contract, not the TPU formulation). For block b
// and 128-row supertile t, a (128,128) int32 tile starts at 0. The kernel
// runs quads q = qs[b,t] .. qs[b,t] + 2*((qs[b,t+1]-qs[b,t]) >> 1) - 1
// (pair-unrolled: an odd trailing quad is skipped). Slot i (0..127) of
// quad q reads, for each plane j < K, the control word
//   w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127], bat = 4q + (i>>5).
// Its source row is qbase[b,q] + (w_0 >>> 21) (logical shift) and its
// target row tq[b,q,i]. Lane l is covered by plane j when
// ((w_j>>7)&127) <= l <= ((w_j>>14)&127); the roll is that of the highest
// covering plane, and a covered lane adds win[src, (l + roll) & 127] into
// tile[tgt, l]. After its quads the tile is stored to output rows
// t*128 .. t*128+127, reduced mod 256 (uint8: what every consumer of the
// JAX kernel's int32 output does with it).
//   v19: the window is lit8[b] (RLP rows).
//   v26: window rows < RLP are lit8[b]; row RLP + r is this block's own
//        output row r once its supertile has been stored, else 0 (the JAX
//        kernel zeroes that region at block start and appends each tile
//        after it is complete).
// A slot whose window-relative row exceeds 127, whose source row lies
// outside the window, whose target row is >= 128 or whose quad lies
// outside [0, MAXQ) contributes nothing, so no control can make the
// kernel read or write outside its buffers or loop past MAXQ quads.
//
// What bounds it on the card: the work is an indexed gather and scatter
// over a few MB per dispatch group (control + windows + output), far
// below both the H100's 3.35 TB/s and its integer rate; the time goes to
// latency — each slot is a chain of dependent loads (control word ->
// source row) followed by shared-memory atomics — and to parallelism,
// since v26 runs one CTA per block (16 CTAs per group on 132 SMs).
// Design: one warp per slot, 4 lanes per thread. The warp loads the
// 128-byte source row once (one 4-byte word per thread, coalesced) and
// rotates it with two shuffles and a funnel shift per plane; the tile
// lives in shared memory as int32 and takes atomicAdd, so the add
// semantics hold exactly for any control. v19 grids over (supertile,
// block); v26 loops over supertiles inside one CTA with __syncthreads()
// between them, reading earlier supertiles back from global memory.
// TMA, wgmma and occupancy tuning are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;
constexpr int kTileRows = 128;
constexpr int kThreads = 1024;
constexpr int kTileBytes = kTileRows * kRowBytes * 4;   // int32 tile
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* qs;     // (B, NST+1)
  const int32_t* qbase;  // (B, MAXQ)
  const int32_t* pctrl;  // (B, K*G32, 128)
  const uint8_t* tq;     // (B, MAXQ, 128)
  const uint8_t* lit8;   // (B, RLP, 128)
  uint8_t* out;          // (B, NST*128, 128); read back by v26
  int NST, MAXQ, G32, K, RLP;
};

template <bool kSelfRef>
__device__ void run_supertile(const Args& a, int b, int t, int32_t* tile) {
  const int NR = a.NST * kTileRows;
  for (int k = threadIdx.x; k < kTileRows * kRowBytes; k += blockDim.x)
    tile[k] = 0;
  __syncthreads();

  // quads [q0, q0 + 2*npairs) clipped to [0, MAXQ): quads outside it add
  // nothing, and the clip bounds the loop for any qs
  const int32_t* qs_b = a.qs + (size_t)b * (a.NST + 1);
  const int64_t q0 = qs_b[t];
  int64_t npairs = ((int64_t)qs_b[t + 1] - q0) >> 1;
  if (npairs < 0) npairs = 0;
  const int64_t qlo = q0 < 0 ? 0 : q0;
  const int64_t qhi = q0 + 2 * npairs < a.MAXQ ? q0 + 2 * npairs : a.MAXQ;
  const int64_t nslots = qhi > qlo ? (qhi - qlo) * 128 : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int32_t* pc_b = a.pctrl + (size_t)b * a.K * a.G32 * kRowBytes;
  const uint8_t* lit_b = a.lit8 + (size_t)b * a.RLP * kRowBytes;
  const uint8_t* out_b = a.out + (size_t)b * NR * kRowBytes;
  const int64_t win_rows = kSelfRef ? (int64_t)a.RLP + NR : a.RLP;
  const int64_t stored_rows = (int64_t)t * kTileRows;   // v26 only

  // every branch below depends only on the slot, so it is warp-uniform
  // and the full-mask shuffles stay legal
  for (int64_t s = warp; s < nslots; s += nwarps) {
    const int64_t q = qlo + (s >> 7);
    const int i = (int)(s & 127);
    const int bat = 4 * (int)q + (i >> 5);
    const size_t pidx = (size_t)(32 * (bat >> 7) + (i & 31)) * kRowBytes
                        + (bat & 127);
    const uint32_t w0 = (uint32_t)pc_b[pidx];
    const uint32_t rowrel = w0 >> 21;
    const int tgt = a.tq[((size_t)b * a.MAXQ + q) * kRowBytes + i];
    const int64_t src = (int64_t)a.qbase[(size_t)b * a.MAXQ + q] + rowrel;
    if (rowrel >= 128 || tgt >= kTileRows || src < 0 || src >= win_rows)
      continue;

    uint32_t word = 0;
    if (!kSelfRef || src < a.RLP) {
      word = reinterpret_cast<const uint32_t*>(lit_b + src * kRowBytes)[lane];
    } else if (src - a.RLP < stored_rows) {
      word = reinterpret_cast<const uint32_t*>(
          out_b + (src - a.RLP) * kRowBytes)[lane];
    }

    uint32_t val = 0;
    unsigned cover = 0;
    for (int j = 0; j < a.K; ++j) {
      const uint32_t w = j == 0 ? w0
          : (uint32_t)pc_b[(size_t)j * a.G32 * kRowBytes + pidx];
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
      const int v = (val >> (8 * c)) & 0xff;
      if (((cover >> c) & 1) && v) atomicAdd(trow + c, v);
    }
  }
  __syncthreads();

  uint32_t* dst = reinterpret_cast<uint32_t*>(
      a.out + ((size_t)b * NR + (size_t)t * kTileRows) * kRowBytes);
  for (int k = threadIdx.x; k < kTileRows * kRowBytes / 4; k += blockDim.x) {
    const int32_t* v = tile + 4 * k;
    dst[k] = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8)
             | ((uint32_t)(v[2] & 0xff) << 16)
             | ((uint32_t)(v[3] & 0xff) << 24);
  }
  // the stores must be visible to the next supertile's window reads
  // (v26), and the tile must not be cleared while still being read
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) v19_kernel(Args a) {
  extern __shared__ int32_t tile[];
  run_supertile<false>(a, blockIdx.y, blockIdx.x, tile);
}

__global__ void __launch_bounds__(kThreads) v26_kernel(Args a) {
  extern __shared__ int32_t tile[];
  for (int t = 0; t < a.NST; ++t)
    run_supertile<true>(a, blockIdx.x, t, tile);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, const Args& a, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, kTileBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entries return a cudaError_t (0 = launched). Shapes are checked by
// the Python wrapper; B == 0 launches nothing.
int zxc_copy_engine_v19(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args a{qs, qbase, pctrl, tq, lit8, out, NST, MAXQ, G32, K, RLP};
  return launch(v19_kernel, dim3(NST, B), a, stream);
}

int zxc_copy_engine_v26(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args a{qs, qbase, pctrl, tq, lit8, out, NST, MAXQ, G32, K, RLP};
  return launch(v26_kernel, dim3(B), a, stream);
}

}  // extern "C"
