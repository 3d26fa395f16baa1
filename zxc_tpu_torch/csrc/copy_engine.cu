// Copy-engine decode kernels v19, v26, v27 and v13 for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package:
//   v19: zxc_tpu/ops/pallas_decode.py _make_kernel_v19 / v19_kernel
//   v26: zxc_tpu/ops/pallas_decode.py _make_kernel_v26 / v26_kernel
//   v27: zxc_tpu/ops/pallas_decode.py _make_kernel_v27 / v27_kernel
//   v13: zxc_tpu/ops/pallas_decode.py _kernel_v13 / v13_kernel
//
// What they compute (the contract, not the TPU formulation). For block b
// and tile t of kRows rows (128 for v19/v26/v27, 32 for v13), a
// (kRows,128) int32 tile starts at 0. The kernel runs quads
// q = qs[b,t] .. qs[b,t] + 2*((qs[b,t+1]-qs[b,t]) >> 1) - 1 (pair-unrolled:
// an odd trailing quad is skipped). Slot i (0..127) of quad q reads, for
// each plane j < K (K = 1 for v13), the control word
//   w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127], bat = 4q + (i>>5).
// Its source row is qbase[b,q] + (w_0 >>> 21) (logical shift) and its
// target row tq[b,q,i] (uint8; int32 for v13). Lane l is covered by plane
// j when ((w_j>>7)&127) <= l <= ((w_j>>14)&127); the roll is that of the
// highest covering plane, and a covered lane adds win[src, (l + roll) & 127]
// into tile[tgt, l]. After its quads the tile is stored to output rows
// t*kRows .. t*kRows+kRows-1, reduced mod 256 (uint8: what every consumer
// of the JAX kernel's int32 output does with it).
//   v19, v13: the window is lit8[b] (RLP rows).
//   v26: window rows < RLP are lit8[b]; row RLP + r is this block's own
//        output row r once its supertile has been stored, else 0 (the JAX
//        kernel zeroes that region at block start and appends each tile
//        after it is complete).
//   v27: v26 whose rows < RLP are flat[loff[b] + r] (one ragged lit
//        buffer for the whole group); a row with loff[b] < 0 or
//        loff[b] + r >= ROWS_TOT reads 0.
// A slot whose window-relative row exceeds 127, whose source row lies
// outside the window, whose target row lies outside the tile or whose quad
// lies outside [0, MAXQ) contributes nothing, so no control can make the
// kernel read or write outside its buffers or loop past MAXQ quads.
//
// What bounds it on the card: the work is an indexed gather and scatter
// over a few MB per dispatch group (control + windows + output), far
// below both the H100's 3.35 TB/s and its integer rate; the time goes to
// latency — each slot is a chain of dependent loads (control word ->
// source row) followed by shared-memory atomics — and to parallelism,
// since v26/v27 run one CTA per block (16 CTAs per group on 132 SMs).
// Design: one warp per slot, 4 lanes per thread. The warp loads the
// 128-byte source row once (one 4-byte word per thread, coalesced) and
// rotates it with two shuffles and a funnel shift per plane; the tile
// lives in shared memory as int32 and takes atomicAdd, so the add
// semantics hold exactly for any control. v19 and v13 grid over
// (tile, block); v26 and v27 loop over supertiles inside one CTA with
// __syncthreads() between them, reading earlier supertiles back from
// global memory. v27 reads its flat rows straight from global memory
// (staging the window in shared memory with TMA is later work). TMA,
// wgmma and occupancy tuning are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Window { kLit = 0, kSelfRef = 1, kFlatSelfRef = 2 };

template <typename TQ>
struct Args {
  const int32_t* qs;     // (B, NT+1)
  const int32_t* qbase;  // (B, MAXQ)
  const int32_t* loff;   // (B,) v27 only
  const int32_t* pctrl;  // (B, K*G32, 128)
  const TQ* tq;          // (B, MAXQ, 128)
  const uint8_t* lit8;   // (B, RLP, 128); v27: flat (ROWS_TOT, 128)
  uint8_t* out;          // (B, NT*kRows, 128); read back by v26/v27
  int NT, MAXQ, G32, K, RLP;
  int64_t rows_tot;      // v27 only
};

template <int kRows, int kWin, typename TQ>
__device__ void run_tile(const Args<TQ>& a, int b, int t, int32_t* tile) {
  const int NR = a.NT * kRows;
  for (int k = threadIdx.x; k < kRows * kRowBytes; k += blockDim.x)
    tile[k] = 0;
  __syncthreads();

  // quads [q0, q0 + 2*npairs) clipped to [0, MAXQ): quads outside it add
  // nothing, and the clip bounds the loop for any qs
  const int32_t* qs_b = a.qs + (size_t)b * (a.NT + 1);
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
  const uint8_t* out_b = a.out + (size_t)b * NR * kRowBytes;
  const int64_t win_rows = kWin == kLit ? a.RLP : (int64_t)a.RLP + NR;
  const int64_t stored_rows = (int64_t)t * kRows;   // v26/v27 only
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
    const size_t pidx = (size_t)(32 * (bat >> 7) + (i & 31)) * kRowBytes
                        + (bat & 127);
    const uint32_t w0 = (uint32_t)pc_b[pidx];
    const uint32_t rowrel = w0 >> 21;
    const int64_t tgt = a.tq[((size_t)b * a.MAXQ + q) * kRowBytes + i];
    const int64_t src = (int64_t)a.qbase[(size_t)b * a.MAXQ + q] + rowrel;
    if (rowrel >= 128 || tgt < 0 || tgt >= kRows || src < 0
        || src >= win_rows)
      continue;

    uint32_t word = 0;
    if (src < a.RLP) {
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
      a.out + ((size_t)b * NR + (size_t)t * kRows) * kRowBytes);
  for (int k = threadIdx.x; k < kRows * kRowBytes / 4; k += blockDim.x) {
    const int32_t* v = tile + 4 * k;
    dst[k] = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8)
             | ((uint32_t)(v[2] & 0xff) << 16)
             | ((uint32_t)(v[3] & 0xff) << 24);
  }
  // the stores must be visible to the next supertile's window reads
  // (v26/v27), and the tile must not be cleared while still being read
  __syncthreads();
}

// one CTA per (tile, block)
template <int kRows, typename TQ>
__global__ void __launch_bounds__(kThreads) tiled_kernel(Args<TQ> a) {
  extern __shared__ int32_t tile[];
  run_tile<kRows, kLit>(a, blockIdx.y, blockIdx.x, tile);
}

// one CTA per block, supertiles in order (self-referential window)
template <int kWin>
__global__ void __launch_bounds__(kThreads) self_ref_kernel(
    Args<uint8_t> a) {
  extern __shared__ int32_t tile[];
  for (int t = 0; t < a.NT; ++t)
    run_tile<128, kWin>(a, blockIdx.x, t, tile);
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
                  NST, MAXQ, G32, K, RLP, 0};
  return launch(tiled_kernel<128, uint8_t>, dim3(NST, B), 128, a, stream);
}

int zxc_copy_engine_v26(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const uint8_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NST,
                        int MAXQ, int G32, int K, int RLP, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NST, MAXQ, G32, K, RLP, 0};
  return launch(self_ref_kernel<kSelfRef>, dim3(B), 128, a, stream);
}

int zxc_copy_engine_v27(const int32_t* qs, const int32_t* qbase,
                        const int32_t* loff, const int32_t* pctrl,
                        const uint8_t* tq, const uint8_t* flat, uint8_t* out,
                        int B, int NST, int MAXQ, int G32, int K, int RLP,
                        int64_t rows_tot, void* stream) {
  if (B == 0 || NST == 0) return 0;
  Args<uint8_t> a{qs, qbase, loff, pctrl, tq, flat, out,
                  NST, MAXQ, G32, K, RLP, rows_tot};
  return launch(self_ref_kernel<kFlatSelfRef>, dim3(B), 128, a, stream);
}

int zxc_copy_engine_v13(const int32_t* qs, const int32_t* qbase,
                        const int32_t* pctrl, const int32_t* tq,
                        const uint8_t* lit8, uint8_t* out, int B, int NT,
                        int MAXQ, int G32, int RLP, void* stream) {
  if (B == 0 || NT == 0) return 0;
  Args<int32_t> a{qs, qbase, nullptr, pctrl, tq, lit8, out,
                  NT, MAXQ, G32, 1, RLP, 0};
  return launch(tiled_kernel<32, int32_t>, dim3(NT, B), 32, a, stream);
}

}  // extern "C"
