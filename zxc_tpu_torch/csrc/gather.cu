// Gather kernels for Hopper (sm_90a): the row-wise gather of
// tools/tpu_pallas_gather_probe.py and the row gather of
// tools/tpu_indirect_dma_probe.py.
//
// Replaces the Pallas kernels:
//   tools/tpu_pallas_gather_probe.py pallas_gather_axis1 (pallas_call at
//       :44) and pallas_gather_grid (:59): out[i, j] = x[i, idx[i, j]] for
//       x (M, N) int32 or uint8 and idx (M, NI) int32 ("promise_in_bounds");
//       the grid form walks the index columns in tiles of `tile`, the whole
//       table resident a step.
//   tools/tpu_indirect_dma_probe.py build_a, build_b and build_c (:56, :76,
//       :111): out[i] = table[idx[i]] for table (R, C) int32 and idx (G,)
//       int32, by one DMA a row in turn (a), one indirect DMA of all rows
//       (b) and a row DMA double-buffered behind the previous one (c).
// An index outside the table reads 0 (the JAX kernels leave it undefined).
//
// What bounds them on the card: bytes. Each output element is one
// dependent load (index, then table), no arithmetic; the tables of the
// probes' shapes (at most 2 MB) stay in the 50 MB L2, so the floor is the
// index read and the output write at 3.35 TB/s, plus the table's distinct
// elements read once. Design: gather_axis1 is one thread an element,
// coalesced along the index row, CTAs over (column tile, row); the grid
// form has one CTA a column tile walk all M rows, as the TPU grid walks its
// steps. The row gather keeps the TPU forms as schedules of one kernel:
// (a) one CTA copies row after row, a barrier between rows (start, wait);
// (b) one CTA a row, all at once; (c) one CTA holds the next row in
// registers while it stores the current one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kAxisTile = 4096;   // index columns a CTA of gather_axis1

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_axis1_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int M, int N, long long NI, long long tile,
    int rows_per_cta) {
  const long long c0 = (long long)blockIdx.x * tile;
  const long long c1 = min(c0 + tile, NI);
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(r0 + rows_per_cta, M);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (long long)r * N;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
      const int32_t k = idx[(long long)r * NI + j];
      out[(long long)r * NI + j] = (k >= 0 && k < N) ? xr[k] : T(0);
    }
  }
}

enum RowForm { kRowLoop = 0, kIndirect = 1, kDoubleBuffered = 2 };

template <int kForm>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const int32_t* __restrict__ table, int R, int C,
    const int32_t* __restrict__ idx, int G, int32_t* __restrict__ out) {
  if (kForm == kIndirect) {           // one CTA a row
    const int32_t r = idx[blockIdx.x];
    const bool ok = r >= 0 && r < R;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      out[(long long)blockIdx.x * C + c] =
          ok ? table[(long long)r * C + c] : 0;
    return;
  }
  if (kForm == kRowLoop) {            // one row at a time
    for (int i = 0; i < G; ++i) {
      const int32_t r = idx[i];
      const bool ok = r >= 0 && r < R;
      for (int c = threadIdx.x; c < C; c += blockDim.x)
        out[(long long)i * C + c] = ok ? table[(long long)r * C + c] : 0;
      __syncthreads();
    }
    return;
  }
  // double-buffered: a thread's columns of row i + 1 load before row i's
  // store (columns in chunks of the block)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int32_t r = G > 0 ? idx[0] : 0;
    int32_t cur = (G > 0 && r >= 0 && r < R) ? table[(long long)r * C + c] : 0;
    for (int i = 0; i < G; ++i) {
      int32_t next = 0;
      if (i + 1 < G) {
        const int32_t rn = idx[i + 1];
        if (rn >= 0 && rn < R) next = table[(long long)rn * C + c];
      }
      out[(long long)i * C + c] = cur;
      cur = next;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: x (M, N) of `esize` bytes (1 or 4), idx and out
// (M, NI); tile > 0 for the grid form (tile_cols != 0), NI % tile == 0.
int zxc_gather_axis1(const void* x, const int32_t* idx, void* out, int M,
                     int N, long long NI, int esize, long long tile_cols,
                     void* stream) {
  if (M == 0 || NI == 0) return 0;
  if (M < 0 || N < 0 || NI < 0 || tile_cols < 0 || (esize != 1 && esize != 4))
    return (int)cudaErrorInvalidValue;
  // gather_axis1: CTAs over (4096-column tile, row); the grid form: one CTA
  // a `tile_cols` tile, every row
  const long long tile = tile_cols ? tile_cols : kAxisTile;
  const int rows_per_cta = tile_cols ? M : 1;
  const dim3 grid((unsigned)((NI + tile - 1) / tile), tile_cols ? 1 : M);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (esize == 1)
    gather_axis1_kernel<uint8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(x), idx, static_cast<uint8_t*>(out), M, N,
        NI, tile, rows_per_cta);
  else
    gather_axis1_kernel<int32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(x), idx, static_cast<int32_t*>(out), M, N,
        NI, tile, rows_per_cta);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: table (R, C) int32, idx (G,) int32, out (G, C) int32;
// form 0 (a), 1 (b) or 2 (c).
int zxc_gather_rows(const int32_t* table, int R, int C, const int32_t* idx,
                    int G, int32_t* out, int form, void* stream) {
  if (form < kRowLoop || form > kDoubleBuffered)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0) return 0;
  if (G < 0 || C < 0 || R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == kIndirect)
    gather_rows_kernel<kIndirect><<<G, kThreads, 0, s>>>(table, R, C, idx, G,
                                                         out);
  else if (form == kRowLoop)
    gather_rows_kernel<kRowLoop><<<1, kThreads, 0, s>>>(table, R, C, idx, G,
                                                        out);
  else
    gather_rows_kernel<kDoubleBuffered><<<1, kThreads, 0, s>>>(table, R, C,
                                                               idx, G, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
