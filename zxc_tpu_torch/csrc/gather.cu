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
// What bounds the row-wise gathers on the card: bytes. Each output element
// is one dependent load (index, then table), no arithmetic; the tables of
// the probes' shapes (at most 2 MB) stay in the 50 MB L2, so the floor is
// the index read and the output write at 3.35 TB/s, plus the table's
// distinct elements read once. Design: gather_axis1 is one thread an
// element, coalesced along the index row, CTAs over (column tile, row);
// the grid form has one CTA a column tile walk all M rows, as the TPU grid
// walks its steps. Form b of the row gather is one CTA a row, all at once.
//
// Forms a and c are schedules of the card's DMA engine, the bulk-copy unit
// of the Tensor Memory Accelerator, over a grid of CTAs of 128 threads.
// Each CTA takes a contiguous run of output rows and first loads the run's
// indices into shared memory in one coalesced load, so no copy waits on a
// dependent index load. One thread then walks the run's rows that lie in
// the table, each in pieces of at most one stage: `cp.async.bulk` global ->
// shared into a stage, completion on the stage's mbarrier (arrive with
// expect_tx, wait on its parity), then `cp.async.bulk` shared -> global in
// a bulk group. (a) is build_a's start-then-wait: one stage, and each copy
// in and each copy out is waited on before the next starts (`wait_group 0`
// after the store), so a CTA has one copy in flight. (c) is build_c's
// pipeline: a ring of S >= 2 stages, the copy in of the piece S - 1 ahead
// starts before the wait on the current one, whose copy out follows; a
// stage is refilled only after `wait_group.read` of its store. Rows, stage
// size and S come from the Python wrapper (probes.row_plan). Rows of 0 (an
// index outside the table) are written by the other threads straight to
// global memory, never through a stage. The edge path: a bulk copy needs
// 16-byte aligned addresses and a multiple of 16 bytes, so when the table
// or the output is not 16-byte aligned, or a row is not a multiple of 16
// bytes (C % 4 != 0), all 128 threads copy the run's rows with plain loads
// in the same launch. At the probes' shape (1,024 rows of 512 B, 0.000298
// ms of bytes) no form reaches its bound: what is left is the launch, the
// first index load and one load-store round trip per row of a CTA's run.

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

enum RowForm { kRowAtATime = 0, kIndirect = 1, kPipelined = 2 };

// form b: one CTA a row
__global__ void __launch_bounds__(kThreads) gather_rows_indirect_kernel(
    const int32_t* __restrict__ table, int R, int C,
    const int32_t* __restrict__ idx, int32_t* __restrict__ out) {
  const int32_t r = idx[blockIdx.x];
  const bool ok = r >= 0 && r < R;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    out[(long long)blockIdx.x * C + c] = ok ? table[(long long)r * C + c] : 0;
}

constexpr int kRowThreads = 128;        // a CTA of forms a and c
constexpr int kHelperStart = 32;        // zero rows: warps 1-3 of a bulk CTA
constexpr int kMaxStages = 8;
constexpr int kMaxRowsPerCta = 1024;
constexpr int kMaxSmem = 48 << 10;      // no opt-in attribute needed
constexpr long long kSpinLimit = 1ll << 24;   // tries before a trap

// Shared memory of a CTA of forms a and c: one mbarrier a stage, the run's
// indices, then (bulk copies only) the stages from a 128-byte boundary.
// probes.row_plan computes the same bytes.
__host__ __device__ constexpr int rows_stage_offset(int stages, int rows) {
  return (8 * stages + 4 * rows + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t global_addr(const void* p) {
  return (uint64_t)__cvta_generic_to_global(p);
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

// The CTA's bulk pieces in order: its run's rows inside the table, each in
// pieces of `piece` words (the last one shorter).
struct PieceCursor {
  const int32_t* rows;   // the run's indices, in shared memory
  int n, R, pieces;
  int j = 0, p = 0;      // row of the run, piece of the row
  __device__ void skip_zero_rows() {
    while (j < n && !(rows[j] >= 0 && rows[j] < R)) ++j;
  }
  __device__ bool valid() const { return j < n; }
  __device__ void next() {
    if (++p == pieces) { p = 0; ++j; skip_zero_rows(); }
  }
};

// Forms a (kSerial: one stage, every copy waited on) and c (a ring of
// `stages` >= 2). `bulk` = 0 is the edge path: every row by plain loads.
template <bool kSerial>
__global__ void __launch_bounds__(kRowThreads) gather_rows_bulk_kernel(
    const int32_t* __restrict__ table, int R, int C,
    const int32_t* __restrict__ idx, int G, int32_t* __restrict__ out,
    int rows_per_cta, int piece, int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 = shared_addr(smem);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + 8 * stages);
  const uint32_t stage0 =
      shared_addr(smem + rows_stage_offset(stages, rows_per_cta));
  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const int n = (int)min((long long)rows_per_cta, G - row0);
  for (int j = threadIdx.x; j < n; j += blockDim.x) rows[j] = idx[row0 + j];
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar0 + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (bulk && threadIdx.x == 0) {   // the issuing thread
    PieceCursor ld{rows, n, R, (C + piece - 1) / piece};
    ld.skip_zero_rows();
    PieceCursor st = ld;
    int issued = 0, done = 0;
    auto load = [&]() {
      const int s = issued % stages, c0 = ld.p * piece;
      const uint32_t bytes = 4u * min(piece, C - c0);
      const uint32_t bar = bar0 + 8 * s;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(stage0 + 4u * piece * s),
             "l"(global_addr(table + (long long)rows[ld.j] * C + c0)),
             "r"(bytes),
             "r"(bar) : "memory");
      ld.next();
      ++issued;
    };
    for (int k = 0; k < stages - 1 && ld.valid(); ++k) load();
    while (st.valid()) {
      if (ld.valid()) {
        // the stage to fill held piece done - 1: its store must have read it
        if (done > 0)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        load();
      }
      const int s = done % stages, c0 = st.p * piece;
      mbar_wait(bar0 + 8 * s, (done / stages) & 1);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(global_addr(out + (row0 + st.j) * C + c0)),
                      "r"(stage0 + 4u * piece * s),
                      "r"(4u * min(piece, C - c0)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (kSerial) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      st.next();
      ++done;
    }
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    return;
  }
  // rows of 0 (bulk) or every row (the edge path), by plain loads
  const int t0 = bulk ? kHelperStart : 0;
  if ((int)threadIdx.x < t0) return;
  for (int j = 0; j < n; ++j) {
    const int32_t r = rows[j];
    const bool ok = r >= 0 && r < R;
    if (bulk && ok) continue;
    int32_t* o = out + (row0 + j) * C;
    for (int c = threadIdx.x - t0; c < C; c += blockDim.x - t0)
      o[c] = ok ? table[(long long)r * C + c] : 0;
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
// form 0 (a), 1 (b) or 2 (c); the geometry of probes.row_plan: `grid` CTAs
// of `rows_per_cta` rows, pieces of `piece` words, `stages` stages, `bulk`
// 1 for bulk copies (0: the edge path) and `smem` bytes of dynamic shared
// memory. Form b takes grid G and one row a CTA. A geometry the kernels
// cannot run gives cudaErrorInvalidValue.
int zxc_gather_rows(const int32_t* table, int R, int C, const int32_t* idx,
                    int G, int32_t* out, int form, int grid, int rows_per_cta,
                    int piece, int stages, int bulk, int smem, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (form < kRowAtATime || form > kPipelined || G < 0 || C < 0 || R < 0)
    return bad;
  if (G == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == kIndirect) {
    if (grid != G || rows_per_cta != 1) return bad;
    gather_rows_indirect_kernel<<<G, kThreads, 0, s>>>(table, R, C, idx, out);
    return (int)cudaGetLastError();
  }
  if (rows_per_cta < 1 || rows_per_cta > kMaxRowsPerCta ||
      grid != (G + (long long)rows_per_cta - 1) / rows_per_cta)
    return bad;
  if (form == kRowAtATime ? stages != 1
                          : (stages < 2 || stages > kMaxStages))
    return bad;
  if (piece < 1 || piece > C || bulk < 0 || bulk > 1) return bad;
  if (bulk && ((uintptr_t)table % 16 || (uintptr_t)out % 16 || C % 4 ||
               piece % 4))
    return bad;
  const long long need = rows_stage_offset(stages, rows_per_cta) +
                         (bulk ? 4ll * piece * stages : 0);
  if (smem != need || smem > kMaxSmem) return bad;
  if (form == kRowAtATime)
    gather_rows_bulk_kernel<true><<<grid, kRowThreads, smem, s>>>(
        table, R, C, idx, G, out, rows_per_cta, piece, stages, bulk);
  else
    gather_rows_bulk_kernel<false><<<grid, kRowThreads, smem, s>>>(
        table, R, C, idx, G, out, rows_per_cta, piece, stages, bulk);
  return (int)cudaGetLastError();
}

}  // extern "C"
