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
// element, coalesced along the index row, CTAs over (column tile, row).
// Form b of the row gather is one CTA a row, all at once.
//
// The grid form (gather_grid) follows the card, not the TPU grid's steps;
// its `tile` is only checked. A random 4-byte table read costs the L2 a
// 32-byte sector, so reading the table from L2 moves 8x the output's bytes.
// Its cluster form holds the row in shared memory instead: a cluster of K
// <= 8 CTAs (1024 threads each) is assigned one row i and a run of its
// index columns; each CTA fills its contiguous slice of the row (`slice`
// elements, at most 200 KiB) by cp.async.bulk copies of 16 KiB, all in
// flight on one mbarrier, where the slice's start is 16-byte aligned
// (plain loads for the rest). Then every CTA of the cluster reads all the
// cluster's index columns, 16 a thread at a time (coalesced 4-byte loads,
// all issued before the reads), and answers the indices of its own slice
// from its own shared memory; rank 0 writes 0 for indices outside the row.
// The cluster runs its CTAs at once, so one of them reads an index line
// from HBM and the others find it in L2. Reading the other CTAs' slices
// through distributed shared memory instead (mapa, ld.shared::cluster)
// was measured: random 4-byte remote reads took half the kernel's time
// (walk_gather_ab.py --ablate, grid_dsmem). Enough clusters a row fill the
// card's SMs (probes.grid_plan). Its L2 form, for rows too large for a
// cluster, takes CTAs of 256 threads over (4096-column chunk, row); each
// thread issues its 16 index loads and 16 table loads before its stores,
// with 16-byte index loads and output stores where the rows are aligned.
// Index and output streams of the L2 form are loaded and stored
// evict-first so the table keeps its place in L2.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kAxisTile = 4096;   // index columns a CTA of gather_axis1

// grid (ceil(NI / 4096), M)
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_axis1_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int N, long long NI) {
  const long long c0 = (long long)blockIdx.x * kAxisTile;
  const long long c1 = min(c0 + kAxisTile, NI);
  const long long r = blockIdx.y;
  const T* xr = x + r * N;
  for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
    const int32_t k = idx[r * NI + j];
    out[r * NI + j] = (k >= 0 && k < N) ? xr[k] : T(0);
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

// -- the grid form ----------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kGridThreads = 1024;      // a CTA of the cluster form
constexpr int kGridL2Threads = 256;     // a CTA of the L2 form
constexpr int kGridCols = 16;           // index columns a thread takes at once
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxSlice = 200 << 10;    // bytes of its row a CTA may hold
constexpr uint32_t kFillPiece = 16 << 10;   // bytes a bulk copy of the fill

// The cluster form's passes over index columns [j0, j1) of a row: 16
// columns a thread at a time, strided by the CTA's width (coalesced), all
// index loads before the reads; an index in [lo, lo + n) reads the CTA's
// own slice `part` and writes its output, one outside [0, N) writes 0
// where `zeros`, and any other is left to the CTA that holds it.
template <typename T>
__device__ __forceinline__ void owner_passes(
    const int32_t* __restrict__ ir, T* __restrict__ orow, long long j0,
    long long j1, const T* part, int lo, int n, int N, bool zeros) {
  const long long t = threadIdx.x, nt = blockDim.x;
  for (long long cb = j0; cb < j1; cb += nt * kGridCols) {
    int32_t k[kGridCols];
#pragma unroll
    for (int q = 0; q < kGridCols; ++q) {
      const long long c = cb + q * nt + t;
      k[q] = c < j1 ? __ldg(ir + c) : 0;
    }
#pragma unroll
    for (int q = 0; q < kGridCols; ++q) {
      const long long c = cb + q * nt + t;
      const uint32_t o = (uint32_t)k[q] - (uint32_t)lo;
      if (c < j1) {
        if (o < (uint32_t)n)
          orow[c] = part[o];
        else if (zeros && (uint32_t)k[q] >= (uint32_t)N)
          orow[c] = T(0);
      }
    }
  }
}

// element k of a row in global memory (through L2), 0 outside [0, N)
template <typename T>
struct GlobalTableRow {
  const T* x;
  int N;
  __device__ __forceinline__ T operator()(int k) const {
    return (unsigned)k < (unsigned)N ? __ldg(x + k) : T(0);
  }
};

// A thread's 16 columns of the CTA's pass starting at column cb, of a row
// whose index and output rows are 16-byte aligned and whose run ends at j1
// (a multiple of 16 / sizeof(T)): four 16-byte index loads, the 16 table
// reads, then 16-byte stores. int32: four groups of 4 columns strided by
// the CTA's width, so each load and store is coalesced; uint8: 16
// adjacent columns, one 16-byte store.
template <typename T, typename Row>
__device__ __forceinline__ void gather_pass_vec(
    const int32_t* __restrict__ ir, T* __restrict__ orow, long long cb,
    long long j1, const Row& row) {
  const long long t = threadIdx.x, nt = blockDim.x;
  long long c[4];
  int4 iv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c[q] = sizeof(T) == 4 ? cb + (q * nt + t) * 4 : cb + t * 16 + 4 * q;
    iv[q] = c[q] < j1 ? __ldcs(reinterpret_cast<const int4*>(ir + c[q]))
                      : make_int4(-1, -1, -1, -1);
  }
  T v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[4 * q] = row(iv[q].x);
    v[4 * q + 1] = row(iv[q].y);
    v[4 * q + 2] = row(iv[q].z);
    v[4 * q + 3] = row(iv[q].w);
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c[q] < j1)
        __stcs(reinterpret_cast<int4*>(orow + c[q]),
               make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = (uint32_t)v[4 * q] | (uint32_t)v[4 * q + 1] << 8 |
             (uint32_t)v[4 * q + 2] << 16 | (uint32_t)v[4 * q + 3] << 24;
    if (c[0] < j1)
      __stcs(reinterpret_cast<uint4*>(orow + c[0]),
             make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// the same for any alignment: 16 columns strided by the CTA's width
template <typename T, typename Row>
__device__ __forceinline__ void gather_pass_scalar(
    const int32_t* __restrict__ ir, T* __restrict__ orow, long long cb,
    long long j1, const Row& row) {
  const long long t = threadIdx.x, nt = blockDim.x;
  int32_t k[kGridCols];
#pragma unroll
  for (int q = 0; q < kGridCols; ++q) {
    const long long c = cb + q * nt + t;
    k[q] = c < j1 ? __ldcs(ir + c) : -1;
  }
  T v[kGridCols];
#pragma unroll
  for (int q = 0; q < kGridCols; ++q) v[q] = row(k[q]);
#pragma unroll
  for (int q = 0; q < kGridCols; ++q) {
    const long long c = cb + q * nt + t;
    if (c < j1) orow[c] = v[q];
  }
}

// grid (K * clusters, M), clusters of (K, 1, 1): CTA rank r of cluster c
// of row y holds elements [r * slice, (r + 1) * slice) of row y; every CTA
// of the cluster reads the cluster's index columns [c * cols, (c + 1) *
// cols) and writes the outputs whose element it holds (rank 0 also those
// outside the row), so no table read leaves the CTA. The cluster runs its
// CTAs at once: one reads an index line from HBM, the others find it in L2.
template <typename T>
__global__ void __launch_bounds__(kGridThreads) gather_grid_cluster_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int N, long long NI, int slice, long long cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const cg::cluster_group cluster = cg::this_cluster();
  T* part = reinterpret_cast<T*>(smem);
  const int rank = (int)cluster.block_rank();
  const long long i = blockIdx.y;
  const long long lo = (long long)rank * slice;
  const int n = (int)max(0ll, min((long long)slice, N - lo));
  const T* src = x + i * N + lo;
  const uint32_t bytes = (uint32_t)n * sizeof(T);
  const uint32_t body = ((uintptr_t)src & 15) ? 0u : bytes / 16 * 16;
  const uint32_t b = shared_addr(&bar);
  if (body && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (body && threadIdx.x == 0) {   // in pieces, all in flight at once
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(body) : "memory");
    for (uint32_t o = 0; o < body; o += kFillPiece)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(shared_addr(part) + o),
             "l"(global_addr(reinterpret_cast<const char*>(src) + o)),
             "r"(min(kFillPiece, body - o)), "r"(b)
          : "memory");
  }
  for (int e = body / sizeof(T) + threadIdx.x; e < n; e += blockDim.x)
    part[e] = src[e];
  if (body) mbar_wait(b, 0);
  __syncthreads();   // the slice is in place
  const long long j0 = (long long)(blockIdx.x / cluster.num_blocks()) * cols;
  owner_passes(idx + i * NI, out + i * NI, j0, min(j0 + cols, NI), part,
               (int)lo, n, N, rank == 0);
}

// grid (ceil(NI / 4096), M)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGridL2Threads) gather_grid_l2_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int N, long long NI) {
  const long long i = blockIdx.y;
  const long long cb = (long long)blockIdx.x * kGridL2Threads * kGridCols;
  const long long j1 = min(cb + kGridL2Threads * kGridCols, NI);
  const GlobalTableRow<T> row{x + i * N, N};
  if (kVec)
    gather_pass_vec(idx + i * NI, out + i * NI, cb, j1, row);
  else
    gather_pass_scalar(idx + i * NI, out + i * NI, cb, j1, row);
}

template <typename T>
int launch_grid(const void* x, const int32_t* idx, void* out, int M, int N,
                long long NI, int form, int K, int clusters, int slice,
                long long cols, int vec, int smem, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (form == 0) {
    const dim3 grid((unsigned)clusters, (unsigned)M);
    if (vec)
      gather_grid_l2_kernel<T, true><<<grid, kGridL2Threads, 0, s>>>(
          xt, idx, ot, N, NI);
    else
      gather_grid_l2_kernel<T, false><<<grid, kGridL2Threads, 0, s>>>(
          xt, idx, ot, N, NI);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(
      gather_grid_cluster_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * clusters), (unsigned)M, 1);
  cfg.blockDim = dim3(kGridThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gather_grid_cluster_kernel<T>, xt, idx, ot, N,
                         NI, slice, cols);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: x (M, N) of `esize` bytes (1 or 4), idx and out
// (M, NI). CTAs over (4096-column tile, row).
int zxc_gather_axis1(const void* x, const int32_t* idx, void* out, int M,
                     int N, long long NI, int esize, void* stream) {
  if (M == 0 || NI == 0) return 0;
  if (M < 0 || N < 0 || NI < 0 || (esize != 1 && esize != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((NI + kAxisTile - 1) / kAxisTile), M);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (esize == 1)
    gather_axis1_kernel<uint8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(x), idx, static_cast<uint8_t*>(out), N,
        NI);
  else
    gather_axis1_kernel<int32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(x), idx, static_cast<int32_t*>(out), N,
        NI);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: x (M, N) of `esize` bytes (1 or 4), idx and out
// (M, NI), in the geometry of probes.grid_plan: `form` 1 the cluster form
// (clusters of K CTAs, `clusters` a row, each CTA `slice` elements of its
// row in `smem` bytes of shared memory, each cluster `cols` index columns;
// vec 0), 0 the L2 form (K 1, `clusters` CTAs of 4096 columns a row, slice
// and smem 0; `vec` 1 for 16-byte index loads and output stores). A geometry the kernels cannot run gives
// cudaErrorInvalidValue.
int zxc_gather_grid(const void* x, const int32_t* idx, void* out, int M,
                    int N, long long NI, int esize, int form, int K,
                    int clusters, int slice, long long cols, int vec,
                    int smem, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (M < 0 || N < 0 || NI < 0 || (esize != 1 && esize != 4) ||
      (form != 0 && form != 1) || (vec != 0 && vec != 1))
    return bad;
  if (M == 0 || NI == 0) return 0;
  const int v = 16 / esize;    // columns of 16 bytes of output
  if (M > 65535 || clusters < 1 || cols < 1 ||
      (vec && ((uintptr_t)idx % 16 || (uintptr_t)out % 16 || NI % v)))
    return bad;
  if (form == 0) {
    if (K != 1 || slice != 0 || smem != 0 ||
        cols != (long long)kGridL2Threads * kGridCols ||
        clusters != (NI + cols - 1) / cols)
      return bad;
  } else if (vec || K < 1 || K > kMaxCluster || (K & (K - 1)) ||
             slice < 1 || (long long)slice * esize % 16 ||
             (long long)slice * esize > kMaxSlice ||
             (long long)K * slice < N || smem != slice * esize ||
             (long long)clusters * cols < NI ||
             (long long)K * clusters > 0x7fffffffll) {
    return bad;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return esize == 1
      ? launch_grid<uint8_t>(x, idx, out, M, N, NI, form, K, clusters, slice,
                             cols, vec, smem, s)
      : launch_grid<int32_t>(x, idx, out, M, N, NI, form, K, clusters, slice,
                             cols, vec, smem, s);
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
