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
// is one dependent load (index, then table), no arithmetic. The floor is
// the index read and the output write at 3.35 TB/s, plus the table's
// distinct elements read once. But a random 4-byte table read costs the L2
// a 32-byte sector, so reading the table from L2 moves 8x the output's
// bytes. Both probes' functions (gather_axis1 and the grid form's
// gather_grid, whose `tile` is only checked) run the same two kernels in
// the geometry of probes.grid_plan, whose rule was set by measurement
// (python3 -m zxc_tpu_torch.gather_ab, NVIDIA H100 80GB HBM3 at 700 W):
// the cluster form where a row fits a cluster and the index reads each row
// element 4 times or more (x (8, 64K) with idx (8, 256K): 0.0121 ms
// against the L2 form's best 0.0123; the grid probe's idx (8, 512K):
// 0.0195 against 0.0214), else the L2 form (idx (8, 128K): 0.0085 against
// the cluster form's 0.0088; every shape of gather_axis1's probe, a square
// index: 0.0027 to 0.0369 ms, and 0.0049 to 0.0270 for the cluster form
// where a row fits a cluster).
//
// The cluster form holds the row in shared memory: a cluster of K <= 8
// CTAs (1024 threads each) is assigned one row i and a run of its index
// columns; each CTA fills its contiguous slice of the row (`slice`
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
// (walk_gather_ab.py --ablate, grid_dsmem); a cluster of 16 CTAs holding a
// 2 MiB row took 0.21 ms, every CTA reading all its row's index columns.
// Enough clusters a row fill the card's SMs (probes.grid_plan).
//
// The L2 form takes about one CTA an SM (one a row where M exceeds the
// SMs), each a contiguous run of `cols` index columns of one row, in
// passes of 16 columns a thread (the widest CTA of 64-512 threads whose
// pass fits the run): a CTA's table reads stay within its row, so rows of
// up to a few hundred KiB are served from the SM's L1 (x (64, 64K): 0.0213
// ms at 2 CTAs a row against 0.0372 at 16). Each thread issues its 16
// index loads and 16 table loads before its stores, with 16-byte index
// loads and output stores where the rows are aligned; index and output
// streams are loaded and stored evict-first so the table keeps its place
// in L2. Rows of 2 MiB (x (8, 512K)) miss L1: the random 32-byte sectors
// from L2 bound the kernel (0.0369 ms; the same kernel on indices within
// each row's first 256 KiB 0.0221, on idx[i, j] = j 0.0137), and an L2
// evict-last policy on the table reads or a bulk L2 prefetch of each
// CTA's share of its row moved it by under 0.3%, 32 columns a thread made
// it 3% slower.
//
// Form b of the row gather is a warp a row, probes.ROWS_PER_CTA["b"] warps
// a CTA: the warp loads its row's index from one address, then each lane
// copies 16 bytes for every 512 bytes of the row (a row of the probe's 128
// words is one load and one store a lane) where the table and the output
// start on 16 bytes and C % 4 == 0, else 4 bytes a lane; a row outside the
// table is written 0. At the probe's shape (1,024 rows of 512 B) 4 to 16
// warps a CTA read 0.0024 ms, 1 warp 0.0028 and 32 warps 0.0027; the same
// grid with the index loads and no copy 0.0021 (gather_ab): the launch and
// one dependent load round trip, not the bytes.
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

enum RowForm { kRowAtATime = 0, kIndirect = 1, kPipelined = 2 };

constexpr int kMaxRowWarps = 32;        // rows (warps) a CTA of form b

// form b: warp w of CTA k copies output row k * warps + w, 16 bytes a lane
// where kVec (table and out on 16 bytes, C % 4 == 0), else 4 bytes a lane
template <bool kVec>
__device__ __forceinline__ void copy_row(const int32_t* __restrict__ src,
                                         int32_t* __restrict__ dst, int C,
                                         bool ok, int lane) {
  if (kVec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll 4
    for (int c = lane; c < C / 4; c += 32)
      d[c] = ok ? __ldg(s + c) : make_int4(0, 0, 0, 0);
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += 32) dst[c] = ok ? __ldg(src + c) : 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxRowWarps * 32) gather_rows_warp_kernel(
    const int32_t* __restrict__ table, int R, int C,
    const int32_t* __restrict__ idx, int G, int32_t* __restrict__ out) {
  const long long g =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= G) return;
  const int32_t r = __ldg(idx + g);     // one address for the whole warp
  const bool ok = r >= 0 && r < R;
  copy_row<kVec>(table + (ok ? (long long)r * C : 0), out + g * C, C, ok,
                 threadIdx.x & 31);
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
constexpr int kGridCols = 16;           // index columns a thread takes at once
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxSlice = 200 << 10;    // bytes of its row a CTA may hold
constexpr uint32_t kFillPiece = 16 << 10;   // bytes a bulk copy of the fill
constexpr int kGridL2Cols = 16;         // columns a thread of the L2 form

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

// A thread's kCols columns of the CTA's pass starting at column cb, of a
// row whose index and output rows are 16-byte aligned and whose run ends
// at j1 (a multiple of 16 / sizeof(T)): 16-byte index loads, the table
// reads, then 16-byte stores. int32: kCols / 4 groups of 4 adjacent
// columns, uint8: kCols / 16 groups of 16, the groups strided by the
// CTA's width, so each load and store is coalesced.
template <int kCols, typename T, typename Row>
__device__ __forceinline__ void gather_pass_vec(
    const int32_t* __restrict__ ir, T* __restrict__ orow, long long cb,
    long long j1, const Row& row) {
  constexpr int kRun = sizeof(T) == 4 ? 4 : 16;   // columns of one store
  constexpr int kGroups = kCols / kRun;
  const long long t = threadIdx.x, nt = blockDim.x;
  long long c[kGroups];
  int4 iv[kCols / 4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) c[g] = cb + (g * nt + t) * kRun;
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    const long long at = c[q / (kRun / 4)] + 4 * (q % (kRun / 4));
    iv[q] = at < j1 ? __ldcs(reinterpret_cast<const int4*>(ir + at))
                    : make_int4(-1, -1, -1, -1);
  }
  T v[kCols];
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    v[4 * q] = row(iv[q].x);
    v[4 * q + 1] = row(iv[q].y);
    v[4 * q + 2] = row(iv[q].z);
    v[4 * q + 3] = row(iv[q].w);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (c[g] >= j1) continue;
    if constexpr (sizeof(T) == 4) {
      __stcs(reinterpret_cast<int4*>(orow + c[g]),
             make_int4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* b = v + 16 * g + 4 * q;
        w[q] = (uint32_t)b[0] | (uint32_t)b[1] << 8 | (uint32_t)b[2] << 16 |
               (uint32_t)b[3] << 24;
      }
      __stcs(reinterpret_cast<uint4*>(orow + c[g]),
             make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// the same for any alignment: kCols columns strided by the CTA's width
template <int kCols, typename T, typename Row>
__device__ __forceinline__ void gather_pass_scalar(
    const int32_t* __restrict__ ir, T* __restrict__ orow, long long cb,
    long long j1, const Row& row) {
  const long long t = threadIdx.x, nt = blockDim.x;
  int32_t k[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const long long c = cb + q * nt + t;
    k[q] = c < j1 ? __ldcs(ir + c) : -1;
  }
  T v[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) v[q] = row(k[q]);
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const long long c = cb + q * nt + t;
    if (c < j1) __stcs(orow + c, v[q]);
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

// grid (ceil(NI / cols), M): CTA (c, i) takes index columns [c * cols,
// (c + 1) * cols) of row i, in passes of kThreads * kGridL2Cols columns
template <int kThreads, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) gather_grid_l2_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int N, long long NI, long long cols) {
  const long long i = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * cols;
  const long long j1 = min(c0 + cols, NI);
  const GlobalTableRow<T> row{x + i * N, N};
  for (long long cb = c0; cb < j1; cb += kThreads * kGridL2Cols) {
    if (kVec)
      gather_pass_vec<kGridL2Cols>(idx + i * NI, out + i * NI, cb, j1, row);
    else
      gather_pass_scalar<kGridL2Cols>(idx + i * NI, out + i * NI, cb, j1,
                                      row);
  }
}

template <int kThreads, typename T>
void launch_l2(dim3 grid, const T* x, const int32_t* idx, T* out, int N,
               long long NI, long long cols, int vec, cudaStream_t s) {
  if (vec)
    gather_grid_l2_kernel<kThreads, T, true><<<grid, kThreads, 0, s>>>(
        x, idx, out, N, NI, cols);
  else
    gather_grid_l2_kernel<kThreads, T, false><<<grid, kThreads, 0, s>>>(
        x, idx, out, N, NI, cols);
}

template <typename T>
int launch_grid(const void* x, const int32_t* idx, void* out, int M, int N,
                long long NI, int form, int K, int clusters, int slice,
                long long cols, int vec, int smem, int threads,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (form == 0) {
    const dim3 grid((unsigned)clusters, (unsigned)M);
    if (threads == 64)
      launch_l2<64>(grid, xt, idx, ot, N, NI, cols, vec, s);
    else if (threads == 128)
      launch_l2<128>(grid, xt, idx, ot, N, NI, cols, vec, s);
    else if (threads == 256)
      launch_l2<256>(grid, xt, idx, ot, N, NI, cols, vec, s);
    else
      launch_l2<512>(grid, xt, idx, ot, N, NI, cols, vec, s);
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
// (M, NI), in the geometry of probes.grid_plan: `form` 1 the cluster form
// (clusters of K CTAs of `threads` = 1024, `clusters` a row, each CTA
// `slice` elements of its row in `smem` bytes of shared memory, each
// cluster `cols` index columns; vec 0), 0 the L2 form (K 1, `clusters`
// CTAs of `threads` (64, 128, 256 or 512) a row, `cols` index columns a
// CTA, a multiple of threads * kGridL2Cols; slice and smem 0; `vec` 1 for
// 16-byte index loads and output stores). gather_axis1 and gather_grid
// both launch here. A geometry the kernels cannot run gives
// cudaErrorInvalidValue.
int zxc_gather_grid(const void* x, const int32_t* idx, void* out, int M,
                    int N, long long NI, int esize, int form, int K,
                    int clusters, int slice, long long cols, int vec,
                    int smem, int threads, void* stream) {
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
        (threads != 64 && threads != 128 && threads != 256 &&
         threads != 512) ||
        cols % ((long long)threads * kGridL2Cols) ||
        clusters != (NI + cols - 1) / cols)
      return bad;
  } else if (vec || K < 1 || K > kMaxCluster || (K & (K - 1)) ||
             slice < 1 || (long long)slice * esize % 16 ||
             (long long)slice * esize > kMaxSlice ||
             (long long)K * slice < N || smem != slice * esize ||
             (long long)clusters * cols < NI ||
             (long long)K * clusters > 0x7fffffffll ||
             threads != kGridThreads) {
    return bad;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return esize == 1
      ? launch_grid<uint8_t>(x, idx, out, M, N, NI, form, K, clusters, slice,
                             cols, vec, smem, threads, s)
      : launch_grid<int32_t>(x, idx, out, M, N, NI, form, K, clusters, slice,
                             cols, vec, smem, threads, s);
}

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: table (R, C) int32, idx (G,) int32, out (G, C) int32;
// form 0 (a), 1 (b) or 2 (c); the geometry of probes.row_plan: `grid` CTAs
// of `rows_per_cta` rows, pieces of `piece` words, `stages` stages, `bulk`
// 1 for bulk copies (0: the edge path) and `smem` bytes of dynamic shared
// memory. Form b takes `rows_per_cta` warps a CTA (at most 32), a warp a
// row, piece C, no stage and no shared memory; its `bulk` 1 copies 16
// bytes a lane. A geometry the kernels cannot run gives
// cudaErrorInvalidValue.
int zxc_gather_rows(const int32_t* table, int R, int C, const int32_t* idx,
                    int G, int32_t* out, int form, int grid, int rows_per_cta,
                    int piece, int stages, int bulk, int smem, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (form < kRowAtATime || form > kPipelined || G < 0 || C < 0 || R < 0)
    return bad;
  if (G == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int max_rows = form == kIndirect ? kMaxRowWarps : kMaxRowsPerCta;
  if (rows_per_cta < 1 || rows_per_cta > max_rows ||
      grid != (G + (long long)rows_per_cta - 1) / rows_per_cta ||
      bulk < 0 || bulk > 1)
    return bad;
  const bool misaligned =
      (uintptr_t)table % 16 || (uintptr_t)out % 16 || C % 4;
  if (form == kIndirect) {
    if (piece != C || stages != 0 || smem != 0 || (bulk && misaligned))
      return bad;
    if (bulk)
      gather_rows_warp_kernel<true><<<grid, 32 * rows_per_cta, 0, s>>>(
          table, R, C, idx, G, out);
    else
      gather_rows_warp_kernel<false><<<grid, 32 * rows_per_cta, 0, s>>>(
          table, R, C, idx, G, out);
    return (int)cudaGetLastError();
  }
  if (form == kRowAtATime ? stages != 1
                          : (stages < 2 || stages > kMaxStages))
    return bad;
  if (piece < 1 || piece > C) return bad;
  if (bulk && (misaligned || piece % 4)) return bad;
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
