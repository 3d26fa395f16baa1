// The attic's decode kernels for Hopper (sm_90a): the piece-serial copy
// engine (v1-v3), the window merge (v4-v7) and the lane sum (v9-v11, and
// the ablations of v10's body that the probes of tools/ time).
//
// == Piece-serial copy engine: ops.decompress(use_serial=True,
// variant=1|2|3).
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
//
// == Window merge: attic.decode_blocks_v4 (variants 4-7).
//
// Replaces tools/kernel_attic.py v4_kernel (pallas_call at :483) with the
// bodies _kernel_v4 (:369), _kernel_v5 (:507), _kernel_v6 (:564) and
// _kernel_v7 (:615), which differ only in how they read their control.
// Op t of block b is four int32 words [srow, net, dlo | dhi << 16, f3]
// (zxch_window_ops / zxch_window_ops2). Window wi (1024 output bytes)
// starts from 0 and applies its ops in order, the last one winning; for
// each position pos in [dlo, dhi):
//   acc[pos] = f3 - 1                            if f3 > 0
//   acc[pos] = lit[r * 128 + mod(pos + net, W)]  otherwise
// and the output byte is the low byte of acc. W = 2048 (v4, a 16-row
// window of lit) or 1024 (v5-v7, 8 rows); r is srow as the JAX dynamic
// slice takes it: a negative start counts from the end of the block's rl
// lit rows, then the start is clamped to [0, rl - W / 128]. v4 and v5 walk
// ops [ws[wi], ws[wi+1]), v6 and v7 [U * floor(ws[wi] / U), U *
// floor(ws[wi+1] / U)) with U = 8 or 16. An op outside [0, cap) adds
// nothing.
//
// What bounds it: bytes are few (16 bytes an op, each literal byte once,
// the output once: 4,025,993 B for the first group of 16 blocks of
// 64 KiB in mode 4, 0.0012 ms at 3.35 TB/s), and so is the work: a packed
// plan's ops (about 124 a window) cover each output byte about once.
// Times below: lcp_merge_ab.py on an NVIDIA H100 80GB HBM3, 700.00 W,
// back to back. The earlier form of this kernel had each of 256 threads
// test every op of its window against its 4 bytes (about 32 K op tests
// for some 1 K byte writes a window), 0.0315 ms on that group.
//
// Design: one CTA per (block, window), 256 threads. (1) Cover: the
// window's ops are staged kMergeStage at a time (16 KiB); each op's
// clipped length max(0, min(dhi, 1024) - min(dlo, 1024)) goes through a
// block-wide exclusive scan, and the round's covered bytes from its last
// op that covers the whole window on (the ops before it cover nothing it
// does not) are shared out a contiguous share a warp, lanes on
// consecutive bytes; a lane finds its first byte's op by a binary search
// of the scan and steps on, and atomicMax-es the op's index into
// last[pos] (1024 int32 in shared memory from -1): the largest index is
// the last op in order, so any order of ops gives the last one. The work
// is the bytes the ops cover. (2) Resolve: each thread takes 4
// positions, reads last[], loads each position's op (from the stage when
// it lies in the last round, else through the read-only cache) and its
// lit byte, the 4 loads independent, and stores one 32-bit word; a
// position no op covers is 0.
//
// Measured (mode 4's first group, ms): the design 0.0112 (modes 5-7 the
// same); the launch, wstart reads and stores alone 0.0038; with the cover
// 0.0095; stage rounds of 256 ops 0.0112; a binary search a covered byte
// 0.0114. On a group whose 124 ops a window each cover the whole window:
// 0.0093, the earlier form 0.0812; without the skip to the last
// whole-window op 0.1000. The time is the launch and each CTA's chain of
// dependent loads and barriers, not bytes or issue.
//
// == Lane sum: attic.decode_blocks_v9 / v10 / v11.
//
// Replaces tools/kernel_attic.py v9_kernel (pallas_call at :831), v10_kernel
// (:989) and v11_kernel (:1102), and the ablations of v10's body that
// tools/tpu_v10_probe.py (build_kernel, :119) and tools/tpu_v12_ablate.py
// (build_kernel, :123) time. For 4096-byte tile t of block b (32 rows of
// 128 lanes), sublane k and lane l:
//   out[b, 32t + k, l] = low8( sum over bat of [s <= l <= e1]
//                                              * lit[row][(l + rl) & 127] )
// with the control word c = pctrl[b, 32 * (bat >> 7) + k, bat & 127]:
//   v9:      rl = c & 255, s = c >> 8 & 255, e1 = c >> 16 & 255,
//            row = rows[b, 32 * bat + k], normalised and clamped into the
//            lit rows as the dynamic slice does (lit is int32: its low byte
//            counts, which is all a sum mod 256 needs)
//   v10/v11: rl = c & 127, s = c >> 7 & 127, e1 = c >> 14 & 127,
//            row = (uint32)c >> 21; a row at or past the lit rows adds 0
//            (the TPU bodies gather rows by a one-hot bf16 matmul on the
//            MXU, which gives 0 there; the card reads the row)
// over batches [ts[b,t], ts[b,t] + 4 * floor((ts[b,t+1] - ts[b,t]) / 4))
// (v9, v10) or [t * layers, t * layers + 4 * floor(layers / 4)) (v11). The
// sum is int32 and wraps; a batch outside the control (v9: or the rows)
// adds nothing.
//   The probes (v10's layout and walk; u = (bat - ts[b,t]) & 3, the batch's
//   place in the body's group of 4, so slot 32u + k of the TPU body):
//   nomatmul: lit[32u + k][(l + rl) & 127] + row, masked (needs 128 rows);
//   noonehot: lit[32u + k][(l + rl) & 127], masked (0 past the rows);
//   nobcast:  every slot the word (3 << 14) | (200 << 21), no control read;
//   norotate: lit[row][l], masked; norotate_add (tpu_v12_ablate.py's
//             norotate): lit[row][l] + rl, masked (rl alone past the rows);
//   nomask:   lit[row][(l + rl) & 127] on every lane of every slot;
//   floor:    the control word itself on every lane (wrapping sum).
//
// What bounds it: bytes are few (4 bytes of control an op slot, each
// literal byte once, the output once: about 2.5 MB a group), and the work
// is one masked byte gather per (op, lane). Design: one CTA per (block,
// tile), 1024 threads: warp k owns sublane k, each thread 4 lanes; the
// tile's batches are staged 32 at a time (each thread loads one control
// word, and for v9 one row, coalesced along the batch index) into shared
// memory, then every warp walks them with its control word a broadcast
// (no divergence inside a warp), adds its masked bytes in registers and
// stores one 32-bit word a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 1024;
constexpr int kThreads = kWindow / 4;
constexpr int kMergeStage = 1024;            // window ops staged a round
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;
constexpr int kTileRows = kTile / 128;       // 32 sublanes, a warp each
constexpr int kLaneThreads = kTileRows * 32;
constexpr int kLaneStage = 32;               // batches staged a round

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

// floor(v / u) for u > 0
__device__ __forceinline__ long long floor_div(long long v, long long u) {
  const long long q = v / u;
  return (v % u != 0 && v < 0) ? q - 1 : q;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the probes' modes (kProduction: v9, v10, v11 by `mode`)
enum LaneProbe { kProduction = 0, kNoMatmul = 1, kNoOneHot = 2, kNoBcast = 3,
                 kNoRotate = 4, kNoRotateAdd = 5, kNoMask = 6, kFloor = 7 };
constexpr int kBcastWord = (3 << 14) | (200 << 21);   // nobcast's slot

// one slot of a lane-sum probe (v10's fields) into a thread's 4 lanes
template <int kProbe>
__device__ __forceinline__ void probe_add(int c, int u, int k, int l0,
                                          const uint8_t* lb, int rl,
                                          uint32_t* acc) {
  const int rot = c & 127, s = (c >> 7) & 127, e1 = (c >> 14) & 127;
  const int row = (int)((unsigned)c >> 21);
  const bool masked = kProbe != kNoMask && kProbe != kFloor;
  if (masked && (s > e1 || e1 < l0 || s > l0 + 3)) return;
  const int src_row = kProbe == kNoMatmul || kProbe == kNoOneHot
      ? 32 * u + k : row;
  const uint8_t* src = src_row < rl ? lb + (long long)src_row * 128 : nullptr;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = l0 + q;
    if (masked && (l < s || l > e1)) continue;
    uint32_t v;
    if (kProbe == kFloor) {
      v = (uint32_t)c;
    } else {
      const int lane =
          kProbe == kNoRotate || kProbe == kNoRotateAdd ? l : (l + rot) & 127;
      v = src ? src[lane] : 0u;
      if (kProbe == kNoMatmul) v += (uint32_t)row;
      if (kProbe == kNoRotateAdd) v += (uint32_t)rot;
    }
    acc[q] += v;
  }
}

__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return (a & 255u) | (b & 255u) << 8 | (c & 255u) << 16 | (d & 255u) << 24;
}

// A window's op index for each covered byte: the block-wide exclusive
// scan of the round's clipped op lengths into `first` (first[i] is op i's
// first covered byte, 4 ops a thread); returns the round's covered bytes.
// `full` (-1 before) takes the last op that covers the whole window.
__device__ __forceinline__ int scan_lengths(const int4* stage, int n,
                                            int* first, int* sums,
                                            int* full) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int len[4], s = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * threadIdx.x + q;
    len[q] = 0;
    if (i < n) {
      const int z = stage[i].z;
      len[q] = max(0, min((int)((unsigned)z >> 16), kWindow) -
                          min(z & 0xFFFF, kWindow));
      if (len[q] == kWindow) atomicMax(full, i);
    }
    s += len[q];
  }
  int inc = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? sums[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int v = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kWarps) sums[lane] = w;
  }
  __syncthreads();
  int x = (warp ? sums[warp - 1] : 0) + inc - s;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (4 * threadIdx.x + q < n) first[4 * threadIdx.x + q] = x;
    x += len[q];
  }
  return sums[kWarps - 1];
}

__global__ void __launch_bounds__(kThreads) window_merge_kernel(
    const int32_t* __restrict__ wstart, const int4* __restrict__ ops,
    int cap, const uint8_t* __restrict__ lit, int rl,
    uint8_t* __restrict__ out, int block, int wrows, int unroll) {
  __shared__ int4 stage[kMergeStage];
  __shared__ int first[kMergeStage];
  __shared__ int last[kWindow];     // the last op covering each position
  __shared__ int sums[kWarps];
  __shared__ int full;              // a round's last whole-window op
  const int nw = block / kWindow;
  const int b = blockIdx.y, wi = blockIdx.x;
  const int32_t* ws = wstart + (long long)b * (nw + 1);
  const long long t0 =
      clamp_ll(floor_div(ws[wi], unroll) * unroll, 0, cap);
  const long long t1 =
      clamp_ll(floor_div(ws[wi + 1], unroll) * unroll, 0, cap);
  const int4* ob = ops + (long long)b * cap;
  const uint8_t* lb = lit + (long long)b * rl * 128;
  const unsigned wmask = (unsigned)(wrows * 128 - 1);
  const int p = 4 * threadIdx.x;   // the thread's first byte in the window
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) last[p + q] = -1;
  // (1) cover: each round's covered bytes, found by a search of the scan,
  // take the op's index by atomicMax (the last op in order wins)
  long long lr = t1;   // where the last round starts
  for (long long c0 = t0; c0 < t1; c0 += kMergeStage) {
    const int n = (int)min((long long)kMergeStage, t1 - c0);
    lr = c0;
    __syncthreads();   // every thread is done with the previous round
    for (int i = threadIdx.x; i < n; i += kThreads) stage[i] = ob[c0 + i];
    if (threadIdx.x == 0) full = -1;
    __syncthreads();
    const int total = scan_lengths(stage, n, first, sums, &full);
    __syncthreads();
    // the bytes from the last op that covers the whole window on (the ops
    // before it cover nothing it does not), a warp a contiguous share, its
    // lanes on consecutive ones (consecutive positions of an op: no bank
    // conflicts); a lane finds its first byte's op by a binary search of
    // the scan, and the op of each later byte by stepping on
    const int j0 = full < 0 ? 0 : first[full];
    const int share = (total - j0 + kWarps - 1) / kWarps;
    const int j1 = min(total, j0 + (warp + 1) * share);
    int i = -1, at = 0;   // the lane's op, and its position less its byte
    for (int j = j0 + warp * share + lane; j < j1; j += 32) {
      if (i < 0) {
        int lo = 0, hi = n;   // the last op whose first covered byte <= j
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (first[mid] <= j) lo = mid + 1; else hi = mid;
        }
        i = lo - 1;
        at = min(stage[i].z & 0xFFFF, kWindow) - first[i];
      } else if (i + 1 < n && first[i + 1] <= j) {
        do ++i; while (i + 1 < n && first[i + 1] <= j);
        at = min(stage[i].z & 0xFFFF, kWindow) - first[i];
      }
      atomicMax(&last[at + j], (int)(c0 - t0) + i);
    }
  }
  __syncthreads();
  // (2) resolve: each position's op, from the stage when it lies in the
  // last round, and its byte
  uint32_t acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = last[p + q];
    acc[q] = 0u;
    if (t < 0) continue;
    const long long g = t0 + t;
    const int4 op = g >= lr ? stage[g - lr] : __ldg(ob + g);
    int r = op.x < 0 ? op.x + rl : op.x;
    r = min(max(r, 0), rl - wrows);
    acc[q] = op.w > 0 ? (uint32_t)(op.w - 1)
                      : lb[(long long)r * 128 +
                           (((unsigned)(p + q) + (unsigned)op.y) & wmask)];
  }
  *reinterpret_cast<uint32_t*>(out + (long long)b * block +
                               (long long)wi * kWindow + p) =
      pack_low_bytes(acc[0], acc[1], acc[2], acc[3]);
}

template <int kProbe>
__global__ void __launch_bounds__(kLaneThreads) lane_sum_kernel(
    const int32_t* __restrict__ ts, const int32_t* __restrict__ rows,
    int rows_len, const int32_t* __restrict__ pctrl, int g32,
    const uint8_t* __restrict__ lit, int lit_bytes, int rl,
    uint8_t* __restrict__ out, int block, int mode, int layers) {
  __shared__ int ctrl[kTileRows][kLaneStage];
  __shared__ int srow[kTileRows][kLaneStage];
  const int nt = block / kTile;
  const int b = blockIdx.y, t = blockIdx.x;
  const int k = threadIdx.x >> 5, lg = threadIdx.x & 31;
  long long b0, n;
  if (mode == 11) {
    b0 = (long long)t * layers;
    n = 4LL * (layers / 4);
  } else {
    const int32_t* tb = ts + (long long)b * (nt + 1);
    b0 = tb[t];
    n = 4 * floor_div((long long)tb[t + 1] - b0, 4);
  }
  long long cap = (long long)(g32 / kTileRows) * 128;
  if (mode == 9) cap = min(cap, (long long)(rows_len / kTileRows));
  const long long lo = clamp_ll(b0, 0, cap);
  const long long hi = clamp_ll(b0 + n, lo, cap);
  const int32_t* pb = pctrl + (long long)b * g32 * 128;
  const int32_t* rb = rows + (long long)b * rows_len;
  const uint8_t* lb = lit + (long long)b * rl * 128 * lit_bytes;
  const int l0 = 4 * lg;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (long long c0 = lo; c0 < hi; c0 += kLaneStage) {
    const int n_st = (int)min((long long)kLaneStage, hi - c0);
    __syncthreads();   // every warp is done with the previous round
    if (lg < n_st && kProbe != kNoBcast) {
      const long long bat = c0 + lg;
      ctrl[k][lg] = pb[(kTileRows * (bat >> 7) + k) * 128 + (bat & 127)];
      if (mode == 9) srow[k][lg] = rb[kTileRows * bat + k];
    }
    __syncthreads();
    for (int i = 0; i < n_st; ++i) {
      const int c = kProbe == kNoBcast ? kBcastWord : ctrl[k][i];
      if (kProbe != kProduction) {
        probe_add<kProbe>(c, (int)((c0 + i - b0) & 3), k, l0, lb, rl, acc);
        continue;
      }
      int rot, s, e1, row;
      if (mode == 9) {
        rot = c & 255;
        s = (c >> 8) & 255;
        e1 = (c >> 16) & 255;
        row = srow[k][i];
        row = min(max(row < 0 ? row + rl : row, 0), rl - 1);
      } else {
        rot = c & 127;
        s = (c >> 7) & 127;
        e1 = (c >> 14) & 127;
        row = (int)((unsigned)c >> 21);
        if (row >= rl) continue;
      }
      if (s > e1 || e1 < l0 || s > l0 + 3) continue;
      const uint8_t* src = lb + (long long)row * 128 * lit_bytes;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = l0 + q;
        if (l >= s && l <= e1) acc[q] += src[((l + rot) & 127) * lit_bytes];
      }
    }
  }
  *reinterpret_cast<uint32_t*>(
      out + (long long)b * block + ((long long)t * kTileRows + k) * 128 +
      l0) = pack_low_bytes(acc[0], acc[1], acc[2], acc[3]);
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

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: wstart (B, block / 1024 + 1) int32; ops (B, cap / 32,
// 128) int32 with a 16-byte aligned base; lit (B, rl, 128) uint8 with rl at
// least the mode's window rows; out (B, block) uint8; mode 4, 5, 6 or 7.
int zxc_window_merge(const int32_t* wstart, const int32_t* ops, int cap,
                     const uint8_t* lit, int rl, uint8_t* out, int B,
                     int block, int mode, void* stream) {
  int wrows, unroll;
  switch (mode) {
    case 4: wrows = 16; unroll = 1; break;
    case 5: wrows = 8; unroll = 1; break;
    case 6: wrows = 8; unroll = 8; break;
    case 7: wrows = 8; unroll = 16; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || block == 0) return 0;
  if (B < 0 || B > 65535 || block < 0 || block % kWindow || cap < 0 ||
      rl < wrows)
    return (int)cudaErrorInvalidValue;
  window_merge_kernel<<<dim3(block / kWindow, B), kThreads, 0,
                        (cudaStream_t)stream>>>(
      wstart, reinterpret_cast<const int4*>(ops), cap, lit, rl, out, block,
      wrows, unroll);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 = launched) and launches on `stream`. Checked by
// the Python wrapper: ts (B, block / 4096 + 1) int32 (modes 9, 10; else
// unused); rows (B, rows_len) int32 (mode 9; else unused); pctrl (B, g32,
// 128) int32 with g32 % 32 == 0; lit (B, rl, 128), int32 for mode 9 and
// uint8 otherwise; out (B, block) uint8 with block % 4096 == 0; layers >= 0
// (mode 11).
int zxc_lane_sum(const int32_t* ts, const int32_t* rows, int rows_len,
                 const int32_t* pctrl, int g32, const uint8_t* lit, int rl,
                 uint8_t* out, int B, int block, int mode, int layers,
                 void* stream) {
  if (mode != 9 && mode != 10 && mode != 11) return (int)cudaErrorInvalidValue;
  if (B == 0 || block == 0) return 0;
  if (B < 0 || B > 65535 || block < 0 || block % kTile || g32 < 0 ||
      g32 % kTileRows || rl < 1 || rows_len < 0 || layers < 0)
    return (int)cudaErrorInvalidValue;
  lane_sum_kernel<kProduction><<<dim3(block / kTile, B), kLaneThreads, 0,
                                 (cudaStream_t)stream>>>(
      ts, rows, rows_len, pctrl, g32, lit, mode == 9 ? 4 : 1, rl, out, block,
      mode, layers);
  return (int)cudaGetLastError();
}

// The lane-sum probes of tools/tpu_v10_probe.py and tools/tpu_v12_ablate.py
// on v10's layout (`probe` a LaneProbe, 1-7). Checked by the Python
// wrapper as zxc_lane_sum's mode 10; nomatmul needs rl >= 128.
int zxc_lane_sum_probe(const int32_t* ts, const int32_t* pctrl, int g32,
                       const uint8_t* lit, int rl, uint8_t* out, int B,
                       int block, int probe, void* stream) {
  if (probe < kNoMatmul || probe > kFloor) return (int)cudaErrorInvalidValue;
  if (B == 0 || block == 0) return 0;
  if (B < 0 || B > 65535 || block < 0 || block % kTile || g32 < 0 ||
      g32 % kTileRows || rl < (probe == kNoMatmul ? 128 : 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(block / kTile, B);
  const auto run = [&](auto kernel) {
    kernel<<<grid, kLaneThreads, 0, (cudaStream_t)stream>>>(
        ts, nullptr, 0, pctrl, g32, lit, 1, rl, out, block, 10, 0);
    return (int)cudaGetLastError();
  };
  switch (probe) {
    case kNoMatmul: return run(lane_sum_kernel<kNoMatmul>);
    case kNoOneHot: return run(lane_sum_kernel<kNoOneHot>);
    case kNoBcast: return run(lane_sum_kernel<kNoBcast>);
    case kNoRotate: return run(lane_sum_kernel<kNoRotate>);
    case kNoRotateAdd: return run(lane_sum_kernel<kNoRotateAdd>);
    case kNoMask: return run(lane_sum_kernel<kNoMask>);
    default: return run(lane_sum_kernel<kFloor>);
  }
}

}  // extern "C"
