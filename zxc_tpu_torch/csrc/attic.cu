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
// blocks, about a microsecond at 3.35 TB/s). What a byte needs is its
// piece, found among a block's thousands, and a literal load after it.
// The earlier form had thread 0 run two binary searches over the block's
// pieces in global memory (about 13 dependent loads each) while the CTA
// waited, then each thread a search of its own and a reload of the next
// piece a step: about 25 dependent loads a thread. Design: one CTA of 256
// threads per (block, 1024-byte output window). (1) A CTA-wide search
// narrows the window's first piece (the last with o <= w0) to 256
// candidates or fewer: each round every thread reads one probe's o and
// __syncthreads_count narrows the range 256-fold (one round for 9,216
// pieces, none for 256). (2) The pieces from the first candidate on are
// staged 256 a round (an int4 a thread, coalesced) until one starts past
// the window; each marks owner[max(o - w0, 0)] with its index by
// atomicMax (the largest wins: the window's first piece at position 0,
// the last of equal starts elsewhere), and stages its literal base
// c + rem(max(o, w0) - s, k) - max(o, w0), so the remainder is taken once
// a piece, not once a byte. (3) An inclusive max-scan of owner[] gives
// each byte its piece (starts do not decrease, so the largest index at or
// before a position is the last piece starting there). (4) Each thread
// takes 4 consecutive bytes, reads their pieces from the stage (from
// global memory when they lie in an earlier round), issues the 4 literal
// loads independently and stores one 32-bit word. Pieces are disjoint, so
// every byte is written exactly once.
//
// Measured (attic_ab.py, NVIDIA H100 80GB HBM3, 700.00 W, back to back,
// ms): the first group of 16 blocks of 64 KiB 0.0072 against the earlier
// form's 0.0124; the launch, owner map, barriers, scan and store alone
// 0.0051; the window's first piece given 0.0060; thread 0's binary search
// in place of the CTA's 0.0080; no literal loads 0.0065. Windows of 1,024
// one-byte pieces or of 1,024 equal starts 0.0121 (earlier 0.0182).

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
// literal byte once, the output once: about 2.5 MB a group), and so is the
// work: a packed plan's slots (about 736 a tile) cover each output byte
// about once, 5.6 lanes a slot of the 128 each tests. The earlier form had
// each thread test every slot of its sublane against its 4 lanes, with the
// literal loads behind data-dependent branches: one load latency a batch.
// Design: a warp per (block, tile, sublane), 8 warps a CTA, the warps
// independent (no block barrier). A warp takes its sublane's batches 32 at
// a time, a batch a lane (one coalesced load of the control words, and for
// v9 of the rows) and scans the slots' clipped lane counts with shuffles.
// Cover, where the slots cover few lanes (48 or fewer a slot on average):
// the covered bytes are spread over the lanes, 4 at a time a lane with
// their literal loads in flight together; a lane finds its byte's slot by
// a 5-step search of the scan through shuffles, reads the slot's row,
// rotation and offset from that lane, and adds its byte into the warp's
// 128 int32 sums in shared memory (atomicAdd: slots may overlap). The
// work is the bytes covered. Slots, where they cover more: every lane
// tests every slot against its 4 lanes, one slot at a time, each
// slot's 4 rotated bytes from two aligned words and a funnel shift, added
// with per-byte adds under a lane mask; the work is the slots. The probes
// are compile-time transforms of a slot (its lanes, source row and an
// added byte), so every mode runs the same loop; nomask and floor cover
// all 128 lanes of every slot and so take the slot loop.
//
// Measured (attic_ab.py, NVIDIA H100 80GB HBM3, 700.00 W, back to back,
// ms, first group of 16 blocks of 64 KiB): v9 / v10 / v11 0.0066 /
// 0.0061 / 0.0059 against the earlier form's 0.0195 / 0.0182 / 0.0184;
// the launch, control loads and store alone 0.0037-0.0046; every chunk by
// the slot loop 0.019-0.022, with 4 or 8 slots' loads in flight no
// faster. Every slot on all 128 lanes: 0.0190 (cover alone 0.0388, the
// earlier form 0.0180).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 1024;
constexpr int kThreads = kWindow / 4;
constexpr int kMergeStage = 1024;            // window ops staged a round
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;
constexpr int kTileRows = kTile / 128;       // 32 sublanes, a warp each
constexpr int kPieceStage = kThreads;       // pieces staged a round
constexpr int kLaneWarps = 8;                // sublanes a CTA, a warp each
constexpr int kLaneCtas = kTileRows / kLaneWarps;   // CTAs a tile
constexpr int kLaneUnroll = 4;               // bytes a lane takes at once
constexpr int kSlotLanes = 48;   // lanes a slot above which slots beat cover
constexpr int kSlotUnroll = 1;               // slots whose loads go together

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return (a & 255u) | (b & 255u) << 8 | (c & 255u) << 16 | (d & 255u) << 24;
}

// A piece at or before the window's first piece (the last with o[4j] <=
// x, o not decreasing; 0 for none), by every thread of the CTA: each round
// a thread reads one probe's o, and __syncthreads_count narrows [lo, hi]
// (the count of pieces with o <= x lies in it) to one step of the round,
// until kThreads or fewer are left; those, and the pieces before the
// first among them, mark owner[0] in the stage rounds, where the largest
// index wins.
__device__ __forceinline__ int first_candidate(const int32_t* o, int n,
                                               int x) {
  int lo = 0, hi = n;
  while (hi - lo > kThreads) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int q = lo + (threadIdx.x + 1) * step - 1;
    const int c = __syncthreads_count(q < hi && o[4 * q] <= x);
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  return max(lo - 1, 0);
}

// Piece pc's literal index for output byte pq of the window at w0, less
// pq: c + rem(max(o, w0) - s, k) - max(o, w0), wrapping (k below 1 as 1).
__device__ __forceinline__ int piece_base(int4 pc, int w0) {
  const int p0 = max(pc.x, w0);
  return wrap_sub(wrap_add(pc.y, wrap_sub(p0, pc.z) % max(pc.w, 1)), p0);
}

__global__ void __launch_bounds__(kThreads) piece_serial_kernel(
    const int32_t* __restrict__ npieces, const int32_t* __restrict__ totals,
    const int32_t* __restrict__ pcs, int cap, const uint8_t* __restrict__ lit,
    long long lit_row, uint8_t* __restrict__ out, int block,
    int fill_from_s) {
  __shared__ int4 stage[kPieceStage];
  __shared__ int owner[kWindow];   // the last piece starting at a position
  __shared__ int sums[kWarps];
  const int b = blockIdx.y;
  const int w0 = blockIdx.x * kWindow;
  const int32_t* pb = pcs + (long long)b * cap * 4;
  const int4* pb4 = reinterpret_cast<const int4*>(pb);
  const uint8_t* lb = lit + (long long)b * lit_row;
  const int n = min(max(npieces[b], 0), cap);
  const int T = min(max(totals[b], 0), block);
  const int p = 4 * threadIdx.x;   // the thread's first byte in the window
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) owner[p + q] = -1;
  __syncthreads();
  // (1) a piece at or before the window's first (the last with o <= w0)
  int r0 = first_candidate(pb, n, w0);   // then the last round's first
  // (2) the pieces from there on, a round at a time until one starts past
  // the window; each marks its first position in the window (0 for those
  // at or before w0: the last of them covers it)
  for (;; r0 += kPieceStage) {
    const int j = r0 + threadIdx.x;
    const int4 pc = j < n ? pb4[j] : make_int4(0, 0, 0, 1);
    stage[threadIdx.x] = make_int4(pc.x, piece_base(pc, w0), pc.z, pc.w);
    const bool in = j < n && pc.x <= w0 + kWindow - 1;
    if (in) atomicMax(&owner[pc.x <= w0 ? 0 : pc.x - w0], j);
    if (__syncthreads_or(!in)) break;
  }
  // (3) each position's piece: an inclusive max-scan of owner[]
  int m[4], run = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = run = max(run, owner[p + q]);
  int inc = run;
  for (int o = 1; o < 32; o <<= 1)
    inc = max(inc, __shfl_up_sync(~0u, inc, o));
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  int before = __shfl_up_sync(~0u, inc, 1);
  if (lane == 0) before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, sums[w]);
  // (4) resolve: the 4 bytes' pieces and literal loads, independent (the
  // stage holds each piece's base, the remainder taken once a piece)
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int pq = w0 + p + q, j = max(m[q], before);
    const bool live = j >= 0 && pq < T;
    int4 pc = make_int4(0, 0, 0, 1);   // with piece_base in .y
    if (live && j >= r0) {
      pc = stage[j - r0];
    } else if (live) {
      pc = __ldg(pb4 + j);
      pc.y = piece_base(pc, w0);
    }
    const int idx = wrap_add(pc.y, pq);
    const bool fill = fill_from_s && pc.w == 1;
    const bool ok = live && !fill && idx >= 0 && idx < lit_row;
    v[q] = ok ? (uint32_t)__ldg(lb + idx) : 0u;
    if (live && fill) v[q] = (uint32_t)pc.z & 255u;
  }
  *reinterpret_cast<uint32_t*>(out + (long long)b * block + w0 + p) =
      pack_low_bytes(v[0], v[1], v[2], v[3]);
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

// bytes [lo, hi) of a word set, 0 <= lo, hi <= 4
__device__ __forceinline__ uint32_t byte_range(int lo, int hi) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, 8 * hi) &
         ~__funnelshift_lc(0xFFFFFFFFu, 0u, 8 * lo);
}

// the low bytes of 4 int32 words, packed
__device__ __forceinline__ uint32_t low_bytes(int4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// A slot of the lane sum as its mode transforms it: the literal row it
// reads (`src`), its lanes [first, last], its rotation and a byte added to
// each of its lanes (the probes' extra terms; floor reads no row).
struct LaneSlot {
  int src, first, last, rot, add;
};

template <int kProbe, bool kV9>
__device__ __forceinline__ LaneSlot lane_slot(int c, int vrow, int u, int k,
                                              int rl) {
  int rot, s, e1, row;
  if (kV9) {
    rot = c & 255;
    s = (c >> 8) & 255;
    e1 = (c >> 16) & 255;
    row = min(max(vrow < 0 ? vrow + rl : vrow, 0), rl - 1);
  } else {
    rot = c & 127;
    s = (c >> 7) & 127;
    e1 = (c >> 14) & 127;
    row = (int)((unsigned)c >> 21);
  }
  constexpr bool kMasked = kProbe != kNoMask && kProbe != kFloor;
  LaneSlot sl;
  sl.src = kProbe == kFloor ? rl
      : kProbe == kNoMatmul || kProbe == kNoOneHot ? 32 * u + k : row;
  sl.first = kMasked ? s : 0;
  sl.last = kMasked ? min(e1, 127) : 127;
  if (kProbe == kProduction && sl.src >= rl) sl.last = -1;   // adds 0
  sl.rot = kProbe == kNoRotate || kProbe == kNoRotateAdd ? 0 : rot;
  sl.add = (kProbe == kNoMatmul ? row : kProbe == kNoRotateAdd ? rot
            : kProbe == kFloor ? c : 0) & 255;
  return sl;
}

// Cover: the chunk's slots (a slot a lane; `incl` the inclusive scan of
// their lengths, `total` its last) spread over the lanes by byte,
// kLaneUnroll bytes a lane at once: a lane finds its byte's slot by a
// 5-step search of the scan through shuffles, reads that lane's row,
// rotation and offset, loads the literal byte and adds it into `sum`.
template <bool kV9>
__device__ __forceinline__ void cover_bytes(const LaneSlot& sl, int len,
                                            int incl, int total,
                                            const uint8_t* lb, int rl,
                                            int* sum) {
  const int lane = threadIdx.x & 31;
  const int d = sl.first - (incl - len);   // byte j of the slot: lane j + d
  const int base = sl.src < rl ? sl.src * 128 : -1;
  const int ra = sl.rot | sl.add << 8;
  for (int j0 = 0; j0 < total; j0 += 32 * kLaneUnroll) {
    int l[kLaneUnroll];
    uint32_t v[kLaneUnroll];
#pragma unroll
    for (int u = 0; u < kLaneUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      int i = 0;   // byte j's slot: the first whose inclusive scan passes j
#pragma unroll
      for (int st = 16; st; st >>= 1)
        if (__shfl_sync(~0u, incl, i + st - 1) <= j) i += st;
      const int bj = __shfl_sync(~0u, base, i);
      const int rj = __shfl_sync(~0u, ra, i);
      l[u] = j + __shfl_sync(~0u, d, i);
      const bool ok = j < total && bj >= 0;
      const int e = ok ? bj + ((l[u] + (rj & 255)) & 127) : 0;
      v[u] = kV9 ? (uint32_t)__ldg(reinterpret_cast<const int32_t*>(lb) + e)
                 : (uint32_t)__ldg(lb + e);
      v[u] = (ok ? v[u] : 0u) + ((uint32_t)rj >> 8);
    }
#pragma unroll
    for (int u = 0; u < kLaneUnroll; ++u)
      if (j0 + 32 * u + lane < total) atomicAdd(&sum[l[u]], (int)v[u]);
  }
}

// Slots: every lane tests every slot of the chunk against its 4 lanes,
// kSlotUnroll slots at a time (one: the loop is issue-bound, and more in
// flight measured no faster; a masked slot reads row 0 and adds 0): the 4
// rotated bytes from two aligned words of the row joined by a funnel
// shift (v9: the low bytes of two int4 loads; no loads for the floor
// probe), the added byte and the lane mask applied with per-byte adds
// (sums mod 256).
template <bool kV9, bool kLoads>
__device__ __forceinline__ void slot_bytes(const LaneSlot& mine, int nc,
                                           const uint8_t* lb, int rl,
                                           int* sum) {
  const int l0 = 4 * (threadIdx.x & 31);
  uint32_t acc = 0u;
  for (int i = 0; i < nc; i += kSlotUnroll) {
    uint32_t w0[kSlotUnroll], w1[kSlotUnroll], msk[kSlotUnroll];
    uint32_t add[kSlotUnroll];
    int4 q0[kSlotUnroll], q1[kSlotUnroll];
    int sh[kSlotUnroll];
    bool ld[kSlotUnroll];
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int src = __shfl_sync(~0u, mine.src, i + u);
      const int first = __shfl_sync(~0u, mine.first, i + u);
      const int last = __shfl_sync(~0u, mine.last, i + u);
      const int ra = __shfl_sync(~0u, mine.rot | mine.add << 8, i + u);
      msk[u] = i + u < nc ? byte_range(min(max(first - l0, 0), 4),
                                       min(max(last - l0 + 1, 0), 4)) : 0u;
      add[u] = (uint32_t)(ra >> 8) * 0x01010101u;
      ld[u] = msk[u] != 0u && src < rl;
      const int e = ld[u] ? (l0 + (ra & 255)) & 127 : 0;
      const int r = ld[u] ? src : 0;
      sh[u] = 8 * (e & 3);
      if (kLoads && kV9) {
        const int4* row = reinterpret_cast<const int4*>(lb) + r * 32;
        q0[u] = __ldg(row + (e >> 2));
        q1[u] = __ldg(row + (((e >> 2) + 1) & 31));
      } else if (kLoads) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(lb) + r * 32;
        w0[u] = __ldg(row + (e >> 2));
        w1[u] = __ldg(row + (((e >> 2) + 1) & 31));
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      if (kV9 && kLoads) {
        w0[u] = low_bytes(q0[u]);
        w1[u] = low_bytes(q1[u]);
      }
      const uint32_t v = kLoads && ld[u]
          ? __funnelshift_r(w0[u], w1[u], sh[u]) : 0u;
      acc = __vadd4(acc, __vadd4(v, add[u]) & msk[u]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    atomicAdd(&sum[l0 + q], (int)((acc >> (8 * q)) & 255u));
}

// One chunk of up to 32 batches of a warp's sublane, a batch a lane (its
// control word c and v9's row vrow; ph the first batch's place in the
// probes' group of 4): the warp scans its slots' lengths and takes the
// covered bytes by cover, or by slots where the slots cover more than
// kSlotLanes lanes on average (the slot loop's work does not grow with
// the bytes, the cover's does), adding them into `sum`, the row's int32
// sums.
template <int kProbe, bool kV9>
__device__ __forceinline__ void lane_chunk(int c, int vrow, int nc, int ph,
                                           int k, const uint8_t* lb, int rl,
                                           int* sum) {
  const int lane = threadIdx.x & 31;
  const LaneSlot sl = lane_slot<kProbe, kV9>(c, vrow, (ph + lane) & 3, k,
                                             rl);
  const int len = lane < nc ? max(sl.last - sl.first + 1, 0) : 0;
  int incl = len;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(~0u, incl, 31);
  if (total > kSlotLanes * nc)
    slot_bytes<kV9, kProbe != kFloor>(sl, nc, lb, rl, sum);
  else
    cover_bytes<kV9>(sl, len, incl, total, lb, rl, sum);
}

template <int kProbe, bool kV9>
__global__ void __launch_bounds__(kLaneWarps * 32) lane_sum_kernel(
    const int32_t* __restrict__ ts, const int32_t* __restrict__ rows,
    int rows_len, const int32_t* __restrict__ pctrl, int g32,
    const uint8_t* __restrict__ lit, int rl, uint8_t* __restrict__ out,
    int block, int mode, int layers) {
  __shared__ int4 sums[kLaneWarps][32];   // a warp's row of int32 sums
  const int nt = block / kTile;
  const int b = blockIdx.y, t = blockIdx.x / kLaneCtas;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = (blockIdx.x % kLaneCtas) * kLaneWarps + w;   // the sublane
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
  if (kV9) cap = min(cap, (long long)(rows_len / kTileRows));
  const long long lo = clamp_ll(b0, 0, cap);
  const long long hi = clamp_ll(b0 + n, lo, cap);
  const int32_t* pk = pctrl + ((long long)b * g32 + k) * 128;
  const int32_t* rk = rows + (long long)b * rows_len + k;
  const uint8_t* lb = lit + (long long)b * rl * 128 * (kV9 ? 4 : 1);
  int* sum = reinterpret_cast<int*>(sums[w]);
  sums[w][lane] = make_int4(0, 0, 0, 0);
  __syncwarp();
  for (long long c0 = lo; c0 < hi; c0 += 32) {
    const int nc = (int)min(32LL, hi - c0);
    const long long bat = c0 + lane;
    int c = kBcastWord, vrow = 0;
    if (kProbe != kNoBcast && lane < nc)
      c = pk[kTileRows * 128 * (bat >> 7) + (bat & 127)];
    if (kV9 && lane < nc) vrow = rk[kTileRows * bat];
    lane_chunk<kProbe, kV9>(c, vrow, nc, (int)((c0 - b0) & 3), k, lb, rl,
                            sum);
  }
  __syncwarp();
  const int4 v = sums[w][lane];
  *reinterpret_cast<uint32_t*>(
      out + (long long)b * block + ((long long)t * kTileRows + k) * 128 +
      4 * lane) = pack_low_bytes(v.x, v.y, v.z, v.w);
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
  const dim3 grid(block / kTile * kLaneCtas, B);
  if (mode == 9)
    lane_sum_kernel<kProduction, true><<<grid, kLaneWarps * 32, 0,
                                         (cudaStream_t)stream>>>(
        ts, rows, rows_len, pctrl, g32, lit, rl, out, block, mode, layers);
  else
    lane_sum_kernel<kProduction, false><<<grid, kLaneWarps * 32, 0,
                                          (cudaStream_t)stream>>>(
        ts, rows, rows_len, pctrl, g32, lit, rl, out, block, mode, layers);
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
  const dim3 grid(block / kTile * kLaneCtas, B);
  const auto run = [&](auto kernel) {
    kernel<<<grid, kLaneWarps * 32, 0, (cudaStream_t)stream>>>(
        ts, nullptr, 0, pctrl, g32, lit, rl, out, block, 10, 0);
    return (int)cudaGetLastError();
  };
  switch (probe) {
    case kNoMatmul: return run(lane_sum_kernel<kNoMatmul, false>);
    case kNoOneHot: return run(lane_sum_kernel<kNoOneHot, false>);
    case kNoBcast: return run(lane_sum_kernel<kNoBcast, false>);
    case kNoRotate: return run(lane_sum_kernel<kNoRotate, false>);
    case kNoRotateAdd: return run(lane_sum_kernel<kNoRotateAdd, false>);
    case kNoMask: return run(lane_sum_kernel<kNoMask, false>);
    default: return run(lane_sum_kernel<kFloor, false>);
  }
}

}  // extern "C"
