// Native host runtime for zxc_tpu: the C++ pieces of the pipeline that
// surround the TPU compute path — checksums, frame walking, section
// parsing, and a serial fallback expander for CLI/host-only use.
//
// Everything here is a clean-room port of the project's own Python
// implementations (zxc_tpu/format/hashes.py, codec/block_decode.py), which
// are themselves conformance-verified against the format spec. ABI is
// plain C (loaded with ctypes).
//
// Build: g++ -O3 -shared -fPIC -o libzxchost.so zxc_host.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>

#if defined(__AVX512VBMI2__) && defined(__AVX512BW__) && defined(__BMI2__)
#include <immintrin.h>
#define ZXCH_HAVE_VBMI2 1
#endif
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#include <immintrin.h>
#define ZXCH_HAVE_VBMI 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// build-ISA vs running-CPU guard. The library is compiled -march=native
// and cached next to the source by mtime only, so a prebuilt .so copied
// to (or mounted on) a host without the build CPU's extensions would
// execute e.g. vpermb unconditionally and SIGILL. The loader calls this
// first and rebuilds when it returns 0 (runtime/__init__.py), giving the
// same safety as the reference's per-ISA runtime dispatch
// (zxc_dispatch.c:154-302) at one check per process instead of per call.
// ---------------------------------------------------------------------------

int zxch_isa_supported(void) {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_cpu_init();
#if defined(__AVX512VBMI__)
  if (!__builtin_cpu_supports("avx512vbmi")) return 0;
#endif
#if defined(__AVX512VBMI2__)
  if (!__builtin_cpu_supports("avx512vbmi2")) return 0;
#endif
#if defined(__AVX512BW__)
  if (!__builtin_cpu_supports("avx512bw")) return 0;
#endif
#if defined(__AVX512F__)
  if (!__builtin_cpu_supports("avx512f")) return 0;
#endif
#if defined(__AVX2__)
  if (!__builtin_cpu_supports("avx2")) return 0;
#endif
#if defined(__BMI2__)
  if (!__builtin_cpu_supports("bmi2")) return 0;
#endif
#endif
  return 1;
}

// ---------------------------------------------------------------------------
// rapidhash v3 (public algorithm) folded to u32 — per-block checksum
// ---------------------------------------------------------------------------

static const uint64_t RAPID_SECRET[8] = {
    0x2D358DCCAA6C78A5ull, 0x8BB84B93962EACC9ull, 0x4B33A62ED433D4A3ull,
    0x4D5A2DA51DE1AA47ull, 0xA0761D6478BD642Full, 0xE7037ED1A0B428DBull,
    0x90ED1765281C388Cull, 0xAAAAAAAAAAAAAAAAull};

static inline void mum(uint64_t *a, uint64_t *b) {
  __uint128_t r = (__uint128_t)*a * *b;
  *a = (uint64_t)r;
  *b = (uint64_t)(r >> 64);
}

static inline uint64_t mix(uint64_t a, uint64_t b) {
  mum(&a, &b);
  return a ^ b;
}

static inline uint64_t read64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

static inline uint64_t read32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

uint64_t zxch_rapidhash64(const uint8_t *data, size_t len, uint64_t seed) {
  const uint64_t *s = RAPID_SECRET;
  seed ^= mix(seed ^ s[2], s[1]);
  uint64_t a = 0, b = 0;
  size_t i = len;
  const uint8_t *p = data;
  if (len <= 16) {
    if (len >= 4) {
      seed ^= len;
      if (len >= 8) {
        a = read64(data);
        b = read64(data + len - 8);
      } else {
        a = read32(data);
        b = read32(data + len - 4);
      }
    } else if (len > 0) {
      a = ((uint64_t)data[0] << 45) | data[len - 1];
      b = data[len >> 1];
    }
  } else {
    if (len > 112) {
      uint64_t see[7];
      for (int k = 0; k < 7; k++) see[k] = seed;
      while (i > 112) {
        for (int k = 0; k < 7; k++)
          see[k] = mix(read64(p + 16 * k) ^ s[k], read64(p + 16 * k + 8) ^ see[k]);
        p += 112;
        i -= 112;
      }
      seed = see[0] ^ see[1] ^ see[2] ^ see[3] ^ see[4] ^ see[5] ^ see[6];
    }
    if (i > 16) {
      seed = mix(read64(p) ^ s[2], read64(p + 8) ^ seed);
      if (i > 32) {
        seed = mix(read64(p + 16) ^ s[2], read64(p + 24) ^ seed);
        if (i > 48) {
          seed = mix(read64(p + 32) ^ s[1], read64(p + 40) ^ seed);
          if (i > 64) {
            seed = mix(read64(p + 48) ^ s[1], read64(p + 56) ^ seed);
            if (i > 80) {
              seed = mix(read64(p + 64) ^ s[2], read64(p + 72) ^ seed);
              if (i > 96)
                seed = mix(read64(p + 80) ^ s[1], read64(p + 88) ^ seed);
            }
          }
        }
      }
    }
    a = read64(p + i - 16) ^ i;
    b = read64(p + i - 8);
  }
  a ^= s[1];
  b ^= seed;
  mum(&a, &b);
  return mix(a ^ s[7], b ^ s[1] ^ i);
}

uint32_t zxch_rapidhash32(const uint8_t *data, size_t len, uint64_t seed) {
  uint64_t h = zxch_rapidhash64(data, len, seed);
  return (uint32_t)(h ^ (h >> 32));
}

// batch: hash `count` payloads given (offset, size) pairs into out[]
void zxch_rapidhash32_batch(const uint8_t *base, const uint64_t *offsets,
                            const uint64_t *sizes, uint32_t *out,
                            size_t count) {
  for (size_t k = 0; k < count; k++)
    out[k] = zxch_rapidhash32(base + offsets[k], sizes[k], 0);
}

// ---------------------------------------------------------------------------
// header hashes (Marsaglia xorshift mixes)
// ---------------------------------------------------------------------------

static inline uint64_t xorshift_mix(uint64_t h) {
  h ^= h << 13;
  h ^= h >> 7;
  h ^= h << 17;
  return h;
}

uint8_t zxch_hash8(const uint8_t *data) {
  uint64_t h = xorshift_mix(read64(data) ^ 0x9E3779B97F4A7C15ull);
  return (uint8_t)((h >> 32) ^ h);
}

uint16_t zxch_hash16(const uint8_t *data) {
  uint64_t h = xorshift_mix(read64(data) ^ read64(data + 8) ^
                            0xD2D84A61D2D84A61ull);
  uint32_t r = (uint32_t)((h >> 32) ^ h);
  return (uint16_t)((r >> 16) ^ r);
}

// ---------------------------------------------------------------------------
// frame walk: block table extraction with CRC8 validation
// ---------------------------------------------------------------------------

// Returns number of data blocks (>= 0) or a negative ZXC error code.
// For each block k: pos[k] = offset of the 8-byte header, type[k], comp[k].
// *eof_pos receives the offset just past the EOF block header.
int64_t zxch_walk_frame(const uint8_t *src, uint64_t n, int has_checksum,
                        uint64_t bound, uint64_t start, uint64_t *pos,
                        uint8_t *type, uint64_t *comp, uint64_t max_blocks,
                        uint64_t *eof_pos) {
  uint64_t p = start;
  uint64_t count = 0;
  const uint64_t tail = has_checksum ? 4 : 0;
  while (p + 8 <= n) {
    uint8_t hdr[8];
    memcpy(hdr, src + p, 8);
    uint8_t crc = hdr[7];
    hdr[7] = 0;
    if (zxch_hash8(hdr) != crc) return -6;  // ZXC_ERROR_BAD_HEADER
    uint8_t bt = hdr[0];
    uint32_t csz;
    memcpy(&csz, hdr + 3, 4);
    if (bt == 255) {             // EOF
      if (csz != 0) return -6;
      *eof_pos = p + 8;
      return (int64_t)count;
    }
    if (csz > bound) return -8;  // ZXC_ERROR_CORRUPT_DATA
    if (p + 8 + csz + tail > n) return -3;  // SRC_TOO_SMALL
    if (count >= max_blocks) return -10;    // OVERFLOW
    pos[count] = p;
    type[count] = bt;
    comp[count] = csz;
    count++;
    p += 8 + csz + tail;
  }
  return -3;  // missing EOF
}

// ---------------------------------------------------------------------------
// RLE literal decode (enc_lit=1)
// ---------------------------------------------------------------------------

// Returns 0 on success, negative error otherwise.
int zxch_rle_decode(const uint8_t *src, uint64_t n, uint8_t *dst,
                    uint64_t out_size) {
  uint64_t r = 0, w = 0;
  while (w < out_size) {
    if (r >= n) return -8;
    uint8_t tok = src[r];
    if (tok & 0x80) {  // run
      uint64_t len = (uint64_t)(tok & 0x7F) + 4;
      if (r + 2 > n || w + len > out_size) return -8;
      memset(dst + w, src[r + 1], len);
      w += len;
      r += 2;
    } else {  // raw copy
      uint64_t len = (uint64_t)tok + 1;
      if (r + 1 + len > n || w + len > out_size) return -8;
      memcpy(dst + w, src + r + 1, len);
      w += len;
      r += 1 + len;
    }
  }
  return w == out_size ? 0 : -8;
}

// ---------------------------------------------------------------------------
// varint chain (1..3 bytes, first byte >= 0xE0 invalid)
// ---------------------------------------------------------------------------

// Decodes exactly `count` varints; returns consumed bytes or negative error.
int64_t zxch_varint_chain(const uint8_t *src, uint64_t n, uint64_t count,
                          uint32_t *out) {
  uint64_t p = 0;
  for (uint64_t k = 0; k < count; k++) {
    if (p >= n) return -8;
    uint8_t b0 = src[p];
    if (b0 < 0x80) {
      out[k] = b0;
      p += 1;
    } else if (b0 < 0xC0) {
      if (p + 2 > n) return -8;
      out[k] = (uint32_t)(b0 & 0x3F) | ((uint32_t)src[p + 1] << 6);
      p += 2;
    } else if (b0 < 0xE0) {
      if (p + 3 > n) return -8;
      out[k] = (uint32_t)(b0 & 0x1F) | ((uint32_t)src[p + 1] << 5) |
               ((uint32_t)src[p + 2] << 13);
      p += 3;
    } else {
      return -8;
    }
  }
  return (int64_t)p;
}

// ---------------------------------------------------------------------------
// serial sequence expansion (host fallback / CLI fast path)
// ---------------------------------------------------------------------------

// ll/ml/off are int32 arrays (ml includes MIN_MATCH, off unbiased >= 1).
// dict is the window prefix (may be NULL). Returns produced bytes or
// negative error.
int64_t zxch_expand(const int32_t *ll, const int32_t *ml, const int32_t *off,
                    uint64_t n_seq, const uint8_t *lit, uint64_t n_lit,
                    const uint8_t *dict, uint64_t n_dict, uint8_t *dst,
                    uint64_t cap) {
  uint64_t w = 0, r = 0;
  for (uint64_t i = 0; i < n_seq; i++) {
    uint64_t l = (uint64_t)ll[i], m = (uint64_t)ml[i], o = (uint64_t)off[i];
    if (r + l > n_lit || w + l + m > cap) return -10;  // OVERFLOW
    memcpy(dst + w, lit + r, l);
    w += l;
    r += l;
    if (o == 0 || o > w + n_dict) return -9;  // BAD_OFFSET
    // dict part
    uint64_t mlen = m;
    if (o > w) {
      uint64_t from_dict = o - w;
      uint64_t take = from_dict < mlen ? from_dict : mlen;
      memcpy(dst + w, dict + n_dict - from_dict, take);
      w += take;
      mlen -= take;
      // remaining bytes (if any) now copy from dst start with o == w_old
    }
    // overlap-safe byte copy (o may be < mlen)
    uint8_t *d = dst + w;
    const uint8_t *sp = dst + w - o;
    if (o >= 16) {
      uint64_t k = 0;
      for (; k + 16 <= mlen; k += 16) memcpy(d + k, sp + k, 16);
      for (; k < mlen; k++) d[k] = sp[k];
    } else {
      for (uint64_t k = 0; k < mlen; k++) d[k] = sp[k];
    }
    w += mlen;
  }
  uint64_t trailing = n_lit - r;
  if (w + trailing > cap) return -10;
  memcpy(dst + w, lit + r, trailing);
  return (int64_t)(w + trailing);
}

// ---------------------------------------------------------------------------
// GLO/GHI token unpack (merges extras) — phase-1 helpers
// ---------------------------------------------------------------------------

// tokens: n_seq GLO token bytes; extras resolved beforehand into ext[] pairs
// consumed in wire order (LL first when both saturate).
int zxch_glo_tokens(const uint8_t *tokens, uint64_t n_seq,
                    const uint32_t *ext, uint64_t n_ext, int32_t *ll,
                    int32_t *ml) {
  uint64_t e = 0;
  for (uint64_t i = 0; i < n_seq; i++) {
    uint32_t t = tokens[i];
    uint32_t l = t >> 4, m = t & 15;
    if (l == 15) {
      if (e >= n_ext) return -8;
      l += ext[e++];
    }
    if (m == 15) {
      if (e >= n_ext) return -8;
      m += ext[e++];
    }
    ll[i] = (int32_t)l;
    ml[i] = (int32_t)(m + 5);
  }
  return (int)e == (int)n_ext ? 0 : -8;
}

int zxch_ghi_words(const uint8_t *words, uint64_t n_seq, const uint32_t *ext,
                   uint64_t n_ext, int32_t *ll, int32_t *ml, int32_t *off) {
  uint64_t e = 0;
  for (uint64_t i = 0; i < n_seq; i++) {
    uint32_t wrd;
    memcpy(&wrd, words + 4 * i, 4);
    uint32_t l = wrd >> 24, m = (wrd >> 16) & 0xFF, o = wrd & 0xFFFF;
    if (l == 255) {
      if (e >= n_ext) return -8;
      l += ext[e++];
    }
    if (m == 255) {
      if (e >= n_ext) return -8;
      m += ext[e++];
    }
    ll[i] = (int32_t)l;
    ml[i] = (int32_t)(m + 5);
    off[i] = (int32_t)(o + 1);
  }
  return (int)e == (int)n_ext ? 0 : -8;
}

}  // extern "C"

// piece resolver: turn LZ sequences into a flat piecewise mapping
//   out[p] = lit_full[c + (p - s) % k]
// where lit_full = dict ++ literals ++ synthetic bytes. Closed under
// composition: match chains, fills (k=1) and periodic overlaps (k=off)
// resolve to direct literal references, so the device kernel needs NO
// iterative pointer chase. Source regions that would fragment into many
// pieces are MATERIALIZED once into the synthetic tail of lit_full and
// referenced as a single piece — this caps piece amplification per match.
// ---------------------------------------------------------------------------

extern "C" {

static const int32_t ZXCH_KBIG = 1 << 30;
// self-referential piece kind (round-5 v25 kernel contract): the piece's
// source is the block's own decoded OUTPUT at out-coordinate pc —
// out[p] = out[pc + (p - ps)] — eliminating host materialization (and its
// H2D bytes) for matches whose source lies in an earlier 16 KiB
// supertile, where the device kernel can read its own out_ref rows.
static const int32_t ZXCH_KOUT = ZXCH_KBIG + 1;

// paged position->piece index: page[q >> PAGE_LOG] = a piece at or before
// that page's start; lookups walk forward over a few tiny pieces.
#define ZXCH_PAGE_LOG 4
#define ZXCH_MAX_PAGES ((2 * 1024 * 1024) >> ZXCH_PAGE_LOG)

// lit_full: caller-allocated buffer holding dict++literals in
// [0, lit_len) with capacity lit_cap; synthetic bytes are appended and the
// final length is returned via *lit_len_out.
// Returns piece count >= 0, or -9 (bad offset), -10 (budget exceeded ->
// caller falls back to the iterative kernel).
// device_pure mode (for the Pallas copy kernel): every periodic piece
// (k <= 1024) points at a 2048-byte materialized repeating pattern, so a
// chunked reader can fetch [c + (p0-s)%k, +1024) contiguously; periods
// > 1024 are unrolled into per-repetition pure pieces. Fill patterns are
// cached per byte value.
// plan (nullable): when non-null, every byte WRITTEN into lit_full past
// [0, lit_len) is also recorded as a replayable control record
// {kind, dst, src_or_byte, len} (kind 0 = intra-lit_full memcpy, 1 =
// memset fill) — the encode-time "piece-plan hint" payload (SURVEY.md §5
// long-context note: host-side precomputation, wire unchanged). The
// records carry NO data bytes: replay re-derives every synthetic byte
// from the archive-decoded literal/dict prefix. Returns -16 when
// plan_cap is too small.
static int64_t resolve_pieces_impl(const int32_t *ll, const int32_t *ml,
                            const int32_t *off, uint64_t n_seq,
                            uint8_t *lit_full, uint64_t lit_len,
                            uint64_t lit_cap, uint64_t dict_len,
                            int32_t *po, int32_t *pc, int32_t *ps,
                            int32_t *pk, uint64_t max_pieces,
                            uint64_t *lit_len_out, int device_pure,
                            int max_frag,
                            int32_t *plan, int64_t plan_cap,
                            int64_t *n_plan, int self_ref = 0) {
  bool plan_of = false;
#define PLAN_REC(kind_, dst_, src_, len_)                                \
  do {                                                                   \
    if (plan) {                                                          \
      if (*n_plan >= plan_cap) { plan_of = true; }                       \
      else {                                                             \
        int32_t *pr_ = plan + 4 * (*n_plan)++;                           \
        pr_[0] = (int32_t)(kind_);                                       \
        pr_[1] = (int32_t)(dst_);                                        \
        pr_[2] = (int32_t)(src_);                                        \
        pr_[3] = (int32_t)(len_);                                        \
      }                                                                  \
    }                                                                    \
  } while (0)
  const int64_t D = (int64_t)dict_len;
  uint64_t np = 0;
  int64_t W = 0;        // output cursor
  int64_t r = 0;        // literal cursor (within [D, lit_len))
  int64_t lend = (int64_t)lit_len;  // current end of lit_full
  static thread_local int32_t page[ZXCH_MAX_PAGES];
  int64_t pages_filled = 0;
  // materialize sources spanning more pieces; max_frag tunes the
  // piece-count/extra-copy tradeoff (device kernels are issue-bound per
  // piece, so low values favor the TPU path; see PERF.md). 0 = default.
  const int MAX_FRAG = (max_frag >= 1 && max_frag <= 64) ? max_frag : 3;
  int64_t fill_cache[256];
  if (device_pure)
    for (int v = 0; v < 256; v++) fill_cache[v] = -1;

#define EMIT(o_, c_, s_, k_)                                   \
  do {                                                         \
    if (np >= max_pieces) return -10;                          \
    po[np] = (int32_t)(o_);                                    \
    pc[np] = (int32_t)(c_);                                    \
    ps[np] = (int32_t)(s_);                                    \
    pk[np] = (int32_t)(k_);                                    \
    int64_t pg_ = (int64_t)(o_) >> ZXCH_PAGE_LOG;              \
    while (pages_filled <= pg_ && pages_filled < ZXCH_MAX_PAGES) \
      page[pages_filled++] = (int32_t)np - 1;                  \
    np++;                                                      \
  } while (0)

  auto find_piece = [&](int64_t q) -> int64_t {
    int64_t pg = q >> ZXCH_PAGE_LOG;
    int64_t j = (pg < pages_filled) ? page[pg] : (int64_t)np - 1;
    if (j < 0) j = 0;
    while ((int64_t)po[j] > q) j--;
    while (j + 1 < (int64_t)np && (int64_t)po[j + 1] <= q) j++;
    return j;
  };

  auto piece_end = [&](int64_t j) -> int64_t {
    return (j + 1 < (int64_t)np) ? (int64_t)po[j + 1] : W;
  };

  // resolve out-coordinate *q through self-referential (KOUT) chains to a
  // concrete lit_full-backed piece, shrinking *run to the tightest span
  // valid across every chain hop. Chains strictly decrease q (o > 0), so
  // the walk terminates; the guard bounds adversarial data.
  auto resolve_seg = [&](int64_t &q, int64_t &run) -> int64_t {
    int64_t j = find_piece(q);
    int64_t guard = 1 << 22;
    while (j >= 0 && pk[j] == ZXCH_KOUT) {
      int64_t lim = piece_end(j) - q;
      if (lim < run) run = lim;
      if (lim <= 0 || --guard == 0) return -1;
      q = pc[j] + (q - ps[j]);
      j = find_piece(q);
    }
    if (j >= 0) {
      int64_t lim = piece_end(j) - q;
      if (lim < run) run = lim;
    }
    return j;
  };

  // materialize the bytes of out-range [sa, sa+len) into lit_full's tail;
  // returns the lit_full offset of the materialized range, or -1 on error.
  auto materialize = [&](int64_t sa, int64_t len) -> int64_t {
    if (lend + len > (int64_t)lit_cap) return -1;
    int64_t base = lend;
    int64_t q = sa, w = lend;
    while (len > 0) {
      if (q < 0) {
        int64_t take = (-q) < len ? (-q) : len;
        memcpy(lit_full + w, lit_full + (D + q), take);
        PLAN_REC(0, w, D + q, take);
        q += take; w += take; len -= take;
        continue;
      }
      int64_t take = len;
      int64_t q2 = q;                       // resolve KOUT chains
      int64_t j = resolve_seg(q2, take);
      if (j < 0 || take <= 0) return -1;
      int64_t kk = pk[j];
      if (kk >= ZXCH_KBIG) {  // pure: one memcpy
        memcpy(lit_full + w, lit_full + pc[j] + (q2 - ps[j]), take);
        PLAN_REC(0, w, pc[j] + (q2 - ps[j]), take);
      } else if (kk == 1) {
        memset(lit_full + w, lit_full[pc[j]], take);
        PLAN_REC(1, w, lit_full[pc[j]], take);
      } else if (device_pure) {
        // periodic pieces point into 2048-byte replicated patterns
        // (kk <= 1024), so chunks of <= 1024 bytes are contiguous reads
        int64_t t = 0;
        while (t < take) {
          int64_t ph = (q2 + t - ps[j]) % kk;
          int64_t c = (take - t) < 1024 ? (take - t) : 1024;
          memcpy(lit_full + w + t, lit_full + pc[j] + ph, c);
          PLAN_REC(0, w + t, pc[j] + ph, c);
          t += c;
        }
      } else {                // periodic: byte loop
        for (int64_t t = 0; t < take; t++)
          lit_full[w + t] = lit_full[pc[j] + ((q2 + t - ps[j]) % kk)];
      }
      q += take; w += take; len -= take;
    }
    lend = w;
    return base;
  };

  // copy the resolved mapping of source out-range [sa, sa+len) to output
  // starting at dst (assumes span <= MAX_FRAG or caller materialized).
  // single-walk capped emit: emits the mapping of [sa, sa+len) unless it
  // would take more than `cap` pieces, in which case every side effect is
  // rolled back and 1 is returned (caller materializes instead). Fuses
  // the old span_count pre-walk with emit_from — one piece-table walk.
  auto emit_capped = [&](int64_t sa, int64_t len, int64_t dst,
                         int cap) -> int {
    uint64_t np0 = np;
    int64_t pf0 = pages_filled;
    int cnt = 0;
    int64_t q = sa, d = dst;
    while (len > 0) {
      if (++cnt > cap) { np = np0; pages_filled = pf0; return 1; }
      if (q < 0) {  // dict region: lit_idx(p) = (D + q) + (p - d)
        int64_t take = (-q) < len ? (-q) : len;
        EMIT(d, D + q, d, ZXCH_KBIG);
        q += take; d += take; len -= take;
        continue;
      }
      int64_t take = len;
      int64_t q2 = q;                       // resolve KOUT chains
      int64_t j = resolve_seg(q2, take);
      if (j < 0 || take <= 0) return -9;
      // k==1 fills keep s verbatim (device_pure stores the fill byte there;
      // the phase shift is irrelevant when the period is 1)
      EMIT(d, pc[j], pk[j] == 1 ? ps[j] : ps[j] + (d - q2), pk[j]);
      q += take; d += take; len -= take;
    }
    return 0;
  };

  for (uint64_t i = 0; i < n_seq; i++) {
    int64_t l = ll[i], m = ml[i], o = off[i];
    if (l < 0 || m < 0 || o <= 0) return -9;
    if (l > 0) {
      if (D + r + l > (int64_t)lit_len) return -10;
      EMIT(W, D + r, W, ZXCH_KBIG);
      W += l; r += l;
    }
    if (o > W + D) return -9;
    int64_t a = W;
    if (o >= m) {
      // no self-overlap
      int64_t sa = a - o;
      if (self_ref && device_pure && sa >= 0 &&
          sa + m <= ((a >> 14) << 14)) {
        // v25 contract: source completes before the destination's 16 KiB
        // supertile, so the device kernel reads its own decoded output.
        // Cheap single-segment resolutions still emit directly (they
        // point into already-shipped bytes — no H2D to save); everything
        // else becomes ONE self-referential piece instead of a
        // fragmented emission or a host materialization.
        int rc = emit_capped(sa, m, a, 1);
        if (rc < 0) return rc;
        if (rc) EMIT(a, sa, a, ZXCH_KOUT);
        W = a + m;
        continue;
      }
      int rc = emit_capped(sa, m, a, MAX_FRAG);
      if (rc < 0) return rc;
      if (rc) {  // > MAX_FRAG pieces: rolled back, materialize instead
        int64_t base = materialize(sa, m);
        if (base < 0) return -10;
        EMIT(a, base, a, ZXCH_KBIG);
      }
      W = a + m;
    } else if (!device_pure) {
      // self-overlap: the repeating unit is the o bytes before the match;
      // materialize it unless it is a single clean piece, then emit one
      // periodic piece for the whole match
      int64_t sa = a - o;
      int64_t run0 = o;
      int64_t sa2 = sa;                     // resolve KOUT chains
      int64_t j0 = sa >= 0 ? resolve_seg(sa2, run0) : -1;
      if (sa >= 0 && j0 >= 0 && run0 >= o && pk[j0] >= ZXCH_KBIG) {
        // window inside one pure piece: periodic piece, no wrap inside
        EMIT(a, pc[j0] + (sa2 - ps[j0]), a, o);
      } else if (sa >= 0 && j0 >= 0 && run0 >= o && pk[j0] == 1) {
        EMIT(a, pc[j0], a, 1);  // fill run keeps filling
      } else {
        int64_t base = materialize(sa, o);
        if (base < 0) return -10;
        EMIT(a, base, a, o);
      }
      W = a + m;
    } else {
      // device_pure self-overlap
      int64_t sa = a - o;
      if (o == 1) {
        // fill: cached 2048-byte pattern per byte value
        uint8_t b;
        if (sa < 0) b = lit_full[D + sa];
        else {
          int64_t run1 = 1;
          int64_t sa2 = sa;                 // resolve KOUT chains
          int64_t j = resolve_seg(sa2, run1);
          if (j < 0) return -9;
          int64_t kk = pk[j];
          int64_t idx = (kk >= ZXCH_KBIG) ? pc[j] + (sa2 - ps[j])
                                          : pc[j] + ((sa2 - ps[j]) % kk);
          b = lit_full[idx];
        }
        if (fill_cache[b] < 0) {
          if (lend + 2048 > (int64_t)lit_cap) return -10;
          memset(lit_full + lend, b, 2048);
          PLAN_REC(1, lend, b, 2048);
          fill_cache[b] = lend;
          lend += 2048;
        }
        // s carries the fill byte value: (p - s) % 1 == 0 for any s, so
        // the mapping is unchanged, and register-splat kernels can read
        // the byte without touching lit_full.
        EMIT(a, fill_cache[b], b, 1);
      } else if (o <= 1024) {
        // small period: materialize the window, replicate to 2048 bytes
        int64_t base = materialize(sa, o);
        if (base < 0) return -10;
        if (base + 2048 > (int64_t)lit_cap) return -10;
        int64_t have = o;
        while (have < 2048) {
          int64_t cp = have < (2048 - have) ? have : (2048 - have);
          memcpy(lit_full + base + have, lit_full + base, cp);
          PLAN_REC(0, base + have, base, cp);
          have += cp;
        }
        lend = base + 2048;
        EMIT(a, base, a, o);
      } else {
        // big period: unroll repetitions as pure/compound pieces; the
        // source window [sa, a) is fully resolved and identical per rep
        int64_t base = -1;
        int64_t done = 0;
        while (done < m) {
          int64_t chunk = (m - done) < o ? (m - done) : o;
          int64_t dst = a + done;
          if (base < 0) {
            int rc = emit_capped(sa, chunk, dst, MAX_FRAG);
            if (rc < 0) return rc;
            if (rc) {
              base = materialize(sa, o);
              if (base < 0) return -10;
            }
          }
          if (base >= 0) EMIT(dst, base, dst, ZXCH_KBIG);
          done += chunk;
        }
      }
      W = a + m;
    }
  }
  // trailing literals
  if (D + r < (int64_t)lit_len) {
    EMIT(W, D + r, W, ZXCH_KBIG);
    W += (int64_t)lit_len - D - r;
  }
#undef EMIT
#undef PLAN_REC
  *lit_len_out = (uint64_t)lend;
  if (plan_of) return -16;
  return (int64_t)np;
}

int64_t zxch_resolve_pieces(const int32_t *ll, const int32_t *ml,
                            const int32_t *off, uint64_t n_seq,
                            uint8_t *lit_full, uint64_t lit_len,
                            uint64_t lit_cap, uint64_t dict_len,
                            int32_t *po, int32_t *pc, int32_t *ps,
                            int32_t *pk, uint64_t max_pieces,
                            uint64_t *lit_len_out, int device_pure,
                            int max_frag) {
  return resolve_pieces_impl(ll, ml, off, n_seq, lit_full, lit_len, lit_cap,
                             dict_len, po, pc, ps, pk, max_pieces,
                             lit_len_out, device_pure, max_frag,
                             nullptr, 0, nullptr);
}

// self-referential variant (v25 kernel contract): non-overlapping matches
// whose source completes before the destination's 16 KiB supertile emit
// ONE piece with pk == ZXCH_KOUT and pc/ps in OUTPUT coordinates —
// out[p] = out[pc + (p - ps)] — instead of fragmenting or materializing.
// Only meaningful with device_pure (the v25 Pallas kernel reads its own
// out_ref rows for these). kout_value receives ZXCH_KOUT so callers can
// detect the kind without hardcoding it.
int64_t zxch_resolve_pieces_sr(const int32_t *ll, const int32_t *ml,
                               const int32_t *off, uint64_t n_seq,
                               uint8_t *lit_full, uint64_t lit_len,
                               uint64_t lit_cap, uint64_t dict_len,
                               int32_t *po, int32_t *pc, int32_t *ps,
                               int32_t *pk, uint64_t max_pieces,
                               uint64_t *lit_len_out, int device_pure,
                               int max_frag, int32_t *kout_value) {
  if (kout_value) *kout_value = ZXCH_KOUT;
  return resolve_pieces_impl(ll, ml, off, n_seq, lit_full, lit_len, lit_cap,
                             dict_len, po, pc, ps, pk, max_pieces,
                             lit_len_out, device_pure, max_frag,
                             nullptr, 0, nullptr, 1);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// optimal parse (levels 6-7): forward DP over positions
// ---------------------------------------------------------------------------

extern "C" {

// lens/offs: best match candidate per position (0 = none). lit_cost_bits:
// per byte value estimated bits (from a sampled Huffman build). Relaxation
// considers the varint cost breakpoints {5,6,7,8,19,147,L} — the cost of a
// match is piecewise constant in length between them (token nibble
// saturation at ml=15 -> first varint byte at L=20, second at L=148).
// Returns the number of sequences written, or -10 if max_seq is too small.
int64_t zxch_optimal_parse(const int32_t *lens, const int32_t *offs,
                           uint64_t P, const uint8_t *data,
                           const uint16_t *lit_cost_bits, int token_bits,
                           int only8, const uint16_t *tok_cost16,
                           int32_t *out_pos, int32_t *out_len,
                           int32_t *out_off, uint64_t max_seq) {
  if (token_bits <= 0) token_bits = 8;
  if (P == 0) return 0;
  const uint32_t INF = 0x7FFFFFFF;
  uint32_t *cost = new uint32_t[P + 1];
  int32_t *fr_len = new int32_t[P + 1];   // 0 = literal step
  for (uint64_t i = 1; i <= P; i++) cost[i] = INF;
  cost[0] = 0;
  fr_len[0] = 0;

  // the offset-byte mode is per BLOCK: if any usable candidate exceeds
  // 256, every sequence pays 16 bits (pricing each at 8 would let the DP
  // accept matches that the block-wide mode makes unprofitable)
  // only8: 8-bit-offset mode — candidates beyond 256 are invisible, the
  // block stays in the cheap offset encoding (callers A/B the two modes
  // and keep the smaller payload; reference zxc_compress.c:1694-1696)
  int off16 = 0;
  if (!only8)
    for (uint64_t p = 0; p < P; p++)
      if (lens[p] >= 5 && offs[p] > 256) { off16 = 1; break; }
  const uint32_t off_bits = off16 ? 16 : 8;

  auto match_bits = [off_bits, token_bits, tok_cost16](int64_t o,
                                                       int64_t L) -> uint32_t {
    (void)o;
    // token pricing: flat token_bits (pass 1), or the LL-marginalized
    // expected code length of tokens with this ML nibble from the
    // ACTUAL candidate token tree (pass 2; reference prices DP tokens
    // with the candidate tree, zxc_compress.c:1665-1688)
    int64_t mf0 = L - 5;
    uint32_t tb = tok_cost16
        ? tok_cost16[mf0 < 15 ? mf0 : 15]
        : (uint32_t)token_bits;
    uint32_t bits = tb + off_bits;           // token + offset
    bits += 2;                               // amortized ll-extras/structure
    int64_t mf = L - 5;
    if (mf >= 15) {
      int64_t ext = mf - 15;
      bits += (ext < 128) ? 8 : (ext < 16384 ? 16 : 24);
    }
    return bits;
  };

  for (uint64_t p = 0; p < P; p++) {
    uint32_t c = cost[p];
    if (c >= INF) continue;
    uint32_t lc = c + lit_cost_bits[data[p]];
    if (lc < cost[p + 1]) { cost[p + 1] = lc; fr_len[p + 1] = 0; }
    int64_t L = lens[p];
    if (L >= 5 && only8 && offs[p] > 256) L = 0;
    if (L >= 5) {
      int64_t o = offs[p];
      if ((uint64_t)(p + L) > P) L = (int64_t)(P - p);
      static const int64_t bp[] = {5, 6, 7, 8, 19, 147};
      for (int bi = 0; bi < 6; bi++) {
        int64_t Ls = bp[bi];
        if (Ls > L) break;
        uint32_t mc = c + match_bits(o, Ls);
        if (mc < cost[p + Ls]) { cost[p + Ls] = mc; fr_len[p + Ls] = (int32_t)Ls; }
      }
      if (L >= 5) {
        uint32_t mc = c + match_bits(o, L);
        if (mc < cost[p + L]) { cost[p + L] = mc; fr_len[p + L] = (int32_t)L; }
      }
    }
  }

  // backtrack: count matches, then fill forward
  uint64_t nseq = 0;
  uint64_t p = P;
  while (p > 0) {
    int32_t fl = fr_len[p];
    if (fl == 0) { p -= 1; } else { p -= fl; nseq++; }
  }
  if (nseq > max_seq) { delete[] cost; delete[] fr_len; return -10; }
  uint64_t k = nseq;
  p = P;
  while (p > 0) {
    int32_t fl = fr_len[p];
    if (fl == 0) { p -= 1; continue; }
    p -= fl;
    k--;
    out_pos[k] = (int32_t)p;
    out_len[k] = fl;
    out_off[k] = offs[p];
  }
  delete[] cost;
  delete[] fr_len;
  return (int64_t)nseq;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// match finder: hash-chain search (the encode hot loop)
// ---------------------------------------------------------------------------

extern "C" {

// Best (length, offset) per position of data[start..n). data includes any
// dictionary prefix of `start` bytes. Own design in the reference's spirit
// (split hash + chain over a 64KB window, probe budget per position, word-
// at-a-time extension); lens[i]==0 means no match at start+i.
static int zxch_find_matches_serial(const uint8_t *data, uint64_t n,
                                    uint64_t start, int max_probes,
                                    int32_t *lens, int32_t *offs) {
  const uint64_t WINDOW = 64 * 1024;
  const int HASH_BITS = 15;
  const uint64_t MIN_MATCH = 5;
  if (n < MIN_MATCH + 1) {
    for (uint64_t i = start; i < n; i++) { lens[i - start] = 0; offs[i - start] = 1; }
    return 0;
  }
  // tag-gated chains, same packing as find_parse ([tag:8|pos:24], sentinel
  // all-ones): a tag mismatch proves the 5 hashed bytes differ, so the
  // candidate is skipped without touching its data. Byte-identical output.
  static thread_local uint32_t head[1 << 15];
  static thread_local uint32_t *fm_chain = nullptr;
  static thread_local uint64_t fm_cap = 0;
  if (n > fm_cap) {
    delete[] fm_chain;
    fm_cap = n * 2;
    fm_chain = new uint32_t[fm_cap];
  }
  uint32_t *chain = fm_chain;
  memset(head, 0xFF, sizeof(head));

  const uint8_t *dat8end = data + (n >= 8 ? n - 8 : 0);
  auto hash5t = [dat8end](const uint8_t *p) -> uint32_t {
    uint64_t v;
    if (p <= dat8end) {
      memcpy(&v, p, 8);
      v &= 0xFFFFFFFFFFull;
    } else {
      v = (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16)
        | ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32);
    }
    uint64_t prod = v * 0x9E3779B97F4A7C15ull;
    return ((uint32_t)(prod >> (64 - HASH_BITS)) << 8)
         | (uint32_t)((prod >> 32) & 0xFF);
  };

  const uint64_t hend = n - (MIN_MATCH - 1);
  // seed dictionary prefix positions (sparse is fine; dense for simplicity)
  for (uint64_t p = 0; p < start && p < hend; p++) {
    uint32_t ht = hash5t(data + p);
    chain[p] = head[ht >> 8];
    head[ht >> 8] = ((ht & 0xFF) << 24) | (uint32_t)p;
  }

  for (uint64_t p = start; p < n; p++) {
    uint64_t i = p - start;
    lens[i] = 0;
    offs[i] = 1;
    if (p >= hend) continue;
    uint32_t ht = hash5t(data + p);
    uint32_t h = ht >> 8;
    uint32_t mytag = ht & 0xFF;
    uint32_t cand = head[h];
    int best_len = 0;
    int64_t best_off = 1;
    int probes = max_probes;
    const uint64_t lim = n;
    while (cand != 0xFFFFFFFFu && probes-- > 0) {
      uint64_t c = cand & 0xFFFFFF;
      if (p - c > WINDOW) break;
      // hoist the next link (needed on every path) so its load overlaps
      // the tag check / extension, and prefetch the link after it —
      // the chain walk is otherwise a serial load-latency chain
      uint32_t nxt = chain[c];
      __builtin_prefetch(&chain[nxt & 0xFFFFFF]);
      __builtin_prefetch(data + (nxt & 0xFFFFFF));
      // tag prefilter, then fast reject on the byte after the current best
      if ((cand >> 24) != mytag ||
          (best_len > 0 &&
           (c + best_len >= lim || data[c + best_len] != data[p + best_len]))) {
        cand = nxt;
        continue;
      }
      // word-at-a-time extension
      uint64_t max_len = lim - p;
      uint64_t m = 0;
      while (m + 8 <= max_len) {
        uint64_t a, b;
        memcpy(&a, data + c + m, 8);
        memcpy(&b, data + p + m, 8);
        uint64_t x = a ^ b;
        if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); goto done; }
        m += 8;
      }
      while (m < max_len && data[c + m] == data[p + m]) m++;
done:
      if ((int)m > best_len) {
        best_len = (int)m;
        best_off = (int64_t)(p - c);
        // reference L6 sufficient_len=256 (zxc_internal.h:962): long
        // enough for the DP; stop burning probes
        if (m >= max_len || best_len >= 256) break;
      }
      cand = nxt;
    }
    if (best_len >= (int)MIN_MATCH) {
      lens[i] = best_len;
      offs[i] = (int32_t)best_off;
    }
    chain[p] = head[h];
    head[h] = (mytag << 24) | (uint32_t)p;
    // long-match skip (reference ZXC_OPT_LONG_MATCH_SKIP,
    // zxc_internal.h:544): interior positions of a very long match
    // inherit its suffix as their candidate instead of searching —
    // keeps the DP feeder O(N) on runs; the final stretch is
    // re-searched so the parse can still leave the match early.
    if (best_len >= 256) {
      const uint64_t keep = 64;
      uint64_t endp = p + (uint64_t)best_len - keep;
      uint64_t q = p + 1;
      for (; q < endp && q < n; q++) {
        uint64_t qi = q - start;
        lens[qi] = best_len - (int)(q - p);
        offs[qi] = (int32_t)best_off;
        if ((q & 3) == 0 && q < hend) {  // sparse chain insertion
          uint32_t ht2 = hash5t(data + q);
          chain[q] = head[ht2 >> 8];
          head[ht2 >> 8] = ((ht2 & 0xFF) << 24) | (uint32_t)q;
        }
      }
      p = q - 1;
    }
  }
  return 0;
}

// Pairwise-interleaved DP candidate search (round 5): two positions'
// chain walks run in one loop so their serial load-latency chains hide
// each other — the walk is latency-bound (tag filter + one chain load
// per probe, L2-resident working set), and at the archival depths
// (64-192 probes) the OoO window cannot overlap consecutive positions'
// walks on its own. BYTE-IDENTICAL to the serial search: position p+1's
// walk sees the chain state *after* p's insert, which differs from the
// pre-pair state only when both hash to the same bucket — candidate p
// is then offered to p+1 explicitly, first, before the shared chain.
// Long-match skips fall back to the serial tail logic (they rewrite the
// following positions wholesale).
int zxch_find_matches(const uint8_t *data, uint64_t n, uint64_t start,
                      int max_probes, int32_t *lens, int32_t *offs) {
  static const int force_serial = getenv("ZXCH_FM_SERIAL") != nullptr;
  if (force_serial)
    return zxch_find_matches_serial(data, n, start, max_probes, lens, offs);
  const uint64_t WINDOW = 64 * 1024;
  const int HASH_BITS = 15;
  const uint64_t MIN_MATCH = 5;
  if (n < MIN_MATCH + 1) {
    for (uint64_t i = start; i < n; i++) { lens[i - start] = 0; offs[i - start] = 1; }
    return 0;
  }
  static thread_local uint32_t head[1 << 15];
  static thread_local uint32_t *fm_chain = nullptr;
  static thread_local uint64_t fm_cap = 0;
  if (n > fm_cap) {
    delete[] fm_chain;
    fm_cap = n * 2;
    fm_chain = new uint32_t[fm_cap];
  }
  uint32_t *chain = fm_chain;
  memset(head, 0xFF, sizeof(head));

  const uint8_t *dat8end = data + (n >= 8 ? n - 8 : 0);
  auto hash5t = [dat8end](const uint8_t *p) -> uint32_t {
    uint64_t v;
    if (p <= dat8end) {
      memcpy(&v, p, 8);
      v &= 0xFFFFFFFFFFull;
    } else {
      v = (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16)
        | ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32);
    }
    uint64_t prod = v * 0x9E3779B97F4A7C15ull;
    return ((uint32_t)(prod >> (64 - HASH_BITS)) << 8)
         | (uint32_t)((prod >> 32) & 0xFF);
  };

  const uint64_t hend = n - (MIN_MATCH - 1);
  for (uint64_t p = 0; p < start && p < hend; p++) {
    uint32_t ht = hash5t(data + p);
    chain[p] = head[ht >> 8];
    head[ht >> 8] = ((ht & 0xFF) << 24) | (uint32_t)p;
  }

  // one probe of a walk; returns 1 while the walk stays active
  auto extend = [&](uint64_t pp, uint64_t c, int &best_len,
                    int64_t &best_off) -> int {
    // returns 1 when the walk should STOP (sufficient/max-len)
    const uint64_t max_len = n - pp;
    uint64_t m = 0;
    while (m + 8 <= max_len) {
      uint64_t a, b;
      memcpy(&a, data + c + m, 8);
      memcpy(&b, data + pp + m, 8);
      uint64_t x = a ^ b;
      if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); goto done; }
      m += 8;
    }
    while (m < max_len && data[c + m] == data[pp + m]) m++;
done:
    if ((int)m > best_len) {
      best_len = (int)m;
      best_off = (int64_t)(pp - c);
      if (m >= max_len || best_len >= 256) return 1;
    }
    return 0;
  };

  uint64_t p = start;
  while (p < n) {
    uint64_t i = p - start;
    lens[i] = 0;
    offs[i] = 1;
    if (p >= hend) { p++; continue; }
    const int paired = (p + 1 < hend);
    uint32_t ht0 = hash5t(data + p);
    const uint32_t h0 = ht0 >> 8, tag0 = ht0 & 0xFF;
    uint32_t cand0 = head[h0];
    int best0 = 0;
    int64_t off0 = 1;
    int probes0 = max_probes;
    uint32_t h1 = 0, tag1 = 0, cand1 = 0xFFFFFFFFu;
    int best1 = 0, probes1 = 0;
    int64_t off1 = 1;
    if (paired) {
      lens[i + 1] = 0;
      offs[i + 1] = 1;
      uint32_t ht1 = hash5t(data + p + 1);
      h1 = ht1 >> 8;
      tag1 = ht1 & 0xFF;
      probes1 = max_probes;
      if (h1 == h0) {
        // serial order: p+1's chain starts at p (inserted after p's
        // search). Offer it explicitly, then continue on the shared
        // pre-pair chain.
        if (probes1-- > 0) {
          int st = 0;
          if (tag0 == tag1)         // tag gate (p's entry carries tag0)
            st = extend(p + 1, p, best1, off1);
          cand1 = st ? 0xFFFFFFFFu : head[h0];
        }
      } else {
        cand1 = head[h1];
      }
    }
    int stop0 = 0, stop1 = !paired;
    while (!stop0 || !stop1) {
      if (!stop0) {
        if (cand0 == 0xFFFFFFFFu || probes0-- <= 0) {
          stop0 = 1;
        } else {
          const uint64_t c = cand0 & 0xFFFFFF;
          if (p - c > WINDOW) {
            stop0 = 1;
          } else {
            const uint32_t nxt = chain[c];
            __builtin_prefetch(&chain[nxt & 0xFFFFFF]);
            __builtin_prefetch(data + (nxt & 0xFFFFFF));
            const uint64_t max_len = n - p;
            if ((cand0 >> 24) == tag0 &&
                !(best0 > 0 &&
                  ((uint64_t)best0 >= max_len ||
                   c + (uint64_t)best0 >= n ||
                   data[c + best0] != data[p + best0]))) {
              if (extend(p, c, best0, off0)) stop0 = 1;
            }
            cand0 = nxt;
          }
        }
      }
      if (!stop1) {
        if (cand1 == 0xFFFFFFFFu || probes1-- <= 0) {
          stop1 = 1;
        } else {
          const uint64_t c = cand1 & 0xFFFFFF;
          if (p + 1 - c > WINDOW) {
            stop1 = 1;
          } else {
            const uint32_t nxt = chain[c];
            __builtin_prefetch(&chain[nxt & 0xFFFFFF]);
            __builtin_prefetch(data + (nxt & 0xFFFFFF));
            const uint64_t max_len = n - (p + 1);
            if ((cand1 >> 24) == tag1 &&
                !(best1 > 0 &&
                  ((uint64_t)best1 >= max_len ||
                   c + (uint64_t)best1 >= n ||
                   data[c + best1] != data[p + 1 + best1]))) {
              if (extend(p + 1, c, best1, off1)) stop1 = 1;
            }
            cand1 = nxt;
          }
        }
      }
    }
    if (best0 >= (int)MIN_MATCH) {
      lens[i] = best0;
      offs[i] = (int32_t)off0;
    }
    chain[p] = head[h0];
    head[h0] = (tag0 << 24) | (uint32_t)p;
    if (best0 >= 256) {
      // serial long-match skip from p (rewrites p+1.. wholesale; the
      // paired walk's p+1 results are discarded — serial parity)
      const uint64_t keep = 64;
      uint64_t endp = p + (uint64_t)best0 - keep;
      uint64_t q = p + 1;
      for (; q < endp && q < n; q++) {
        uint64_t qi = q - start;
        lens[qi] = best0 - (int)(q - p);
        offs[qi] = (int32_t)off0;
        if ((q & 3) == 0 && q < hend) {
          uint32_t ht2 = hash5t(data + q);
          chain[q] = head[ht2 >> 8];
          head[ht2 >> 8] = ((ht2 & 0xFF) << 24) | (uint32_t)q;
        }
      }
      p = q;
      continue;
    }
    if (!paired) { p++; continue; }
    if (best1 >= (int)MIN_MATCH) {
      lens[i + 1] = best1;
      offs[i + 1] = (int32_t)off1;
    }
    chain[p + 1] = head[h1];
    head[h1] = (tag1 << 24) | (uint32_t)(p + 1);
    if (best1 >= 256) {
      const uint64_t keep = 64;
      uint64_t endp = p + 1 + (uint64_t)best1 - keep;
      uint64_t q = p + 2;
      for (; q < endp && q < n; q++) {
        uint64_t qi = q - start;
        lens[qi] = best1 - (int)(q - p - 1);
        offs[qi] = (int32_t)off1;
        if ((q & 3) == 0 && q < hend) {
          uint32_t ht2 = hash5t(data + q);
          chain[q] = head[ht2 >> 8];
          head[ht2 >> 8] = ((ht2 & 0xFF) << 24) | (uint32_t)q;
        }
      }
      p = q;
      continue;
    }
    p += 2;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// greedy / lazy parse (levels 1-5): serial walk over per-position matches
// ---------------------------------------------------------------------------

extern "C" {

// lens/offs: per-position best match (0 = none). Lazy rule: defer a match
// when the next position's match is strictly longer. Returns sequence
// count, or -10 if max_seq too small.
int64_t zxch_lazy_parse(const int32_t *lens, const int32_t *offs, uint64_t P,
                        int lazy, int min_emit, int32_t *out_pos,
                        int32_t *out_len, int32_t *out_off,
                        uint64_t max_seq) {
  if (min_emit < 5) min_emit = 5;
  uint64_t n = 0;
  uint64_t p = 0;
  while (p < P) {
    int32_t l = lens[p];
    if (l < min_emit) { p++; continue; }
    if (lazy && p + 1 < P) {
      int32_t nl = lens[p + 1];
      if (nl >= min_emit && nl > l) { p++; continue; }  // defer to the longer match
    }
    if (n >= max_seq) return -10;
    out_pos[n] = (int32_t)p;
    out_len[n] = l;
    out_off[n] = offs[p];
    n++;
    p += (uint64_t)l;
  }
  return (int64_t)n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// combined find+parse (levels 1-5): search only where the parse stands
// ---------------------------------------------------------------------------

extern "C" {

// Greedy/lazy encode walk: hash-chain search at the parse cursor only
// (positions inside emitted matches are inserted into the chains but never
// searched), which is what makes real-time LZ encoders fast. Emits
// (pos, len, off) relative to `start`. Returns sequence count or -10.
int64_t zxch_find_parse(const uint8_t *data, uint64_t n, uint64_t start,
                        int max_probes, int lazy, int sufficient_len,
                        int step_base, int step_shift, int cover_base,
                        int min_emit, int32_t *out_pos, int32_t *out_len,
                        int32_t *out_off, uint64_t max_seq) {
  if (sufficient_len <= 0) sufficient_len = 1 << 30;
  if (min_emit < 5) min_emit = 5;
  if (step_base <= 0) step_base = 1;
  if (step_shift <= 0) step_shift = 30;
  if (cover_base <= 0) cover_base = 1;
  const uint64_t WINDOW = 64 * 1024;
#ifndef ZXCH_FP_HASH_BITS
#define ZXCH_FP_HASH_BITS 15
#endif
  const int HASH_BITS = ZXCH_FP_HASH_BITS;
  const uint64_t MIN_MATCH = 5;
  static thread_local uint32_t head[1 << ZXCH_FP_HASH_BITS];
  static thread_local uint8_t tags8[1 << ZXCH_FP_HASH_BITS];
  // fast tier (L1-2 params): filter-first on a 32KB L1-resident tag
  // table; on tag mismatch the bucket's chain is NOT extended (the
  // reference's fast-level economics, zxc_compress.c:219-239: losing
  // cross-group chain history costs a sliver of ratio for a large cut
  // in head-table traffic on miss-heavy regions)
  const int fast_tier = (max_probes <= 5);
  if (n < MIN_MATCH + 1) return 0;
  // head/chain entries pack [tag(8) | pos(24)]: positions must fit 24
  // bits or match selection silently degrades (output stays valid —
  // matches verify byte-by-byte — but with no diagnostic). Our own
  // paths cap dict_len at 65535 and block_size at 2 MiB; reject exotic
  // C-ABI dict windows instead of corrupting the tag byte.
  if (n > (1ull << 24)) return -10;
  // dict-seed snapshot state (restored below when the same dict returns).
  // seed_tier keys the snapshot on the hash index width: a fast-tier
  // (14-bit) table restored into a 15-bit walk (or vice versa) would
  // still verify matches byte-by-byte but tie-break differently
  // depending on the PREVIOUS call's level — archives must not depend
  // on call history.
  static thread_local uint8_t *seed_dict = nullptr;
  static thread_local uint32_t *seed_chain = nullptr;
  static thread_local uint32_t *seed_head = nullptr;
  static thread_local uint64_t seed_cap = 0, seed_start = 0;
  static thread_local int seed_tier = -1;
  const uint64_t SB = start >= 4 ? start - 4 : 0;  // cache-covered prefix
  const bool seed_hit = start > 0 && SB > 0 && seed_start == start &&
                        seed_tier == fast_tier &&
                        seed_dict && memcmp(seed_dict, data, start) == 0;
  if (!seed_hit) {
    memset(head, 0xFF, sizeof(head));  // 0xFFFFFFFF = empty (pos > any n)
    if (fast_tier) memset(tags8, 0, sizeof(tags8));
  }
  // NOTE the seeded-path tags8 rebuild lives BELOW, after head is
  // restored from the snapshot. Rebuilding here (as round 4 first did)
  // read the PREVIOUS call's final head state — an inconsistent
  // tags8<->head pair whose tag filter tie-broke matches differently
  // depending on which block a thread had encoded before (found when
  // the MT frame encoder's byte-equality test caught frame-loop vs
  // block-order divergence on dict fast-tier archives).
  // reusable per-thread chain buffer (grown on demand): skips the per-call
  // allocation + first-touch page faults of new[]
  static thread_local uint32_t *chain_buf = nullptr;
  static thread_local uint64_t chain_cap = 0;
  if (n > chain_cap) {
    delete[] chain_buf;
    chain_cap = n * 2;
    chain_buf = new uint32_t[chain_cap];
  }
  uint32_t *chain = chain_buf;
  const uint64_t hend = n - (MIN_MATCH - 1);

  const uint8_t *dat8end = data + (n >= 8 ? n - 8 : 0);
  // returns (index << 8) | tag: tag is 8 more product bits — equal 5-byte
  // strings get equal tags, so a tag mismatch proves the candidate cannot
  // reach MIN_MATCH and is skipped without touching its data (the
  // reference's hash_tags filter, zxc_compress.c:212-229). Entries in
  // head/chain pack [tag:8 | pos:24]; output is byte-identical with or
  // without the filter.
  // NOTE round-5 negative result: a fast-tier-only 14-bit index (64KB
  // active head + 16KB tags, closer to L1-residency) measured 1.017-
  // 1.026x in one interleaved A/B and 0.980-0.987x in the next at
  // +0.07-0.24% size — inside harness noise, so the uniform 15-bit
  // table stays (ZXCH_FP_HASH_BITS is the build-time A/B hook).
  const int HB = HASH_BITS;
  auto hash5t = [dat8end, HB](const uint8_t *p) -> uint32_t {
    uint64_t v;
    if (p <= dat8end) {  // single wide load except in the last 7 bytes
      memcpy(&v, p, 8);
      v &= 0xFFFFFFFFFFull;
    } else {
      v = (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16)
        | ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32);
    }
    uint64_t prod = v * 0x9E3779B97F4A7C15ull;
    uint32_t idx = (uint32_t)(prod >> (64 - HB));
    uint32_t tag = (uint32_t)((prod >> 32) & 0xFF);
    return (idx << 8) | tag;
  };

  auto insert_ht = [&](uint64_t p, uint32_t ht) {
    uint32_t h = ht >> 8;
    chain[p] = head[h];
    head[h] = ((ht & 0xFF) << 24) | (uint32_t)p;
    tags8[h] = (uint8_t)(ht & 0xFF);  // keep the fast-tier filter in sync
                                      // (dict seeding runs through here)
  };

  auto insert = [&](uint64_t p) {
    if (p < hend) insert_ht(p, hash5t(data + p));
  };

  int64_t rep_off = 0;  // last emitted offset (reference seeds this,
                        // zxc_compress.c:242-267)
  uint32_t cur_ht = 0;  // hash computed by the last search() at its cursor
                        // (valid whenever that cursor was < hend)

  auto try_cand = [&](uint64_t p, uint64_t c, int *best_len,
                      int64_t *best_off) {
    const uint64_t max_len = n - p;
    // best_len >= max_len guard: a match already reaching end-of-buffer
    // cannot be beaten, and data[p + *best_len] would read one past the
    // buffer (C-ABI callers pass exactly-sized buffers; PyBytes' trailing
    // NUL masked this). Skipping is byte-identical.
    if (*best_len > 0 &&
        ((uint64_t)*best_len >= max_len ||
         c + (uint64_t)*best_len >= n ||
         data[c + *best_len] != data[p + *best_len]))
      return;
    uint64_t m = 0;
    while (m + 8 <= max_len) {
      uint64_t a, b;
      memcpy(&a, data + c + m, 8);
      memcpy(&b, data + p + m, 8);
      uint64_t x = a ^ b;
      if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); goto done; }
      m += 8;
    }
    while (m < max_len && data[c + m] == data[p + m]) m++;
done:
    if ((int)m > *best_len) {
      *best_len = (int)m;
      *best_off = (int64_t)(p - c);
    }
  };

  auto search = [&](uint64_t p, int *best_len, int64_t *best_off) {
    *best_len = 0;
    *best_off = 1;
    if (p >= hend) return;
    // repeat-offset candidate first: free, and structured data repeats.
    // Gated on 4-byte equality: a >= MIN_MATCH match always passes, and
    // sub-MIN_MATCH bests never reach the output (miss path discards l),
    // so skipping the full extend on first-4 mismatch is byte-identical
    // while saving ~1M speculative extends on this corpus class.
#ifndef ZXCH_NO_REP
    if (rep_off > 0 && p >= (uint64_t)rep_off && p < hend) {
      uint32_t a4, b4;
      memcpy(&a4, data + p, 4);
      memcpy(&b4, data + p - (uint64_t)rep_off, 4);
      if (a4 == b4)
        try_cand(p, p - (uint64_t)rep_off, best_len, best_off);
    }
#endif
    uint32_t ht = cur_ht = hash5t(data + p);
    if (*best_len >= sufficient_len) return;  // good enough: stop searching
    uint32_t mytag = ht & 0xFF;
    uint32_t cand = head[ht >> 8];
    int probes = max_probes;
    const uint64_t max_len = n - p;
    while (cand != 0xFFFFFFFFu && probes-- > 0) {
      uint64_t c = cand & 0xFFFFFF;
      if (p - c > WINDOW) break;
      // hoist the next link + prefetch one ahead: the chain walk is a
      // serial load-latency chain otherwise (same treatment as
      // zxch_find_matches; byte-identical output)
      uint32_t nxt = chain[c];
      __builtin_prefetch(&chain[nxt & 0xFFFFFF]);
      __builtin_prefetch(data + (nxt & 0xFFFFFF));
      if ((cand >> 24) != mytag ||
          (*best_len > 0 &&
           ((uint64_t)*best_len >= max_len ||  // end-of-buffer: overread guard
            c + (uint64_t)*best_len >= n ||
            data[c + *best_len] != data[p + *best_len]))) {
        cand = nxt;
        continue;
      }
      uint64_t m = 0;
      while (m + 8 <= max_len) {
        uint64_t a, b;
        memcpy(&a, data + c + m, 8);
        memcpy(&b, data + p + m, 8);
        uint64_t x = a ^ b;
        if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); goto done; }
        m += 8;
      }
      while (m < max_len && data[c + m] == data[p + m]) m++;
done:
      if ((int)m > *best_len) {
        *best_len = (int)m;
        *best_off = (int64_t)(p - c);
        if (m >= max_len || *best_len >= sufficient_len) break;
      }
      cand = nxt;
    }
  };

  // Dictionary-window seeding. Re-hashing the whole prefix per call
  // dominates small-frame dict encodes (16-64K inserts per 4KB file), so
  // the head/chain state after seeding [0, start-4) — which depends only
  // on the dict bytes (hash5t at p reads data[p..p+4], and p+4 < start
  // there) — is snapshotted per thread and restored by memcpy when the
  // same dict bytes come back (exact memcmp key, no hash collisions).
  // The last 4 positions hash across the dict/block boundary and are
  // re-inserted per call. Byte-identical with the plain loop; the
  // reference instead re-seeds per block, sparsely (zxc_compress.c:1090).
  if (start > 0) {
    if (seed_hit) {
      memcpy(head, seed_head, sizeof(head));
      memcpy(chain, seed_chain, SB * sizeof(uint32_t));
      if (fast_tier)  // rebuild from the RESTORED head (see note above)
        for (int i = 0; i < (1 << HASH_BITS); i++)
          tags8[i] = (uint8_t)(head[i] >> 24);
    } else {
      for (uint64_t p = 0; p < SB; p++) insert(p);
      if (SB > 0) {
        if (!seed_head) seed_head = new uint32_t[1 << HASH_BITS];
        if (start > seed_cap) {
          delete[] seed_dict;
          delete[] seed_chain;
          seed_dict = new uint8_t[start];
          seed_chain = new uint32_t[start];
          seed_cap = start;
        }
        memcpy(seed_head, head, sizeof(head));
        memcpy(seed_chain, chain, SB * sizeof(uint32_t));
        memcpy(seed_dict, data, start);
        seed_start = start;
        seed_tier = fast_tier;
      }
    }
    for (uint64_t p = SB; p < start; p++) insert(p);
  }

  // fast-tier search: one tags8 load gates everything; a mismatch skips
  // the head load AND breaks the bucket's chain at p (sentinel link)
  auto search_fast = [&](uint64_t p, int *best_len, int64_t *best_off) {
    *best_len = 0;
    *best_off = 1;
    if (p >= hend) return;
#ifndef ZXCH_NO_REP
    if (rep_off > 0 && p >= (uint64_t)rep_off) {
      uint32_t a4, b4;
      memcpy(&a4, data + p, 4);
      memcpy(&b4, data + p - (uint64_t)rep_off, 4);
      if (a4 == b4)
        try_cand(p, p - (uint64_t)rep_off, best_len, best_off);
    }
#endif
    uint32_t ht = cur_ht = hash5t(data + p);
    uint32_t h = ht >> 8;
    uint32_t mytag = ht & 0xFF;
    if (tags8[h] != (uint8_t)mytag) {
      // group alternation: break the chain, take the bucket
      chain[p] = 0xFFFFFFFFu;
      head[h] = (mytag << 24) | (uint32_t)p;
      tags8[h] = (uint8_t)mytag;
      return;
    }
    if (*best_len >= sufficient_len) {
      uint32_t old = head[h];
      chain[p] = old;
      head[h] = (mytag << 24) | (uint32_t)p;
      return;
    }
    uint32_t cand = head[h];
    chain[p] = cand;
    head[h] = (mytag << 24) | (uint32_t)p;
    int probes = max_probes;
    const uint64_t max_len = n - p;
    while (cand != 0xFFFFFFFFu && probes-- > 0) {
      uint64_t c = cand & 0xFFFFFF;
      if (p - c > WINDOW) break;
      uint32_t nxt = chain[c];
      if ((cand >> 24) != mytag ||
          (*best_len > 0 &&
           ((uint64_t)*best_len >= max_len ||  // end-of-buffer: overread guard
            c + (uint64_t)*best_len >= n ||
            data[c + *best_len] != data[p + *best_len]))) {
        cand = nxt;
        continue;
      }
      uint64_t m = 0;
      while (m + 8 <= max_len) {
        uint64_t a, b;
        memcpy(&a, data + c + m, 8);
        memcpy(&b, data + p + m, 8);
        uint64_t x = a ^ b;
        if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); goto fdone; }
        m += 8;
      }
      while (m < max_len && data[c + m] == data[p + m]) m++;
fdone:
      if ((int)m > *best_len) {
        *best_len = (int)m;
        *best_off = (int64_t)(p - c);
        if (m >= max_len || *best_len >= sufficient_len) break;
      }
      cand = nxt;
    }
  };

  auto insert_fast = [&](uint64_t p) {
    if (p >= hend) return;
    uint32_t ht = hash5t(data + p);
    uint32_t h = ht >> 8;
    chain[p] = head[h];
    head[h] = ((ht & 0xFF) << 24) | (uint32_t)p;
    tags8[h] = (uint8_t)(ht & 0xFF);
  };

  // L1 depth-1 tier probe (max_probes <= 2, no lazy): tags8 gate in
  // front, single head candidate, store-only inserts.
  if (fast_tier && max_probes <= 2 && !lazy) {
    uint64_t nseq = 0;
    uint64_t p = start;
    uint64_t anchor = start;
    while (p < n) {
      int l = 0;
      int64_t o = 1;
      if (p < hend) {
        const uint64_t max_len = n - p;
#ifndef ZXCH_NO_REP
        if (rep_off > 0 && p >= (uint64_t)rep_off) {
          uint32_t a4, b4;
          memcpy(&a4, data + p, 4);
          memcpy(&b4, data + p - (uint64_t)rep_off, 4);
          if (a4 == b4) {
            const uint64_t c = p - (uint64_t)rep_off;
            uint64_t m = 0;
            while (m + 8 <= max_len) {
              uint64_t a, b;
              memcpy(&a, data + c + m, 8);
              memcpy(&b, data + p + m, 8);
              uint64_t x = a ^ b;
              if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); break; }
              m += 8;
            }
            if (m + 8 > max_len)
              while (m < max_len && data[c + m] == data[p + m]) m++;
            l = (int)m;
            o = rep_off;
          }
        }
#endif
        uint32_t ht = hash5t(data + p);
        uint32_t h = ht >> 8;
        uint32_t mytag = ht & 0xFF;
        if (tags8[h] != (uint8_t)mytag) {
          tags8[h] = (uint8_t)mytag;
          head[h] = (mytag << 24) | (uint32_t)p;
        } else {
          uint32_t cand = head[h];
          head[h] = (mytag << 24) | (uint32_t)p;
          if (l < sufficient_len && cand != 0xFFFFFFFFu &&
              (cand >> 24) == mytag) {
            uint64_t c = cand & 0xFFFFFF;
            if (p - c <= WINDOW &&
                !(l > 0 && ((uint64_t)l >= max_len ||  // overread guard
                            c + (uint64_t)l >= n ||
                            data[c + l] != data[p + l]))) {
              uint64_t m = 0;
              while (m + 8 <= max_len) {
                uint64_t a, b;
                memcpy(&a, data + c + m, 8);
                memcpy(&b, data + p + m, 8);
                uint64_t x = a ^ b;
                if (x) { m += (uint64_t)(__builtin_ctzll(x) >> 3); break; }
                m += 8;
              }
              if (m + 8 > max_len)
                while (m < max_len && data[c + m] == data[p + m]) m++;
              if ((int)m > l) {
                l = (int)m;
                o = (int64_t)(p - c);
              }
            }
          }
        }
      }
      if (l < min_emit) {
        p += (uint64_t)step_base + ((p - anchor) >> step_shift);
        continue;
      }
      uint64_t bt = 0;
      while (p - bt > anchor && p - bt > (uint64_t)o &&
             data[p - bt - 1] == data[p - bt - 1 - (uint64_t)o])
        bt++;
      if (nseq >= max_seq) return -10;
      out_pos[nseq] = (int32_t)(p - bt - start);
      out_len[nseq] = l + (int32_t)bt;
      out_off[nseq] = (int32_t)o;
      rep_off = o;
      nseq++;
      uint64_t end = p + (uint64_t)l;
      uint64_t step = (uint64_t)(l > 32 ? 2 * cover_base : cover_base);
      for (uint64_t q = p + step; q < end && q < hend; q += step) {
        uint32_t ht = hash5t(data + q);
        uint32_t h = ht >> 8;
        head[h] = ((ht & 0xFF) << 24) | (uint32_t)q;
        tags8[h] = (uint8_t)(ht & 0xFF);
      }
      p = end;
      anchor = end;
    }
    return (int64_t)nseq;
  }

  if (fast_tier) {
    uint64_t nseq = 0;
    uint64_t p = start;
    uint64_t anchor = start;
    while (p < n) {
      int l;
      int64_t o;
      search_fast(p, &l, &o);   // search inserts p itself
      if (l < min_emit) {
        p += (uint64_t)step_base + ((p - anchor) >> step_shift);
        continue;
      }
      uint64_t already = p;
      if (lazy && l < sufficient_len && p + 1 < n) {
        int l2;
        int64_t o2;
        search_fast(p + 1, &l2, &o2);
        already = p + 1;
        if (l2 >= min_emit && l2 > l) { p++; l = l2; o = o2; }
      }
      uint64_t bt = 0;
      while (p - bt > anchor && p - bt > (uint64_t)o &&
             data[p - bt - 1] == data[p - bt - 1 - (uint64_t)o])
        bt++;
      if (nseq >= max_seq) return -10;
      out_pos[nseq] = (int32_t)(p - bt - start);
      out_len[nseq] = l + (int32_t)bt;
      out_off[nseq] = (int32_t)o;
      rep_off = o;
      nseq++;
      uint64_t end = p + (uint64_t)l;
      uint64_t step = (uint64_t)(l > 32 ? 2 * cover_base : cover_base);
      uint64_t q0 = (already > p ? already : p) + step;
      for (uint64_t q = q0; q < end && q < hend; q += step)
        insert_fast(q);
      p = end;
      anchor = end;
    }
    return (int64_t)nseq;
  }

  uint64_t nseq = 0;
  uint64_t p = start;
  uint64_t anchor = start;  // end of last emitted match: backtrack floor
  while (p < n) {
    int l;
    int64_t o;
    search(p, &l, &o);
    if (l < min_emit) {
      // accelerating miss step (reference zxc_compress.c:1231): skip
      // ahead through incompressible runs, skipped positions not inserted
      if (p < hend) insert_ht(p, cur_ht);
      p += (uint64_t)step_base + ((p - anchor) >> step_shift);
      continue;
    }
    uint64_t already = 0;  // positions <= p already inserted by lazy probe
    if (lazy && l < sufficient_len && p + 1 < n) {
      int l2;
      int64_t o2;
      if (p < hend) insert_ht(p, cur_ht);
      already = p + 1;
      search(p + 1, &l2, &o2);
      if (l2 >= min_emit && l2 > l) { p++; l = l2; o = o2; }
    }
    // backward extension into the pending literal run (reference
    // zxc_compress.c:452-463): reclaim literals that also match at -off
    uint64_t bt = 0;
    while (p - bt > anchor && p - bt > (uint64_t)o &&
           data[p - bt - 1] == data[p - bt - 1 - (uint64_t)o])
      bt++;
    if (nseq >= max_seq) return -10;
    out_pos[nseq] = (int32_t)(p - bt - start);
    out_len[nseq] = l + (int32_t)bt;
    out_off[nseq] = (int32_t)o;
    rep_off = o;
    nseq++;
    // insert covered positions (stride 2 beyond 64 keeps long runs cheap)
    uint64_t end = p + (uint64_t)l;
    // insertion density inside the emitted match: sparser chains trade a
    // few hundredths of a percent of ratio for large speed wins at fast
    // levels (cover_base=1 restores full-density insertion)
    uint64_t step = (uint64_t)(l > 32 ? 2 * cover_base : cover_base);
    uint64_t q0 = p < already ? already : p;
    for (uint64_t q = q0; q < end && q < hend; q += step) insert(q);
    p = end;
    anchor = end;
  }
  return (int64_t)nseq;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// window merge-op emission: precompute the Pallas copy kernel's control
// ---------------------------------------------------------------------------

extern "C" {

// Split device_pure pieces into 1024-byte-window-confined merge ops with
// every scalar the kernel needs precomputed:
//   f0 = source row granule (8-row aligned) ... 0 for fills
//   f1 = net roll amount ((src0%1024 - dlo%1024) mod 2048)
//   f2 = dlo | dhi << 16     (window-relative destination bounds)
//   f3 = fill ? fill_byte + 1 : 0
// wstart[wi] = first op of window wi (wstart[n_windows] = n_ops).
// Returns op count or -10 when max_ops is too small.
int64_t zxch_window_ops(const int32_t *po, const int32_t *pc,
                        const int32_t *ps, const int32_t *pk, uint64_t n,
                        int64_t total, int32_t *ops, int32_t *wstart,
                        uint64_t max_ops) {
  const int64_t W = 1024;
  int64_t n_windows = (total + W - 1) / W;
  uint64_t nops = 0;
  uint64_t j = 0;
  for (int64_t wi = 0; wi < n_windows; wi++) {
    wstart[wi] = (int32_t)nops;
    int64_t w0 = wi * W;
    int64_t w1 = w0 + W;
    while (j < n) {
      int64_t o = po[j];
      if (o >= w1) break;
      int64_t e = (j + 1 < n) ? po[j + 1] : total;
      int64_t lo = o > w0 ? o : w0;
      int64_t hi = e < w1 ? e : w1;
      if (hi > lo) {
        if (nops >= max_ops) return -10;
        int64_t dlo = lo - w0;
        int64_t dhi = hi - w0;
        int64_t k = pk[j];
        if (k == 1) {
          ops[4 * nops + 0] = 0;
          ops[4 * nops + 1] = 0;
          ops[4 * nops + 2] = (int32_t)(dlo | (dhi << 16));
          ops[4 * nops + 3] = (int32_t)((ps[j] & 0xFF) + 1);
        } else {
          int64_t phase = (lo - ps[j]) % k;
          int64_t src0 = pc[j] + phase;
          ops[4 * nops + 0] = (int32_t)((src0 / W) * 8);
          ops[4 * nops + 1] = (int32_t)(((src0 % W) - dlo + 2 * W) % (2 * W));
          ops[4 * nops + 2] = (int32_t)(dlo | (dhi << 16));
          ops[4 * nops + 3] = 0;
        }
        nops++;
      }
      if (e <= w1) j++; else break;
    }
  }
  wstart[n_windows] = (int32_t)nops;
  return (int64_t)nops;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// window merge-op emission v2: also split at SOURCE 1024-granule crossings
// so the kernel rolls single-vreg (8,128) tiles
// ---------------------------------------------------------------------------

extern "C" {

int64_t zxch_window_ops2(const int32_t *po, const int32_t *pc,
                         const int32_t *ps, const int32_t *pk, uint64_t n,
                         int64_t total, int32_t *ops, int32_t *wstart,
                         uint64_t max_ops) {
  const int64_t W = 1024;
  int64_t n_windows = (total + W - 1) / W;
  uint64_t nops = 0;
  uint64_t j = 0;
  for (int64_t wi = 0; wi < n_windows; wi++) {
    wstart[wi] = (int32_t)nops;
    int64_t w0 = wi * W;
    int64_t w1 = w0 + W;
    while (j < n) {
      int64_t o = po[j];
      if (o >= w1) break;
      int64_t e = (j + 1 < n) ? po[j + 1] : total;
      int64_t lo = o > w0 ? o : w0;
      int64_t hi = e < w1 ? e : w1;
      int64_t k = pk[j];
      while (hi > lo) {
        int64_t dlo = lo - w0;
        int64_t seg_hi = hi;
        int32_t f0 = 0, f1 = 0, f3 = 0;
        if (k == 1) {
          f3 = (int32_t)((ps[j] & 0xFF) + 1);
        } else {
          int64_t phase = (lo - ps[j]) % k;
          int64_t src0 = pc[j] + phase;
          int64_t src_room = W - (src0 % W);
          if (seg_hi - lo > src_room) seg_hi = lo + src_room;
          f0 = (int32_t)((src0 / W) * 8);
          f1 = (int32_t)(((src0 % W) - dlo + W) % W);
        }
        if (nops >= max_ops) return -10;
        ops[4 * nops + 0] = f0;
        ops[4 * nops + 1] = f1;
        ops[4 * nops + 2] = (int32_t)(dlo | ((seg_hi - w0) << 16));
        ops[4 * nops + 3] = f3;
        nops++;
        lo = seg_hi;
      }
      if (e <= w1) j++; else break;
    }
  }
  wstart[n_windows] = (int32_t)nops;
  return (int64_t)nops;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PivCo-Huffman section decode (enc_lit=2/3 hot path)
// ---------------------------------------------------------------------------

extern "C" {

// Port of the project's conformance-verified Python implementation
// (zxc_tpu/codec/huffman.py): canonical trie build with Kraft validation,
// BFS run sizing (pass 1), bottom-up level merges (pass 2).
// code_len: 256 entries (0 = absent). Decodes exactly n symbols from
// payload (node runs only, no lengths header). Returns 0 or negative err.
int zxch_pivco_decode_s(const uint8_t *payload, uint64_t plen,
                        const uint8_t *code_len, uint64_t n, uint8_t *out,
                        uint8_t *user_scratch) {
  const int MAXLEN = 11;
  const int MAXN = 2 * 256 - 1;
  if (n == 0) return -8;

  // canonical code assignment
  int64_t bl_count[MAXLEN + 2] = {0};
  int present = 0;
  for (int s = 0; s < 256; s++) {
    if (code_len[s]) {
      if (code_len[s] > MAXLEN) return -8;
      bl_count[code_len[s]]++;
      present++;
    }
  }
  if (!present) return -8;
  if (present >= 2) {
    int64_t kraft = 0;
    for (int l = 1; l <= MAXLEN; l++) kraft += bl_count[l] << (MAXLEN - l);
    if (kraft != (int64_t)1 << MAXLEN) return -8;
  } else if (bl_count[1] != 1) {
    return -8;
  }
  uint32_t next_code[MAXLEN + 2] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= MAXLEN; l++) {
    code = (code + (uint32_t)bl_count[l - 1]) << 1;
    next_code[l] = code;
  }

  // trie
  int16_t child[MAXN][2];
  int16_t sym[MAXN];
  memset(child, -1, sizeof(child));
  memset(sym, -1, sizeof(sym));
  int n_nodes = 1;
  int max_depth = 0;
  for (int s = 0; s < 256; s++) {
    int l = code_len[s];
    if (!l) continue;
    uint32_t c = next_code[l]++;
    if (c >> l) return -8;
    int cur = 0;
    for (int d = l - 1; d >= 0; d--) {
      if (sym[cur] >= 0) return -8;
      int bit = (c >> d) & 1;
      int nxt = child[cur][bit];
      if (nxt < 0) {
        if (n_nodes >= MAXN) return -8;
        nxt = n_nodes++;
        child[cur][bit] = (int16_t)nxt;
      }
      cur = nxt;
    }
    if (child[cur][0] >= 0 || child[cur][1] >= 0) return -8;
    sym[cur] = (int16_t)s;
    if (l > max_depth) max_depth = l;
  }

  // BFS order + level starts
  int16_t bfs[MAXN];
  int16_t lvl_start[MAXLEN + 3] = {0};
  int head = 0, tail = 0;
  bfs[tail++] = 0;
  int depth_end = 1, depth = 0;
  while (head < tail) {
    if (head == depth_end) {
      depth++;
      lvl_start[depth] = (int16_t)head;
      depth_end = tail;
    }
    int nid = bfs[head++];
    for (int b = 0; b < 2; b++)
      if (child[nid][b] >= 0) bfs[tail++] = child[nid][b];
  }
  for (int d = depth + 1; d <= max_depth + 1; d++)
    lvl_start[d] = (int16_t)tail;

  // flat-subtree detection (min/max leaf depth; maximality masking)
  int8_t mn[MAXN], mx[MAXN];
  uint8_t flat_d[MAXN];
  bool covered[MAXN];
  memset(flat_d, 0, sizeof(flat_d));
  memset(covered, 0, sizeof(covered));
  for (int i = n_nodes - 1; i >= 0; i--) {
    int nid = bfs[i];
    if (sym[nid] >= 0) {
      mn[nid] = mx[nid] = 0;
    } else if (child[nid][0] >= 0 && child[nid][1] >= 0) {
      int8_t a0 = mn[child[nid][0]], a1 = mn[child[nid][1]];
      int8_t b0 = mx[child[nid][0]], b1 = mx[child[nid][1]];
      mn[nid] = (int8_t)(1 + (a0 < a1 ? a0 : a1));
      mx[nid] = (int8_t)(1 + (b0 > b1 ? b0 : b1));
    } else {
      mn[nid] = 0;
      mx[nid] = MAXLEN;
    }
  }
  for (int i = 0; i < n_nodes; i++) {
    int nid = bfs[i];
    if (!covered[nid] && sym[nid] < 0 && mn[nid] == mx[nid] && mn[nid] >= 2)
      flat_d[nid] = (uint8_t)mn[nid];
    bool cov = covered[nid] || flat_d[nid] > 0;
    for (int b = 0; b < 2; b++)
      if (child[nid][b] >= 0) covered[child[nid][b]] = cov;
  }

  // pass 1: BFS run walk, per-node counts and run pointers
  int64_t count[MAXN];
  const uint8_t *run_ptr[MAXN];
  memset(count, 0, sizeof(count));
  count[0] = (int64_t)n;
  uint64_t pos = 0;
  for (int i = 0; i < n_nodes; i++) {
    int nid = bfs[i];
    if (covered[nid] || sym[nid] >= 0) continue;
    int64_t c = count[nid];
    int fd = flat_d[nid];
    uint64_t nbytes = fd ? ((uint64_t)c * fd + 7) / 8 : ((uint64_t)c + 7) / 8;
    if (plen - pos < nbytes) return -8;
    run_ptr[nid] = payload + pos;
    pos += nbytes;
    if (fd) continue;
    // popcount the run's first c bits (8 bytes per step)
    int64_t ones = 0;
    uint64_t full = (uint64_t)c / 8;
    uint64_t k = 0;
    for (; k + 8 <= full; k += 8) {
      uint64_t v;
      memcpy(&v, run_ptr[nid] + k, 8);
      ones += __builtin_popcountll(v);
    }
    for (; k < full; k++)
      ones += __builtin_popcount(run_ptr[nid][k]);
    int rem = (int)(c & 7);
    if (rem)
      ones += __builtin_popcount(run_ptr[nid][full] & ((1u << rem) - 1));
    int ch0 = child[nid][0], ch1 = child[nid][1];
    if (ch1 >= 0) count[ch1] = ones;
    else if (ones) return -8;
    if (ch0 >= 0) count[ch0] = c - ones;
    else if (c - ones) return -8;
  }

  // per-level sequence offsets
  int64_t seq_off[MAXN];
  memset(seq_off, 0, sizeof(seq_off));
  for (int d = 0; d <= max_depth; d++) {
    int64_t off = 0;
    for (int i = lvl_start[d]; i < lvl_start[d + 1]; i++) {
      int nid = bfs[i];
      if (covered[nid]) continue;
      seq_off[nid] = off;
      off += count[nid];
    }
  }

  // pass 2: bottom-up level merges (ping-pong buffers)
  uint8_t *scratch = user_scratch ? user_scratch : new uint8_t[n];
  uint8_t *bufs[2] = {out, scratch};
  for (int d = max_depth; d >= 0; d--) {
    uint8_t *bd = bufs[d & 1];
    uint8_t *bc = bufs[(d + 1) & 1];
    for (int i = lvl_start[d]; i < lvl_start[d + 1]; i++) {
      int nid = bfs[i];
      if (covered[nid]) continue;
      int64_t c = count[nid];
      if (c == 0) continue;
      int64_t o = seq_off[nid];
      if (sym[nid] >= 0) {
        // leaf: skip if parent handles... parents read from bc; fill here
        memset(bd + o, (uint8_t)sym[nid], c);
      } else if (flat_d[nid]) {
        int D = flat_d[nid];
        // path->symbol table
        uint8_t c2s[1 << 11];
        struct Item { int nid, path, len; } stack[64];
        int sp = 0;
        stack[sp++] = {nid, 0, 0};
        while (sp) {
          Item it = stack[--sp];
          if (sym[it.nid] >= 0) {
            c2s[it.path] = (uint8_t)sym[it.nid];
            continue;
          }
          stack[sp++] = {child[it.nid][0], it.path, it.len + 1};
          stack[sp++] = {child[it.nid][1], it.path | (1 << it.len), it.len + 1};
        }
        const uint8_t *rp = run_ptr[nid];
        const uint64_t nbytes = ((uint64_t)c * D + 7) / 8;
        const uint64_t dmask = (1u << D) - 1;
        uint64_t bitpos = 0;
        int64_t t = 0;
#ifdef ZXCH_HAVE_VBMI
        // 64 symbols per step for D<=6 (the reference's SIMD flat
        // unpackers, zxc_huffman.c:1666-2057, via VBMI instead of
        // pshufb): one unaligned 64B load; permutexvar places the 8
        // bytes holding lane j's symbols (byte offset j*D) into qword
        // lane j; multishift extracts the 8 D-bit fields per lane
        // (bit offset k*D, identical across lanes since 64*D = 8D
        // bytes keeps steps byte-aligned); a 64-entry permutexvar LUT
        // maps field -> symbol. Overread stays inside the payload.
        if (D <= 6 && c >= 64) {
          alignas(64) uint8_t tmp[64];
          for (int j = 0; j < 64; j++)
            tmp[j] = (uint8_t)((j >> 3) * D + (j & 7));
          const __m512i vpidx = _mm512_load_si512(tmp);
          for (int j = 0; j < 64; j++) tmp[j] = (uint8_t)((j & 7) * D);
          const __m512i vctl = _mm512_load_si512(tmp);
          memset(tmp, 0, 64);
          for (uint32_t v = 0; v <= dmask; v++) tmp[v] = c2s[v];
          const __m512i vlut = _mm512_load_si512(tmp);
          const __m512i vmask = _mm512_set1_epi8((char)dmask);
          const uint8_t *pay_end = payload + plen;
          for (; t + 64 <= c; t += 64) {
            const uint8_t *src = rp + (((uint64_t)t * D) >> 3);
            if (src + 64 > pay_end) break;
            __m512i lanes = _mm512_permutexvar_epi8(
                vpidx, _mm512_loadu_si512(src));
            __m512i fields = _mm512_and_si512(
                _mm512_multishift_epi64_epi8(vctl, lanes), vmask);
            _mm512_storeu_si512(bd + o + t,
                                _mm512_permutexvar_epi8(fields, vlut));
          }
          bitpos = (uint64_t)t * D;
        }
#endif
        // 64-bit bit-buffer fast path: one load+shift per symbol while a
        // full 8-byte window fits inside the run
        for (; t < c && (bitpos >> 3) + 8 <= nbytes; t++) {
          uint64_t wbits;
          memcpy(&wbits, rp + (bitpos >> 3), 8);
          bd[o + t] = c2s[(wbits >> (bitpos & 7)) & dmask];
          bitpos += D;
        }
        for (; t < c; t++) {  // bit-exact tail
          uint32_t path = 0;
          for (int j = 0; j < D; j++) {
            path |= ((rp[bitpos >> 3] >> (bitpos & 7)) & 1u) << j;
            bitpos++;
          }
          bd[o + t] = c2s[path];
        }
      } else {
        int ch0 = child[nid][0], ch1 = child[nid][1];
        const uint8_t *rp = run_ptr[nid];
        int64_t l = (ch0 >= 0) ? seq_off[ch0] : 0;
        int64_t r = (ch1 >= 0) ? seq_off[ch1] : 0;
        int64_t t = 0;
#ifdef ZXCH_HAVE_VBMI2
        // 64 selector bits per step: expand-load the exact number of
        // child bytes each side contributes (masked loads suppress
        // faults, so no over-read past the child sequences)
        for (; t + 64 <= c; t += 64) {
          uint64_t m;
          memcpy(&m, rp + (t >> 3), 8);
          uint64_t nr = (uint64_t)__builtin_popcountll(m);
          __m512i rv = _mm512_maskz_expand_epi8(
              m, _mm512_maskz_loadu_epi8(_bzhi_u64(~0ull, nr), bc + r));
          __m512i lv = _mm512_maskz_expand_epi8(
              ~m, _mm512_maskz_loadu_epi8(_bzhi_u64(~0ull, 64 - nr), bc + l));
          _mm512_storeu_si512(bd + o + t, _mm512_or_si512(rv, lv));
          r += (int64_t)nr;
          l += (int64_t)(64 - nr);
        }
#endif
        for (; t < c; t++) {
          int bit = (rp[t >> 3] >> (t & 7)) & 1;
          bd[o + t] = bit ? bc[r++] : bc[l++];
        }
      }
    }
  }
  // result parity: level 0 writes into bufs[0] == out
  if (!user_scratch) delete[] scratch;
  return 0;
}

int zxch_pivco_decode(const uint8_t *payload, uint64_t plen,
                      const uint8_t *code_len, uint64_t n, uint8_t *out) {
  return zxch_pivco_decode_s(payload, plen, code_len, n, out, nullptr);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GHI block encode (levels 1-2): find+parse+emit fully native
// ---------------------------------------------------------------------------

extern "C" {

// Emits a complete GHI payload (GNR header + literals + sequence words +
// extras) for data[start..n) into out. Byte-identical to the Python
// emitter (block_encode.encode_block_ghi). Returns payload size or -10
// when cap is too small.
// per-thread parse scratch: fresh new[] per block costs more in
// first-touch page faults than it saves (same finding as resolve_pieces)
static thread_local int32_t *g_mp = nullptr, *g_ml = nullptr,
    *g_mo = nullptr;
static thread_local uint64_t g_mcap = 0;

static void zxch_parse_scratch(uint64_t max_seq) {
  if (max_seq > g_mcap) {
    delete[] g_mp; delete[] g_ml; delete[] g_mo;
    g_mcap = max_seq * 2;
    g_mp = new int32_t[g_mcap];
    g_ml = new int32_t[g_mcap];
    g_mo = new int32_t[g_mcap];
  }
}

// exact GHI payload size for a finished parse (the GHI emit is raw
// literals + fixed-width sequence words, so size needs no emission)
static uint64_t zxch_ghi_size(const int32_t *mp, const int32_t *ml,
                              int64_t nseq, uint64_t P,
                              uint64_t *lit_total_out,
                              uint64_t *n_ext_out) {
  uint64_t lit_total = P;
  uint64_t n_ext_bytes = 0;
  for (int64_t i = 0; i < nseq; i++) {
    lit_total -= (uint64_t)ml[i];
    int64_t prev_end = i ? (int64_t)mp[i - 1] + ml[i - 1] : 0;
    int64_t llv = mp[i] - prev_end;
    int64_t mlb = ml[i] - 5;
    if (llv >= 255) {
      int64_t v = llv - 255;
      n_ext_bytes += v < 0x80 ? 1 : (v < 0x4000 ? 2 : 3);
    }
    if (mlb >= 255) {
      int64_t v = mlb - 255;
      n_ext_bytes += v < 0x80 ? 1 : (v < 0x4000 ? 2 : 3);
    }
  }
  *lit_total_out = lit_total;
  *n_ext_out = n_ext_bytes;
  return 16 + 3 * 8 + lit_total + 4 * (uint64_t)nseq + n_ext_bytes;
}

// emit a parsed GHI block (size precomputed by zxch_ghi_size)
static int64_t zxch_emit_ghi(const uint8_t *data, uint64_t start,
                             uint64_t P, const int32_t *mp,
                             const int32_t *ml, const int32_t *mo,
                             int64_t nseq, uint64_t lit_total,
                             uint64_t n_ext_bytes, uint8_t *out) {
  uint64_t need = 16 + 3 * 8 + lit_total + 4 * (uint64_t)nseq + n_ext_bytes;

  // GNR header (write_gnr_header layout): n_seq, n_lit u32; enc bytes; pad
  uint8_t *w = out;
  uint32_t u;
  u = (uint32_t)nseq; memcpy(w, &u, 4);
  u = (uint32_t)lit_total; memcpy(w + 4, &u, 4);
  w[8] = 0; w[9] = 0; w[10] = 0; w[11] = 0;  // enc_lit/litlen/mlen/off RAW
  memset(w + 12, 0, 4);
  w += 16;
  // section descriptors (comp | raw<<32)
  uint64_t d;
  d = lit_total | ((uint64_t)lit_total << 32); memcpy(w, &d, 8);
  d = (4 * (uint64_t)nseq) | ((4 * (uint64_t)nseq) << 32); memcpy(w + 8, &d, 8);
  d = n_ext_bytes | (n_ext_bytes << 32); memcpy(w + 16, &d, 8);
  w += 24;

  // literal section: gaps between matches + trailing. Gaps average a
  // few bytes (L1 ~5 B), where glibc memcpy's size dispatch dominates:
  // emit wild 32 B chunks whenever the source still has >= 32 readable
  // bytes in the block AND the overshoot stays inside this payload's
  // own `need` region (it lands in the not-yet-written sequence-word /
  // extras area); exact memcpy covers both tails.
  const uint8_t *gsrc_end = data + start + P;
  uint8_t *pay_end = out + need;
  uint8_t *lit_w = w;
  {
    int64_t cursor = 0;
    for (int64_t i = 0; i < nseq; i++) {
      int64_t llv = mp[i] - cursor;
      const uint8_t *s = data + start + cursor;
      if (s + llv + 32 <= gsrc_end && lit_w + llv + 32 <= pay_end) {
        for (int64_t k = 0; k < llv; k += 32) memcpy(lit_w + k, s + k, 32);
        lit_w += llv;
      } else {
        memcpy(lit_w, s, llv);
        lit_w += llv;
      }
      cursor = mp[i] + ml[i];
    }
    memcpy(lit_w, data + start + cursor, (int64_t)P - cursor);
    lit_w += (int64_t)P - cursor;
  }
  w = lit_w;

  // sequence words LL(8)|ML(8)|off16 and extras
  uint8_t *ext_w = w + 4 * nseq;
  int64_t cursor = 0;
  for (int64_t i = 0; i < nseq; i++) {
    int64_t llv = mp[i] - cursor;
    int64_t mlb = ml[i] - 5;
    cursor = mp[i] + ml[i];
    uint32_t wl = llv < 255 ? (uint32_t)llv : 255u;
    uint32_t wm = mlb < 255 ? (uint32_t)mlb : 255u;
    uint32_t word = (wl << 24) | (wm << 16) | (uint32_t)(mo[i] - 1);
    memcpy(w + 4 * i, &word, 4);
    if (llv >= 255) {
      int64_t v = llv - 255;
      if (v < 0x80) { *ext_w++ = (uint8_t)v; }
      else if (v < 0x4000) { *ext_w++ = (uint8_t)(0x80 | (v & 0x3F));
                             *ext_w++ = (uint8_t)((v >> 6) & 0xFF); }
      else { *ext_w++ = (uint8_t)(0xC0 | (v & 0x1F));
             *ext_w++ = (uint8_t)((v >> 5) & 0xFF);
             *ext_w++ = (uint8_t)((v >> 13) & 0xFF); }
    }
    if (mlb >= 255) {
      int64_t v = mlb - 255;
      if (v < 0x80) { *ext_w++ = (uint8_t)v; }
      else if (v < 0x4000) { *ext_w++ = (uint8_t)(0x80 | (v & 0x3F));
                             *ext_w++ = (uint8_t)((v >> 6) & 0xFF); }
      else { *ext_w++ = (uint8_t)(0xC0 | (v & 0x1F));
             *ext_w++ = (uint8_t)((v >> 5) & 0xFF);
             *ext_w++ = (uint8_t)((v >> 13) & 0xFF); }
    }
  }
  return (int64_t)need;
}

int64_t zxch_encode_ghi(const uint8_t *data, uint64_t n, uint64_t start,
                        int max_probes, int lazy, int sufficient_len,
                        int step_base, int step_shift, int cover_base,
                        int min_emit, uint8_t *out, uint64_t cap) {
  uint64_t P = n - start;
  uint64_t max_seq = P / 5 + 8;
  zxch_parse_scratch(max_seq);
  int32_t *mp = g_mp, *ml = g_ml, *mo = g_mo;
  int64_t nseq = zxch_find_parse(data, n, start, max_probes, lazy,
                                 sufficient_len, step_base, step_shift,
                                 cover_base, min_emit, mp, ml, mo, max_seq);
  if (nseq < 0) return -10;
  uint64_t lit_total, n_ext_bytes;
  uint64_t need = zxch_ghi_size(mp, ml, nseq, P, &lit_total, &n_ext_bytes);
  if (need > cap) return -10;
  return zxch_emit_ghi(data, start, P, mp, ml, mo, nseq, lit_total,
                       n_ext_bytes, out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GLO block encode (levels 3-5): find+parse+emit fully native
// ---------------------------------------------------------------------------

extern "C" {

// RLE-encode lit[0..n) into out (cap-checked). Tokens: raw copies
// (tok+1 bytes, tok < 0x80) and runs (0x80|len-4, fill byte), runs of
// >= 4. Mirrors block_encode.encode_rle_literals byte-for-byte.
static int64_t ghi_rle_encode(const uint8_t *lit, uint64_t n, uint8_t *out,
                              uint64_t cap) {
  // byte-identical to block_encode.encode_rle_literals: runs >= 4 chunk at
  // 131 with a raw tail; raw gaps up to the next >=4 run chunk at 128
  if (n == 0) return 0;
  uint32_t *run = new uint32_t[n];
  run[n - 1] = 1;
  for (int64_t i = (int64_t)n - 2; i >= 0; i--)
    run[i] = lit[i] == lit[i + 1] ? run[i + 1] + 1 : 1;
  uint64_t p = 0, w = 0;
  while (p < n) {
    uint32_t r = run[p];
    if (r >= 4) {
      uint8_t b = lit[p];
      uint32_t rem = r;
      while (rem >= 4) {
        uint32_t chunk = rem < 131 ? rem : 131;
        if (w + 2 > cap) { delete[] run; return -1; }
        out[w++] = (uint8_t)(0x80 | (chunk - 4));
        out[w++] = b;
        rem -= chunk;
      }
      if (rem) {
        if (w + 1 + rem > cap) { delete[] run; return -1; }
        out[w++] = (uint8_t)(rem - 1);
        memset(out + w, b, rem);
        w += rem;
      }
      p += r;
    } else {
      uint64_t q = p;
      while (q < n && run[q] < 4) q++;
      while (p < q) {
        uint64_t chunk = (q - p) < 128 ? (q - p) : 128;
        if (w + 1 + chunk > cap) { delete[] run; return -1; }
        out[w++] = (uint8_t)(chunk - 1);
        memcpy(out + w, lit + p, chunk);
        w += chunk;
        p += chunk;
      }
    }
  }
  delete[] run;
  return (int64_t)w;
}

// Emits a complete GLO payload for data[start..n). Matches the Python
// emitter for levels < 6 (RAW/RLE literal candidates only; Huffman
// pricing starts at level 6 and stays on the Python path).
// prem_rle = 8 below level 6. Returns payload size or -10.
// Interleaved byte histogram: repeated bytes serialize a single-table
// histogram on the store-to-load forwarding of freq[b]; eight partial
// tables break the dependence, and two u64 loads per iteration replace
// sixteen byte loads (~1.3x over the 4-way byte-load form, ~4x over a
// single table on text-like data). Exact counts.
// BOUND: the uint32 partial counters rely on n < 8 * 2^32. The format
// caps blocks at 2 MiB (header codes 12..21, constants.py BLOCK_SIZES),
// so per-lane counts stay far below overflow; a future format bump past
// 32 GiB per block would need uint64 lanes again.
static void zxch_hist4(const uint8_t *data, uint64_t n, uint64_t freq[256]) {
  static_assert(2 * 1024 * 1024 / 8 < 0xFFFFFFFFull,
                "hist u32 lanes sized for the 2 MiB max block");
  static thread_local uint32_t f8[8][256];
  if (n >= (8ull << 32)) {  // defensive: never reachable through the format
    memset(freq, 0, 256 * sizeof(uint64_t));
    for (uint64_t i = 0; i < n; i++) freq[data[i]]++;
    return;
  }
  memset(f8, 0, sizeof(f8));
  uint64_t i = 0;
  for (; i + 16 <= n; i += 16) {
    uint64_t a, b;
    memcpy(&a, data + i, 8);
    memcpy(&b, data + i + 8, 8);
    f8[0][a & 0xFF]++;         f8[1][(a >> 8) & 0xFF]++;
    f8[2][(a >> 16) & 0xFF]++; f8[3][(a >> 24) & 0xFF]++;
    f8[4][(a >> 32) & 0xFF]++; f8[5][(a >> 40) & 0xFF]++;
    f8[6][(a >> 48) & 0xFF]++; f8[7][a >> 56]++;
    f8[0][b & 0xFF]++;         f8[1][(b >> 8) & 0xFF]++;
    f8[2][(b >> 16) & 0xFF]++; f8[3][(b >> 24) & 0xFF]++;
    f8[4][(b >> 32) & 0xFF]++; f8[5][(b >> 40) & 0xFF]++;
    f8[6][(b >> 48) & 0xFF]++; f8[7][b >> 56]++;
  }
  for (; i < n; i++) f8[0][data[i]]++;
  for (int s = 0; s < 256; s++) {
    uint64_t t = 0;
    for (int k = 0; k < 8; k++) t += f8[k][s];
    freq[s] = t;
  }
}

// Exported RLE literal emitter (Python fast path for the L6/L7 GLO
// section pricing, which runs outside zxch_encode_glo).
int64_t zxch_rle_encode_lit(const uint8_t *lit, uint64_t n, uint8_t *out,
                            uint64_t cap) {
  return ghi_rle_encode(lit, n, out, cap);
}

// defined later in this file (entropy-candidate pricing needs them)
static int zxch_build_code_lengths(const uint64_t *freq, int max_len,
                                   uint8_t *cl);
extern "C" int64_t zxch_pivco_encode(const uint8_t *data, uint64_t n,
                                     const uint8_t *code_len, uint8_t *out,
                                     uint64_t cap);
extern "C" int64_t zxch_pivco_size(const uint8_t *data, uint64_t n,
                                   const uint8_t *code_len);
extern "C" int64_t zxch_pivco_encode_f(const uint8_t *data, uint64_t n,
                                       const uint8_t *code_len,
                                       const uint64_t *freq, uint8_t *out,
                                       uint64_t cap);
extern "C" int64_t zxch_pivco_size_f(const uint8_t *data, uint64_t n,
                                     const uint8_t *code_len,
                                     const uint64_t *freq);

// GLO payload emission from a finished parse. Shared by the fast-level
// encoder (find_parse feeds it; premiums 8/8, 8-bit lit trees, RAW
// tokens — byte-identical with the pre-refactor emitter) and the
// archival levels 6-7 (premiums 1/4 per block_encode._prem_*, lit trees
// capped at the level's max code length, and — at ULTRA — a Huffman
// token-section candidate, reference zxc_compress.c:1665-1688).
static int64_t glo_emit(const uint8_t *data, uint64_t start, uint64_t P,
                        const int32_t *mp, const int32_t *ml,
                        const int32_t *mo, int64_t nseq,
                        const uint8_t *dict_cl, int prem_rle, int prem_huf,
                        int lit_cap_len, int tok_huf_cap, uint8_t *out,
                        uint64_t cap) {
  uint64_t lit_total = P;
  uint64_t n_ext_bytes = 0;
  int64_t max_off = 1;
  for (int64_t i = 0; i < nseq; i++) {
    lit_total -= (uint64_t)ml[i];
    int64_t prev_end = i ? (int64_t)mp[i - 1] + ml[i - 1] : 0;
    int64_t llv = mp[i] - prev_end;
    int64_t mlb = ml[i] - 5;
    if (llv >= 15) {
      int64_t v = llv - 15;
      n_ext_bytes += v < 0x80 ? 1 : (v < 0x4000 ? 2 : 3);
    }
    if (mlb >= 15) {
      int64_t v = mlb - 15;
      n_ext_bytes += v < 0x80 ? 1 : (v < 0x4000 ? 2 : 3);
    }
    if (mo[i] > max_off) max_off = mo[i];
  }
  int use8 = (nseq == 0) || (max_off <= 256);
  uint64_t off_bytes = (use8 ? 1 : 2) * (uint64_t)nseq;

  // literal section: gather gaps, then price RAW vs RLE. The buffer
  // carries +32 slack so gaps copy in wild 32 B chunks whenever the
  // SOURCE still has 32 readable bytes in the block (intermediate
  // overshoot is overwritten by the next gap; the final one lands in
  // the slack) — small-gap glibc memcpy dispatch was the emit's cost
  // (same treatment as zxch_emit_ghi, +18% L1 interleaved).
  uint8_t *lit_buf = new uint8_t[(lit_total ? lit_total : 1) + 32];
  {
    const uint8_t *gsrc_end = data + start + P;
    uint64_t lw = 0;
    int64_t cursor = 0;
    for (int64_t i = 0; i < nseq; i++) {
      int64_t llv = mp[i] - cursor;
      const uint8_t *s = data + start + cursor;
      if (s + llv + 32 <= gsrc_end) {
        for (int64_t k = 0; k < llv; k += 32)
          memcpy(lit_buf + lw + k, s + k, 32);
      } else {
        memcpy(lit_buf + lw, s, llv);
      }
      lw += llv;
      cursor = mp[i] + ml[i];
    }
    memcpy(lit_buf + lw, data + start + cursor, (int64_t)P - cursor);
  }
  uint8_t *rle_buf = nullptr;
  int64_t rle_len = -1;
  int enc_lit = 0;
  uint64_t lit_sec = lit_total;
  int64_t best_j = (int64_t)lit_total;
  if (lit_total > 0) {
    rle_buf = new uint8_t[2 * lit_total + 8];
    rle_len = ghi_rle_encode(lit_buf, lit_total, rle_buf, 2 * lit_total + 8);
    if (rle_len >= 0) {
      int64_t j = rle_len + (int64_t)((lit_total * (uint64_t)prem_rle) >> 8);
      if (j < best_j) {
        enc_lit = 1;
        lit_sec = (uint64_t)rle_len;
        best_j = j;
      }
    }
  }
  // entropy literal candidates, priced j = size + tax (mirrors the
  // Python auction in block_encode._glo_payload: inline Huffman with
  // its 128-byte lengths header at n_lit >= 139, then the shared
  // dictionary table (header-free; wins on small frames) at any size).
  // Candidates are priced by zxch_pivco_size (exact — the payload size
  // is fully determined after the histogram pass); only the winning
  // section pays the per-byte bit-packing pass. Same winners, same
  // bytes as encode-everything.
  uint8_t *huf_buf = nullptr;
  uint8_t inline_cl[256];
  if (lit_total > 0 && (lit_total >= 139 || dict_cl)) {
    uint64_t freq[256];
    zxch_hist4(lit_buf, lit_total, freq);
    if (lit_total >= 139) {
      if (zxch_build_code_lengths(freq, lit_cap_len, inline_cl) > 1) {
        uint64_t bits = 0;
        for (int s2 = 0; s2 < 256; s2++) bits += freq[s2] * inline_cl[s2];
        // sound skip: per-node byte rounding only adds to bits/8
        int64_t bound = 128 + (int64_t)(bits >> 3)
                        + (int64_t)((lit_total * (uint64_t)prem_huf) >> 8);
        if (bound < best_j) {
          int64_t hn = zxch_pivco_size_f(lit_buf, lit_total, inline_cl, freq);
          int64_t j = hn >= 0
              ? 128 + hn + (int64_t)((lit_total * (uint64_t)prem_huf) >> 8)
              : best_j;
          if (hn >= 0 && j < best_j) {
            enc_lit = 2;
            lit_sec = (uint64_t)(128 + hn);
            best_j = j;
          }
        }
      }
    }
    if (dict_cl) {
      int all = 1;
      for (int s2 = 0; s2 < 256; s2++)
        if (freq[s2] && !dict_cl[s2]) { all = 0; break; }
      if (all) {
        int64_t hn = zxch_pivco_size_f(lit_buf, lit_total, dict_cl, freq);
        int64_t j = hn >= 0
            ? hn + (int64_t)((lit_total * (uint64_t)prem_huf) >> 8) : best_j;
        if (hn >= 0 && j < best_j) {
          enc_lit = 3;
          lit_sec = (uint64_t)hn;
          best_j = j;
        }
      }
    }
    if (enc_lit == 2) {
      huf_buf = new uint8_t[2 * lit_total + 4096 + 128];
      int64_t hn = zxch_pivco_encode_f(lit_buf, lit_total, inline_cl,
                                       freq, huf_buf + 128,
                                       2 * lit_total + 4096);
      if (hn < 0 || (uint64_t)(128 + hn) != lit_sec) {  // can't happen
        delete[] huf_buf; delete[] lit_buf; delete[] rle_buf;
        return -10;
      }
      for (int b2 = 0; b2 < 128; b2++)
        huf_buf[b2] = (uint8_t)((inline_cl[2 * b2] & 0x0F) |
                                (inline_cl[2 * b2 + 1] << 4));
    } else if (enc_lit == 3) {
      huf_buf = new uint8_t[2 * lit_total + 4096];
      int64_t hn = zxch_pivco_encode_f(lit_buf, lit_total, dict_cl, freq,
                                       huf_buf, 2 * lit_total + 4096);
      if (hn < 0 || (uint64_t)hn != lit_sec) {  // can't happen
        delete[] huf_buf; delete[] lit_buf; delete[] rle_buf;
        return -10;
      }
    }
  }

  // token section candidate (ULTRA): Huffman over token bytes, gated by
  // the same premium rule as the Python auction (_glo_payload)
  int enc_tok = 0;
  uint64_t tok_sec = (uint64_t)nseq;
  uint8_t *tokh_buf = nullptr;
  if (tok_huf_cap > 0 && nseq >= 139) {
    uint8_t *tok_tmp = new uint8_t[nseq];
    int64_t cursor = 0;
    for (int64_t i = 0; i < nseq; i++) {
      int64_t llv = mp[i] - cursor;
      int64_t mlb = ml[i] - 5;
      cursor = mp[i] + ml[i];
      uint32_t tl = llv < 15 ? (uint32_t)llv : 15u;
      uint32_t tm = mlb < 15 ? (uint32_t)mlb : 15u;
      tok_tmp[i] = (uint8_t)((tl << 4) | tm);
    }
    uint64_t tfreq[256];
    zxch_hist4(tok_tmp, (uint64_t)nseq, tfreq);
    uint8_t tcl[256];
    if (zxch_build_code_lengths(tfreq, tok_huf_cap, tcl) > 1) {
      int64_t tn = zxch_pivco_size_f(tok_tmp, (uint64_t)nseq, tcl, tfreq);
      if (tn >= 0 && 128 + tn + (int64_t)(((uint64_t)nseq
                                           * (uint64_t)prem_huf) >> 8)
                         < nseq) {
        tokh_buf = new uint8_t[2 * (uint64_t)nseq + 4096 + 128];
        int64_t hn = zxch_pivco_encode_f(tok_tmp, (uint64_t)nseq, tcl,
                                         tfreq, tokh_buf + 128,
                                         2 * (uint64_t)nseq + 4096);
        if (hn == tn) {
          for (int b2 = 0; b2 < 128; b2++)
            tokh_buf[b2] = (uint8_t)((tcl[2 * b2] & 0x0F)
                                     | (tcl[2 * b2 + 1] << 4));
          enc_tok = 2;
          tok_sec = (uint64_t)(128 + tn);
        } else {
          delete[] tokh_buf;
          tokh_buf = nullptr;
        }
      }
    }
    delete[] tok_tmp;
  }

  uint64_t need = 16 + 4 * 8 + lit_sec + tok_sec + off_bytes +
                  n_ext_bytes;
  if (need > cap) {
    delete[] lit_buf; delete[] rle_buf; delete[] huf_buf;
    delete[] tokh_buf;
    return -10;
  }

  uint8_t *w = out;
  uint32_t u;
  u = (uint32_t)nseq; memcpy(w, &u, 4);
  u = (uint32_t)lit_total; memcpy(w + 4, &u, 4);
  w[8] = (uint8_t)enc_lit;  // enc_lit RAW/RLE
  w[9] = (uint8_t)enc_tok;  // enc_litlen RAW/HUFFMAN
  w[10] = 0;
  w[11] = use8 ? 1 : 0;     // enc_off
  memset(w + 12, 0, 4);
  w += 16;
  uint64_t d;
  d = lit_sec | ((uint64_t)lit_total << 32); memcpy(w, &d, 8);
  d = tok_sec | ((uint64_t)nseq << 32); memcpy(w + 8, &d, 8);
  d = off_bytes | (off_bytes << 32); memcpy(w + 16, &d, 8);
  d = n_ext_bytes | (n_ext_bytes << 32); memcpy(w + 24, &d, 8);
  w += 32;

  if (enc_lit >= 2) { memcpy(w, huf_buf, lit_sec); }
  else if (enc_lit == 1) { memcpy(w, rle_buf, lit_sec); }
  else { memcpy(w, lit_buf, lit_sec); }
  w += lit_sec;

  uint8_t *tok_w = w;
  if (enc_tok == 2) memcpy(tok_w, tokh_buf, tok_sec);
  uint8_t *off_w = w + tok_sec;
  uint8_t *ext_w = off_w + off_bytes;
  int64_t cursor = 0;
  for (int64_t i = 0; i < nseq; i++) {
    int64_t llv = mp[i] - cursor;
    int64_t mlb = ml[i] - 5;
    cursor = mp[i] + ml[i];
    if (enc_tok == 0) {
      uint32_t tl = llv < 15 ? (uint32_t)llv : 15u;
      uint32_t tm = mlb < 15 ? (uint32_t)mlb : 15u;
      tok_w[i] = (uint8_t)((tl << 4) | tm);
    }
    uint32_t ob = (uint32_t)(mo[i] - 1);
    if (use8) off_w[i] = (uint8_t)ob;
    else { off_w[2 * i] = (uint8_t)(ob & 0xFF); off_w[2 * i + 1] = (uint8_t)(ob >> 8); }
    if (llv >= 15) {
      int64_t v = llv - 15;
      if (v < 0x80) *ext_w++ = (uint8_t)v;
      else if (v < 0x4000) { *ext_w++ = (uint8_t)(0x80 | (v & 0x3F));
                             *ext_w++ = (uint8_t)((v >> 6) & 0xFF); }
      else { *ext_w++ = (uint8_t)(0xC0 | (v & 0x1F));
             *ext_w++ = (uint8_t)((v >> 5) & 0xFF);
             *ext_w++ = (uint8_t)((v >> 13) & 0xFF); }
    }
    if (mlb >= 15) {
      int64_t v = mlb - 15;
      if (v < 0x80) *ext_w++ = (uint8_t)v;
      else if (v < 0x4000) { *ext_w++ = (uint8_t)(0x80 | (v & 0x3F));
                             *ext_w++ = (uint8_t)((v >> 6) & 0xFF); }
      else { *ext_w++ = (uint8_t)(0xC0 | (v & 0x1F));
             *ext_w++ = (uint8_t)((v >> 5) & 0xFF);
             *ext_w++ = (uint8_t)((v >> 13) & 0xFF); }
    }
  }
  delete[] lit_buf; delete[] rle_buf;
  delete[] huf_buf; delete[] tokh_buf;
  return (int64_t)need;
}

int64_t zxch_encode_glo(const uint8_t *data, uint64_t n, uint64_t start,
                        int max_probes, int lazy, int sufficient_len,
                        int step_base, int step_shift, int cover_base,
                        int min_emit, const uint8_t *dict_cl, uint8_t *out,
                        uint64_t cap) {
  uint64_t P = n - start;
  uint64_t max_seq = P / 5 + 8;
  int32_t *mp = new int32_t[max_seq];
  int32_t *ml = new int32_t[max_seq];
  int32_t *mo = new int32_t[max_seq];
  int64_t nseq = zxch_find_parse(data, n, start, max_probes, lazy,
                                 sufficient_len, step_base, step_shift,
                                 cover_base, min_emit, mp, ml, mo, max_seq);
  int64_t r = nseq < 0 ? -10
      : glo_emit(data, start, P, mp, ml, mo, nseq, dict_cl,
                 /*prem_rle=*/8, /*prem_huf=*/8, /*lit_cap_len=*/8,
                 /*tok_huf_cap=*/0, out, cap);
  delete[] mp; delete[] ml; delete[] mo;
  return r;
}

// Archival GLO encode (levels 6-7): per-position finder -> lazy pre-pass
// literal histogram -> DP optimal parse (+ the ULTRA re-priced and
// 8-bit-only candidate parses) -> premium-priced section auction with
// Huffman literal/token candidates. Mirrors the Python path
// (block_encode._build_sequences levels >= 6 + _glo_payload) step for
// step so the archives are byte-identical; the behavior contract is the
// reference's optimal pipeline (zxc_lz77_optimal_parse_glo,
// zxc_compress.c:809-1072 + level-7 token Huffman :1665-1688).
int64_t zxch_encode_glo_opt(const uint8_t *data, uint64_t n, uint64_t start,
                            int level, int max_probes,
                            const uint8_t *dict_cl, uint8_t *out,
                            uint64_t cap) {
  const int maxlen = level >= 7 ? 11 : 8;
  const int tok_bits = level >= 7 ? 5 : 8;
  uint64_t P = n - start;
  if (P == 0) return -10;
  int32_t *lens = new int32_t[P];
  int32_t *offs = new int32_t[P];
  zxch_find_matches(data, n, start, max_probes, lens, offs);

  uint64_t max_seq = P / 5 + 8;
  int32_t *mp = new int32_t[max_seq];
  int32_t *ml = new int32_t[max_seq];
  int32_t *mo = new int32_t[max_seq];
  auto cleanup = [&]() {
    delete[] lens; delete[] offs; delete[] mp; delete[] ml; delete[] mo;
  };

  // literal-cost model: POST-LZ literal histogram of a first-pass lazy
  // parse (the reference samples instead, zxc_opt_estimate_lit_bits)
  uint16_t cost[256];
  {
    int64_t g = zxch_lazy_parse(lens, offs, P, 1, 5, mp, ml, mo, max_seq);
    if (g < 0) { cleanup(); return -10; }
    uint64_t freq[256];
    memset(freq, 0, sizeof(freq));
    int64_t cursor = 0;
    for (int64_t i = 0; i < g; i++) {
      for (int64_t q = cursor; q < mp[i]; q++) freq[data[start + q]]++;
      cursor = mp[i] + ml[i];
    }
    for (int64_t q = cursor; q < (int64_t)P; q++) freq[data[start + q]]++;
    uint8_t cl[256];
    if (zxch_build_code_lengths(freq, maxlen, cl) > 0) {
      // regime check (mirrors block_encode.py): when the Huffman
      // estimate (+ the 128-byte lengths table) loses to RAW on the
      // first-pass histogram, the final auction will emit RAW literals
      // — price them flat 8 so the DP values matches against what they
      // actually displace (high-entropy/machine-code blocks were
      // under-matching: L6 ELF gate +0.03..0.10% vs reference)
      uint64_t tot = 0, hb = 0;
      for (int s2 = 0; s2 < 256; s2++) {
        tot += freq[s2];
        hb += freq[s2] * cl[s2];
      }
      if (hb + 128 * 8 >= tot * 8) {
        for (int s2 = 0; s2 < 256; s2++) cost[s2] = 8;
      } else {
        for (int s2 = 0; s2 < 256; s2++)
          cost[s2] = cl[s2] ? cl[s2] : (uint16_t)(maxlen + 2);
      }
    } else {
      for (int s2 = 0; s2 < 256; s2++) cost[s2] = 8;
    }
  }

  // candidate parses: pass 1, (ULTRA) re-priced pass 2, 8-bit-only
  struct Cand { int32_t *p, *l, *o; int64_t n; };
  Cand cands[3];
  int n_cands = 0;
  int64_t n1 = zxch_optimal_parse(lens, offs, P, data + start, cost,
                                  tok_bits, 0, nullptr, mp, ml, mo, max_seq);
  if (n1 < 0) { cleanup(); return -10; }
  cands[n_cands++] = {mp, ml, mo, n1};

  int32_t *mp2 = nullptr, *ml2 = nullptr, *mo2 = nullptr;
  if (level >= 7 && n1 >= 64) {
    // re-price match tokens with the ACTUAL candidate token tree,
    // marginalized over the LL nibble (block_encode.py:461-497)
    uint64_t tfreq[256];
    memset(tfreq, 0, sizeof(tfreq));
    double pll[16] = {0};
    int64_t cursor = 0;
    for (int64_t i = 0; i < n1; i++) {
      int64_t llv = mp[i] - cursor;
      int64_t mlb = ml[i] - 5;
      cursor = mp[i] + ml[i];
      int nl = llv < 15 ? (int)llv : 15;
      int nm = mlb < 15 ? (int)mlb : 15;
      tfreq[(nl << 4) | nm]++;
      pll[nl] += 1.0;
    }
    uint8_t tcl[256];
    if (zxch_build_code_lengths(tfreq, 8, tcl) > 0) {
      double tot = 0;
      for (int l2 = 0; l2 < 16; l2++) tot += pll[l2];
      if (tot < 1.0) tot = 1.0;
      uint16_t tok16[16];
      for (int m2 = 0; m2 < 16; m2++) {
        double e = 0;
        for (int l2 = 0; l2 < 16; l2++)
          e += (pll[l2] / tot)
               * (tcl[(l2 << 4) | m2] ? tcl[(l2 << 4) | m2] : 10.0);
        tok16[m2] = (uint16_t)nearbyint(e);
      }
      mp2 = new int32_t[max_seq];
      ml2 = new int32_t[max_seq];
      mo2 = new int32_t[max_seq];
      int64_t n2 = zxch_optimal_parse(lens, offs, P, data + start, cost,
                                      tok_bits, 0, tok16, mp2, ml2, mo2,
                                      max_seq);
      int differs = n2 >= 0 && (n2 != n1
          || memcmp(mp2, mp, n1 * 4) || memcmp(ml2, ml, n1 * 4)
          || memcmp(mo2, mo, n1 * 4));
      if (differs) {
        cands[n_cands++] = {mp2, ml2, mo2, n2};
      }
    }
  }

  int any16 = 0;
  for (int c2 = 0; c2 < n_cands && !any16; c2++)
    for (int64_t i = 0; i < cands[c2].n; i++)
      if (cands[c2].o[i] > 256) { any16 = 1; break; }
  int32_t *mp8 = nullptr, *ml8 = nullptr, *mo8 = nullptr;
  if (any16) {
    mp8 = new int32_t[max_seq];
    ml8 = new int32_t[max_seq];
    mo8 = new int32_t[max_seq];
    int64_t n8 = zxch_optimal_parse(lens, offs, P, data + start, cost,
                                    tok_bits, 1, nullptr, mp8, ml8, mo8,
                                    max_seq);
    if (n8 >= 0) cands[n_cands++] = {mp8, ml8, mo8, n8};
  }

  // auction: smallest payload wins (first candidate keeps ties, matching
  // Python's min())
  const int tok_cap = level >= 7 ? maxlen : 0;
  int64_t best = -10;
  static thread_local std::vector<uint8_t> alt;
  for (int c2 = 0; c2 < n_cands; c2++) {
    if (c2 == 0) {
      best = glo_emit(data, start, P, cands[0].p, cands[0].l, cands[0].o,
                      cands[0].n, dict_cl, 1, 4, maxlen, tok_cap, out, cap);
      continue;
    }
    if (alt.size() < cap) alt.resize(cap);
    int64_t sz = glo_emit(data, start, P, cands[c2].p, cands[c2].l,
                          cands[c2].o, cands[c2].n, dict_cl, 1, 4, maxlen,
                          tok_cap, alt.data(), cap);
    if (sz >= 0 && (best < 0 || sz < best)) {
      memcpy(out, alt.data(), (size_t)sz);
      best = sz;
    }
  }
  cleanup();
  delete[] mp2; delete[] ml2; delete[] mo2;
  delete[] mp8; delete[] ml8; delete[] mo8;
  return best;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PivCo-Huffman payload ENCODE (mirror of codec/huffman.py encode_payload:
// canonical trie from code lengths, per-symbol item templates, two passes —
// count bits per node, then pack LSB-first byte-aligned runs in BFS order).
// Byte-exact with the Python emitter. Reference: zxc_huffman.c encode side.
// ---------------------------------------------------------------------------

extern "C" {

// emit=0: price only — returns the exact payload size without touching
// `out` (the auction's candidates cost a histogram pass instead of a
// full per-byte pack; only the winner pays pass 2).
// freq_in (optional): the caller's precomputed histogram of data[0..n).
// Every auction already histograms its section to build code lengths, so
// passing it here removes a redundant full-data pass from pass 1 (price
// becomes O(256); emit keeps only the unavoidable pack pass).
static int64_t zxch_pivco_core(const uint8_t *data, uint64_t n,
                               const uint8_t *code_len, uint8_t *out,
                               uint64_t cap, int emit,
                               const uint64_t *freq_in) {
  const int MAXLEN = 11;
  const int MAXNODES = 1024;
  static thread_local int16_t child[MAXNODES][2];
  static thread_local int16_t sym[MAXNODES];
  static thread_local int16_t bfs[MAXNODES];
  static thread_local uint8_t flat_d[MAXNODES];
  static thread_local uint8_t covered[MAXNODES];
  static thread_local int8_t mn[MAXNODES], mx[MAXNODES];
  static thread_local uint32_t codes[256];

  // canonical code assignment ordered by (len, symbol)
  int bl_count[MAXLEN + 2] = {0};
  int present = 0;
  for (int s = 0; s < 256; s++) {
    if (code_len[s]) { bl_count[code_len[s]]++; present++; }
  }
  if (!present) return -1;
  uint32_t next_code[MAXLEN + 2] = {0};
  {
    uint32_t code = 0;
    for (int l = 1; l <= MAXLEN; l++) {
      code = (code + (uint32_t)bl_count[l - 1]) << 1;
      next_code[l] = code;
    }
  }
  int n_nodes = 1;
  child[0][0] = child[0][1] = -1;
  sym[0] = -1;
  int max_depth = 0;
  for (int s = 0; s < 256; s++) {
    int l = code_len[s];
    if (!l) { codes[s] = 0; continue; }
    uint32_t c = next_code[l]++;
    if (c >> l) return -2;
    codes[s] = c;
    int cur = 0;
    for (int d = l - 1; d >= 0; d--) {
      if (sym[cur] >= 0) return -2;
      int bit = (int)((c >> d) & 1u);
      int nxt = child[cur][bit];
      if (nxt < 0) {
        if (n_nodes >= MAXNODES) return -2;
        nxt = n_nodes++;
        child[nxt][0] = child[nxt][1] = -1;
        sym[nxt] = -1;
        child[cur][bit] = (int16_t)nxt;
      }
      cur = nxt;
    }
    if (child[cur][0] >= 0 || child[cur][1] >= 0) return -2;
    sym[cur] = (int16_t)s;
    if (l > max_depth) max_depth = l;
  }

  // BFS order
  {
    int head = 0, tail = 0;
    bfs[tail++] = 0;
    while (head < tail) {
      int nid = bfs[head++];
      for (int b = 0; b < 2; b++)
        if (child[nid][b] >= 0) bfs[tail++] = child[nid][b];
    }
  }

  // flat-subtree detection (reverse BFS min/max leaf depth, then
  // maximality masking forward)
  for (int i = n_nodes - 1; i >= 0; i--) {
    int nid = bfs[i];
    if (sym[nid] >= 0) { mn[nid] = mx[nid] = 0; }
    else if (child[nid][0] >= 0 && child[nid][1] >= 0) {
      int8_t a0 = mn[child[nid][0]], a1 = mn[child[nid][1]];
      int8_t b0 = mx[child[nid][0]], b1 = mx[child[nid][1]];
      mn[nid] = (int8_t)(1 + (a0 < a1 ? a0 : a1));
      mx[nid] = (int8_t)(1 + (b0 > b1 ? b0 : b1));
    } else { mn[nid] = 0; mx[nid] = MAXLEN; }
  }
  for (int i = 0; i < n_nodes; i++) flat_d[i] = covered[i] = 0;
  for (int i = 0; i < n_nodes; i++) {
    int nid = bfs[i];
    if (!covered[nid] && sym[nid] < 0 && mn[nid] == mx[nid] && mn[nid] >= 2)
      flat_d[nid] = (uint8_t)mn[nid];
    uint8_t cov = covered[nid] || flat_d[nid] > 0;
    for (int b = 0; b < 2; b++)
      if (child[nid][b] >= 0) covered[child[nid][b]] = cov;
  }

  // per-symbol item templates: (node, nbits, value LSB-first)
  static thread_local int16_t it_node[256][MAXLEN];
  static thread_local uint8_t it_nbits[256][MAXLEN];
  static thread_local uint16_t it_val[256][MAXLEN];
  static thread_local uint8_t it_cnt[256];
  for (int s = 0; s < 256; s++) {
    it_cnt[s] = 0;
    int l = code_len[s];
    if (!l) continue;
    uint32_t c = codes[s];
    int cur = 0, d = 0;
    while (d < l) {
      int k = it_cnt[s]++;
      it_node[s][k] = (int16_t)cur;
      if (flat_d[cur]) {
        int D = flat_d[cur];
        uint16_t v = 0;
        for (int j = 0; j < D; j++)
          v |= (uint16_t)(((c >> (l - 1 - (d + j))) & 1u) << j);
        it_nbits[s][k] = (uint8_t)D;
        it_val[s][k] = v;
        for (int j = 0; j < D; j++)
          cur = child[cur][(c >> (l - 1 - d)) & 1u], d++;
      } else {
        it_nbits[s][k] = 1;
        it_val[s][k] = (uint16_t)((c >> (l - 1 - d)) & 1u);
        cur = child[cur][(c >> (l - 1 - d)) & 1u];
        d++;
      }
    }
  }

  // pass 1: bits per node = sum over symbols of freq * per-item bits —
  // a 256-entry loop over the histogram instead of a full data pass
  static thread_local uint64_t nbits_node[MAXNODES];
  for (int i = 0; i < n_nodes; i++) nbits_node[i] = 0;
  {
    uint64_t own_freq[256];
    const uint64_t *fr_tab = freq_in;
    if (!fr_tab) {
      zxch_hist4(data, n, own_freq);
      fr_tab = own_freq;
    }
    for (int sy = 0; sy < 256; sy++) {
      uint64_t fr = fr_tab[sy];
      if (!fr) continue;
      for (int k = 0; k < it_cnt[sy]; k++)
        nbits_node[it_node[sy][k]] += fr * it_nbits[sy][k];
    }
  }
  // byte offsets per node in BFS order (runs byte-aligned)
  static thread_local uint64_t byte_off[MAXNODES];
  uint64_t w = 0;
  for (int i = 0; i < n_nodes; i++) {
    int nid = bfs[i];
    if (covered[nid] || sym[nid] >= 0) continue;
    byte_off[nid] = w;
    w += (nbits_node[nid] + 7) / 8;
  }
  if (!emit) return (int64_t)w;  // price-only: exact size, no pass 2
  // +8: the packing loops flush with unaligned u64 stores whose tail
  // bytes carry only zero bits but must be addressable
  if (w + 8 > cap) return -10;

#if defined(ZXCH_HAVE_VBMI2) && defined(ZXCH_HAVE_VBMI)
  // ---- pass 2, vectorized (v2): level-order radix partition ----
  // The scalar item loop below pays ~20+ cycles per PATH STEP (register
  // -starved per-node accumulator RMWs through memory, a serial
  // store-to-load chain whenever consecutive bytes hit the same node —
  // the root sees every byte) and measured 42-49 MB/s on entropy-coded
  // 512 KiB sections. This path restructures the pack as a per-LEVEL
  // stable partition of the byte stream down the trie: at depth d every
  // live byte contributes bit d of its code, so one 256->bit LUT (two
  // vpermi2b + top-bit blend) turns 64 bytes into the next control mask,
  // vpmovb-to-mask IS the emitted bit run for the owning node, and two
  // vpcompressb split the segment into the child segments. Flat subtrees
  // (the common case under the 8-bit cap) terminate in one shot: a
  // 256->value LUT + _pext_u64 packs eight D-bit codes per iteration.
  // Bits, run layout, and byte offsets are identical to the scalar pass
  // (golden + conformance + the forced-scalar A/B test pin it); runs are
  // written as plain sequential u64 bursts in BFS==emission order, so
  // the full-output memset disappears too. ZXCH_PIVCO_SCALAR=1 forces
  // the scalar pass (A/B + differential testing).
  static const int force_scalar = getenv("ZXCH_PIVCO_SCALAR") != nullptr;
  if (!force_scalar && n >= 2048) {
    static thread_local std::vector<uint8_t> sbufa, sbufb, sside;
    if (sbufa.size() < n) {
      sbufa.resize(n);
      sbufb.resize(n);
      sside.resize(n);
    }
    struct Seg { int16_t nid; uint32_t lo; uint32_t len; };
    static thread_local std::vector<Seg> segs, nsegs;
    segs.clear();
    segs.push_back({0, 0, (uint32_t)n});
    const uint8_t *src = data;       // level 0 reads the caller's bytes
    uint8_t *wbuf = sbufa.data();    // partition target, ping-pong
    uint8_t *obuf = sbufb.data();
    uint8_t *side = sside.data();
    for (int d = 0; d < max_depth && !segs.empty(); d++) {
      alignas(64) uint8_t lutb[256];
      for (int s = 0; s < 256; s++) {
        int l = code_len[s];
        lutb[s] = (l > d) ? (uint8_t)((codes[s] >> (l - 1 - d)) & 1u) : 0;
      }
      const __m512i L0 = _mm512_load_si512(lutb);
      const __m512i L1 = _mm512_load_si512(lutb + 64);
      const __m512i L2 = _mm512_load_si512(lutb + 128);
      const __m512i L3 = _mm512_load_si512(lutb + 192);
      const __m512i ONE = _mm512_set1_epi8(1);
      nsegs.clear();
      uint64_t ncur = 0;
      for (size_t sgi = 0; sgi < segs.size(); sgi++) {
        const Seg sg = segs[sgi];
        const int nid = sg.nid;
        const uint8_t *sp = src + sg.lo;
        if (flat_d[nid]) {
          // flat subtree: emit packed D-bit values, segment terminates
          const int D = flat_d[nid];
          alignas(64) uint8_t lutv[256];
          for (int s = 0; s < 256; s++) {
            int l = code_len[s];
            uint8_t v = 0;
            if (l >= d + D)
              for (int j = 0; j < D; j++)
                v |= (uint8_t)(((codes[s] >> (l - 1 - (d + j))) & 1u)
                               << j);
            lutv[s] = v;
          }
          const __m512i V0 = _mm512_load_si512(lutv);
          const __m512i V1 = _mm512_load_si512(lutv + 64);
          const __m512i V2 = _mm512_load_si512(lutv + 128);
          const __m512i V3 = _mm512_load_si512(lutv + 192);
          uint8_t *ow = out + byte_off[nid];
          uint64_t acc = 0;
          unsigned cnt = 0;
          const uint64_t pmask =
              0x0101010101010101ull * (uint64_t)((1u << D) - 1);
          const unsigned nb8 = 8u * (unsigned)D;
          alignas(64) uint8_t vals[64];
          uint64_t i = 0;
          for (; i + 64 <= sg.len; i += 64) {
            __m512i x = _mm512_loadu_si512(sp + i);
            __m512i r01 = _mm512_permutex2var_epi8(V0, x, V1);
            __m512i r23 = _mm512_permutex2var_epi8(V2, x, V3);
            __mmask64 hi = _mm512_movepi8_mask(x);
            _mm512_store_si512(vals, _mm512_mask_blend_epi8(hi, r01, r23));
            for (int k = 0; k < 64; k += 8) {
              uint64_t v8;
              memcpy(&v8, vals + k, 8);
              uint64_t pk8 = _pext_u64(v8, pmask);
              acc |= pk8 << cnt;
              if (cnt + nb8 >= 64) {
                memcpy(ow, &acc, 8);
                ow += 8;
                acc = cnt ? (pk8 >> (64 - cnt)) : 0;
                cnt = cnt + nb8 - 64;
              } else {
                cnt += nb8;
              }
            }
          }
          for (; i < sg.len; i++) {
            uint64_t v = lutv[sp[i]];
            acc |= v << cnt;
            cnt += (unsigned)D;
            if (cnt >= 64) {
              memcpy(ow, &acc, 8);
              ow += 8;
              cnt -= 64;
              acc = cnt ? (v >> ((unsigned)D - cnt)) : 0;
            }
          }
          if (cnt) memcpy(ow, &acc, 8);
          continue;
        }
        // 1-bit node: vpmovb mask is both the emitted run and the split
        const int c0 = child[nid][0], c1 = child[nid][1];
        const int keep0 = c0 >= 0 && sym[c0] < 0;
        const int keep1 = c1 >= 0 && sym[c1] < 0;
        uint8_t *ow = out + byte_off[nid];
        uint64_t acc = 0;
        unsigned cnt = 0;
        uint8_t *w0 = wbuf + ncur;
        uint64_t n0 = 0, n1 = 0;
        for (uint64_t i = 0; i < sg.len; i += 64) {
          const uint64_t rem = sg.len - i;
          const __mmask64 lm =
              rem >= 64 ? ~0ull : ((1ull << rem) - 1);
          __m512i x = _mm512_maskz_loadu_epi8(lm, sp + i);
          __m512i r01 = _mm512_permutex2var_epi8(L0, x, L1);
          __m512i r23 = _mm512_permutex2var_epi8(L2, x, L3);
          __mmask64 hi = _mm512_movepi8_mask(x);
          __m512i b = _mm512_mask_blend_epi8(hi, r01, r23);
          const uint64_t mm =
              (uint64_t)_mm512_test_epi8_mask(b, ONE) & lm;
          const unsigned len = rem >= 64 ? 64u : (unsigned)rem;
          acc |= mm << cnt;
          if (cnt + len >= 64) {
            memcpy(ow, &acc, 8);
            ow += 8;
            acc = cnt ? (mm >> (64 - cnt)) : 0;
            cnt = cnt + len - 64;
          } else {
            cnt += len;
          }
          if (keep0) {
            const __mmask64 m0 = (__mmask64)(~mm & lm);
            _mm512_mask_compressstoreu_epi8(w0 + n0, m0, x);
            n0 += (uint64_t)_mm_popcnt_u64(~mm & lm);
          }
          if (keep1) {
            _mm512_mask_compressstoreu_epi8(side + n1, (__mmask64)mm, x);
            n1 += (uint64_t)_mm_popcnt_u64(mm);
          }
        }
        if (cnt) memcpy(ow, &acc, 8);
        if (keep0) {
          nsegs.push_back({(int16_t)c0, (uint32_t)ncur, (uint32_t)n0});
          ncur += n0;
        }
        if (keep1) {
          memcpy(wbuf + ncur, side, n1);
          nsegs.push_back({(int16_t)c1, (uint32_t)ncur, (uint32_t)n1});
          ncur += n1;
        }
      }
      segs.swap(nsegs);
      src = wbuf;
      uint8_t *t = wbuf;
      wbuf = obuf;
      obuf = t;
    }
    return (int64_t)w;
  }
#endif
  memset(out, 0, w + 8);

  // pass 2: pack bits (LSB-first within each node run) through per-node
  // u64 accumulators — one shift/or per item, a 32-bit flush every few
  // items, instead of 1-3 byte RMWs per item
  static thread_local uint64_t bitpos[MAXNODES];
  static thread_local uint64_t pend[MAXNODES];
  static thread_local uint8_t pcnt[MAXNODES];
  for (int i = 0; i < n_nodes; i++) { bitpos[i] = 0; pend[i] = 0;
                                      pcnt[i] = 0; }
  for (uint64_t i = 0; i < n; i++) {
    int sy = data[i];
    for (int k = 0; k < it_cnt[sy]; k++) {
      int nid = it_node[sy][k];
      pend[nid] |= (uint64_t)it_val[sy][k] << pcnt[nid];
      pcnt[nid] = (uint8_t)(pcnt[nid] + it_nbits[sy][k]);
      if (pcnt[nid] >= 32) {
        uint64_t base = byte_off[nid] * 8 + bitpos[nid];
        uint64_t chunk = (pend[nid] & 0xFFFFFFFFull) << (base & 7);
        uint64_t tmp;
        memcpy(&tmp, out + (base >> 3), 8);
        tmp |= chunk;
        memcpy(out + (base >> 3), &tmp, 8);
        bitpos[nid] += 32;
        pend[nid] >>= 32;
        pcnt[nid] = (uint8_t)(pcnt[nid] - 32);
      }
    }
  }
  // drain accumulators (bits land inside each node's ceil-byte run)
  for (int i = 0; i < n_nodes; i++) {
    if (!pcnt[i]) continue;
    uint64_t base = byte_off[i] * 8 + bitpos[i];
    uint64_t chunk = pend[i] << (base & 7);
    uint64_t tmp;
    memcpy(&tmp, out + (base >> 3), 8);
    tmp |= chunk;
    memcpy(out + (base >> 3), &tmp, 8);
  }
  return (int64_t)w;
}

int64_t zxch_pivco_encode(const uint8_t *data, uint64_t n,
                          const uint8_t *code_len, uint8_t *out,
                          uint64_t cap) {
  return zxch_pivco_core(data, n, code_len, out, cap, 1, nullptr);
}

// Exact encoded size (sum of per-node ceil-byte runs) without emitting.
int64_t zxch_pivco_size(const uint8_t *data, uint64_t n,
                        const uint8_t *code_len) {
  return zxch_pivco_core(data, n, code_len, nullptr, 0, 0, nullptr);
}

// freq-aware forms: callers that already histogrammed the section (every
// auction does, to build the code lengths) skip the redundant data pass.
int64_t zxch_pivco_encode_f(const uint8_t *data, uint64_t n,
                            const uint8_t *code_len, const uint64_t *freq,
                            uint8_t *out, uint64_t cap) {
  return zxch_pivco_core(data, n, code_len, out, cap, 1, freq);
}

int64_t zxch_pivco_size_f(const uint8_t *data, uint64_t n,
                          const uint8_t *code_len, const uint64_t *freq) {
  return zxch_pivco_core(data, n, code_len, nullptr, 0, 0, freq);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Entropy fallback for the fast levels: package-merge code lengths (mirror
// of codec/huffman.py build_code_lengths — identical tie-breaking so the
// native and Python frame paths keep making the same per-block decision)
// and an all-literal Huffman GLO payload. GHI literals are RAW by format,
// so when a block's match structure is poor (short-match-dense data), a
// sequence-free GLO block with PivCo-coded literals can be far smaller
// than any GHI parse; block types are self-describing so mixing them in
// one frame is wire-legal (reference decodes GLO at any level).
// ---------------------------------------------------------------------------

extern "C" {
int64_t zxch_pivco_encode(const uint8_t *data, uint64_t n,
                          const uint8_t *code_len, uint8_t *out,
                          uint64_t cap);
int64_t zxch_pivco_size(const uint8_t *data, uint64_t n,
                        const uint8_t *code_len);
}

// freq[256] -> cl[256] (0 = absent), cap max_len. Returns number of
// distinct symbols (0 => no lengths written).
//
// Counting-form boundary package-merge, O(max_len * n) with zero
// allocations. Equivalent-by-construction to the textbook coin-collector
// form (sorted leaf list; per round, merge leaves with the previous
// round's packages — leaves first on weight ties, matching a stable sort
// of [leaves..., packages...] — and pair consecutive items). Because the
// leaves appear in the merged list in ascending-weight order, the leaves
// selected among the first `take` items of any round are exactly the
// `k` smallest-weight leaves, so per-item coin sets collapse to one
// counter per round (reference builds lengths the same way at heart:
// zxc_huffman.c:178-317).
static int zxch_build_code_lengths(const uint64_t *freq, int max_len,
                                   uint8_t *cl) {
  int present[256];
  int n = 0;
  for (int s = 0; s < 256; s++)
    if (freq[s]) present[n++] = s;
  memset(cl, 0, 256);
  if (n == 0) return 0;
  if (n == 1) { cl[present[0]] = 1; return 1; }
  if (max_len > 15 || n > (1 << max_len)) return -1;
  // stable argsort by weight (ties keep ascending symbol order)
  int order[256];
  for (int i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order, order + n, [&](int a, int b) {
    return freq[present[a]] < freq[present[b]];
  });
  uint64_t w[256];
  for (int i = 0; i < n; i++) w[i] = freq[present[order[i]]];
  // forward: package weights per round. Round q's merged list is
  // merge(w, pk[q-1]) (round 0: leaves only); packages pair items 2j,2j+1.
  static thread_local uint64_t pk[15][256];
  int cnt[15];
  int rounds = max_len - 1;  // package-building rounds
  for (int q = 0; q < rounds; q++) {
    const uint64_t *pw = q ? pk[q - 1] : nullptr;
    int pc = q ? cnt[q - 1] : 0;
    int mlen = n + pc;
    int i = 0, j = 0;
    int out = 0;
    uint64_t *dst = pk[q];
    for (int m = 0; m + 1 < mlen; m += 2) {
      // two merged items per package
      uint64_t a, b;
      a = (j >= pc || (i < n && w[i] <= pw[j])) ? w[i++] : pw[j++];
      b = (j >= pc || (i < n && w[i] <= pw[j])) ? w[i++] : pw[j++];
      dst[out++] = a + b;
    }
    cnt[q] = out;
  }
  // backward: take the first 2n-2 items of the final merged list; at each
  // round the leaves taken are the k smallest, and p packages expand to
  // 2p items of the round below.
  int lengths[256] = {0};
  int take = 2 * n - 2;
  for (int q = rounds - 1; q >= 0 && take > 0; q--) {
    const uint64_t *pw = pk[q];
    int pc = cnt[q];
    int i = 0, j = 0;
    while (i + j < take && (i < n || j < pc)) {
      if (j >= pc || (i < n && w[i] <= pw[j])) i++;
      else j++;
    }
    for (int s2 = 0; s2 < i; s2++) lengths[s2]++;
    take = 2 * j;
  }
  // round "-1": the bottom merged list is pure leaves
  if (take > n) take = n;
  for (int s2 = 0; s2 < take; s2++) lengths[s2]++;
  for (int i = 0; i < n; i++) cl[present[order[i]]] = (uint8_t)lengths[i];
  return n;
}

// exported wrapper: optimal length-limited code lengths (package-merge)
// for the Python auction's fast path. Returns present-symbol count.
extern "C" int zxch_code_lengths(const uint64_t *freq, int max_len,
                                 uint8_t *cl) {
  if (max_len < 1 || max_len > 15) return -1;
  return zxch_build_code_lengths(freq, max_len, cl);
}

// All-literal Huffman GLO payload (GNR header + 4 descs + 128-byte
// lengths header + PivCo payload; empty token/offset/extras sections).
// `budget` = the competing payload size; returns emitted size only when
// strictly smaller, else -1 (also -1 when Huffman cannot help).
static int64_t zxch_encode_hufflit(const uint8_t *data, uint64_t P,
                                   uint8_t *out, uint64_t cap,
                                   uint64_t budget) {
  const uint64_t FIXED = 16 + 32 + 128;
  if (FIXED + (P + 7) / 8 >= budget || FIXED + (P + 7) / 8 > cap) return -1;
  uint64_t freq[256];
  // sampled pre-gate: a 1/16-stride histogram estimates the Huffman
  // payload; when the estimate exceeds the budget by >10% the full
  // histogram pass (the second-hottest op in the L1 profile) is skipped.
  // The margin makes misfires vanishingly rare on real data; archives
  // remain wire-legal either way (the candidate is an optimization).
  if (P >= 1 << 16) {
    uint64_t sfreq[256] = {0};
    uint64_t cnt = 0;
    for (uint64_t i = 0; i < P; i += 16) { sfreq[data[i]]++; cnt++; }
    uint8_t scl[256];
    if (zxch_build_code_lengths(sfreq, 8, scl) >= 2) {
      uint64_t sbits = 0;
      for (int s = 0; s < 256; s++) sbits += sfreq[s] * scl[s];
      uint64_t est = (sbits * (P / cnt)) / 8;
      if (FIXED + est > budget + budget / 10) return -1;
    }
  }
  zxch_hist4(data, P, freq);
  uint8_t cl[256];
  if (zxch_build_code_lengths(freq, 8, cl) < 2) return -1;
  uint64_t bits = 0;
  for (int s = 0; s < 256; s++) bits += freq[s] * cl[s];
  if (FIXED + (bits + 7) / 8 >= budget) return -1;  // lower bound: padding
  if (cap < FIXED + P + 64) return -1;
  // price exactly before paying the bit-packing pass: a losing candidate
  // costs only the histogram walk
  int64_t paysz = zxch_pivco_size_f(data, P, cl, freq);
  if (paysz < 0 || FIXED + (uint64_t)paysz >= budget) return -1;
  uint8_t *w = out;
  // lengths header: two 4-bit lengths per byte, low nibble first
  uint8_t *lit_w = w + 16 + 32;
  for (int s = 0; s < 256; s += 2)
    lit_w[s / 2] = (uint8_t)((cl[s] & 0x0F) | (cl[s + 1] << 4));
  int64_t esz = zxch_pivco_encode_f(data, P, cl, freq, lit_w + 128,
                                    cap - FIXED);
  if (esz != paysz) return -1;  // can't happen
  uint64_t lit_sec = 128 + (uint64_t)paysz;
  uint64_t need = 16 + 32 + lit_sec;
  if (need >= budget) return -1;
  uint32_t u = 0;
  memcpy(w, &u, 4);                       // n_sequences = 0
  u = (uint32_t)P; memcpy(w + 4, &u, 4);  // n_literals
  w[8] = 2;                               // enc_lit = HUFFMAN
  w[9] = 0; w[10] = 0;
  w[11] = 1;                              // enc_off (8-bit; no offsets)
  memset(w + 12, 0, 4);
  uint64_t d = lit_sec | ((uint64_t)P << 32);
  memcpy(w + 16, &d, 8);
  d = 0; memcpy(w + 24, &d, 8); memcpy(w + 32, &d, 8);
  memcpy(w + 40, &d, 8);
  return (int64_t)need;
}

// ---------------------------------------------------------------------------
// Whole-frame one-shot encode, levels 1-5 non-dict: the per-block loop of
// frame.compress (codec/frame.py:190, reference zxc_dispatch.c:671-826)
// entirely in C — header, GHI/GLO payloads with RAW fallback, optional
// per-block rapidhash32 + rolling global hash, optional SEK table, footer.
// Byte-identical with the Python frame assembly.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Persistent worker pool for the MT frame codec. The reference's stream
// engine keeps its workers alive for the whole file (zxc_driver.c:
// 420-494, thread-local cctx per worker); ours live for the process.
// Persistence is not just spawn cost: the encode hot path owns large
// `static thread_local` state (match-finder head/chain tables, Huffman
// scratch, parse arrays — several MB), which per-call fork-join threads
// would re-fault every frame and LEAK at thread death (raw-pointer TLS
// has no destructor). Pool threads reuse it exactly like the
// single-thread path. pool_run is non-reentrant (internal mutex
// serializes concurrent frames; jobs must not call pool_run).
// ---------------------------------------------------------------------------
namespace {
class WorkPool {
 public:
  // run fn(slot) for slot in [0, nt): slots 1..nt-1 on pool threads,
  // slot 0 on the caller. Blocks until all complete.
  void run(int nt, const std::function<void(int)> &fn) {
    std::lock_guard<std::mutex> user(user_mu_);
    grow(nt - 1);
    {
      std::unique_lock<std::mutex> lk(mu_);
      job_ = &fn;
      nt_ = nt;
      pending_ = nt - 1;
      gen_++;
      cv_.notify_all();
    }
    fn(0);
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    job_ = nullptr;
  }

 private:
  void grow(int need) {
    std::unique_lock<std::mutex> lk(mu_);
    while ((int)threads_.size() < need) {
      int slot = (int)threads_.size() + 1;
      // the generation is snapshotted UNDER mu_ before run() increments
      // it, so a slowly-starting thread can never miss its first job
      uint64_t g0 = gen_;
      std::thread t([this, slot, g0] { worker(slot, g0); });
      t.detach();  // process-lifetime pool; never joined
      threads_.push_back(slot);
    }
  }
  void worker(int slot, uint64_t seen) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      // every slot in [1, nt_) runs the job exactly once per generation
      // (gen_ cannot advance until run() saw pending_ == 0)
      if (job_ && slot < nt_) {
        const std::function<void(int)> *j = job_;
        lk.unlock();
        (*j)(slot);
        lk.lock();
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }
  std::mutex user_mu_;  // serializes pool users (non-reentrant)
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int)> *job_ = nullptr;
  std::vector<int> threads_;
  uint64_t gen_ = 0;
  int nt_ = 0;
  int pending_ = 0;
};

WorkPool &work_pool() {
  // intentionally leaked: a static instance would run ~WorkPool at exit
  // and destroy the mutex/condvar while detached workers still wait on
  // them (observed as a hang after main returns). The workers and the
  // pool die with the process.
  static WorkPool *p = new WorkPool();
  return *p;
}
}  // namespace

// Per-frame epoch: the per-thread dict-prefix staging below re-copies
// the dictionary once per frame per thread (a pointer tag alone could
// go stale if a caller frees one dict and allocates another at the
// same address between frames).
static std::atomic<uint64_t> g_enc_frame_epoch{1};

// Per-block encode dispatch shared by the sequential and MT frame
// encoders (byte-identical by construction: both paths call exactly
// this). Writes the winning payload into payload[0..pcap), returns its
// size (RAW fallback included) and sets *btype_out.
static int64_t zxch_encode_block_dispatch(
    const uint8_t *bdata, uint64_t len, int level, int max_probes,
    int lazy, int sufficient_len, int step_base, int step_shift,
    int cover_base, int min_emit, const uint8_t *dict, uint64_t dict_len,
    const uint8_t *dict_cl, uint8_t *payload, uint64_t pcap,
    int *btype_out, uint64_t frame_epoch) {
  const uint64_t BH = 8;
  // dict window: parse/emit run on [dict || block] with start=dict_len
  // (find_parse seeds chains from the prefix; offsets may reach into
  // it). The concat scratch is per-thread; the dict prefix is
  // (re)copied when this thread last staged a different dict.
  static thread_local uint8_t *cat = nullptr;
  static thread_local uint64_t cat_cap = 0;
  static thread_local uint64_t cat_epoch = 0;
  if (dict_len) {
    uint64_t needc = dict_len + len + 64;
    if (needc > cat_cap) {
      delete[] cat;
      cat = new uint8_t[needc];
      cat_cap = needc;
      cat_epoch = 0;
    }
    // frame_epoch is the CALLER's per-frame snapshot, not a fresh read
    // of the global counter: a concurrent frame with a different dict
    // bumps the global mid-encode, and a worker that re-read it here
    // would tag ITS dict copy with the OTHER frame's epoch — the other
    // frame's workers would then skip their re-copy and encode against
    // a stale prefix (review finding, round 4).
    if (cat_epoch != frame_epoch) {
      memcpy(cat, dict, dict_len);
      cat_epoch = frame_epoch;
    }
  }
  int64_t psz;
  int btype;
  if (level >= 6) {
    // archival levels: DP optimal parse + premium auction (the Python
    // L6/7 path runs no hufflit competitor — the GLO auction's
    // all-literal Huffman case covers it)
    if (dict_len) {
      memcpy(cat + dict_len, bdata, len);
      psz = zxch_encode_glo_opt(cat, dict_len + len, dict_len, level,
                                max_probes, dict_cl, payload, pcap);
    } else {
      psz = zxch_encode_glo_opt(bdata, len, 0, level, max_probes,
                                dict_cl, payload, pcap);
    }
    btype = 1;  // GLO
    // adaptive deepening (L6, mirrored in block_encode.py): on
    // poorly-compressing blocks (payload > 45% of input — machine
    // code: libc/libstdc++/our own .so measured +0.03..0.10% vs the
    // reference at depth 64) the depth-64 chain walk is what's
    // missing, not the cost model (flat-8 literal pricing measured
    // ZERO effect; depth 128+ flips every measured ELF corpus).
    // Re-encode those blocks at 3x depth and keep the smaller
    // payload; compressible corpora never trigger, so the pinned/
    // csrc speed ratio is untouched.
    if (level == 6 && psz >= 0 && (uint64_t)psz * 20 > len * 9) {
      // scratch bounded by the block (pcap may be a whole archive's
      // remaining capacity); any p2 we would accept is < psz <= ~len
      const uint64_t deep_cap = len + len / 4 + 1024;
      static thread_local std::vector<uint8_t> deep;
      if (deep.size() < deep_cap) deep.resize(deep_cap);
      int64_t p2;
      if (dict_len)
        p2 = zxch_encode_glo_opt(cat, dict_len + len, dict_len, level,
                                 max_probes * 3, dict_cl, deep.data(),
                                 deep_cap);
      else
        p2 = zxch_encode_glo_opt(bdata, len, 0, level, max_probes * 3,
                                 dict_cl, deep.data(), deep_cap);
      if (p2 >= 0 && p2 < psz) {
        memcpy(payload, deep.data(), (size_t)p2);
        psz = p2;
      }
    }
  } else if (level >= 2) {
    // Levels 2-5 ride GLO (round-2c): the GLO sections beat GHI
    // packing at the same greedy parse on every gate corpus AND emit
    // faster; a GLO block at any level is wire-legal (block types
    // are self-describing). The all-literal Huffman candidate
    // competes at every fast GLO level — below ULTRA the literal
    // section prices only RAW/RLE, so on low-entropy or match-poor
    // data the 0-sequence Huffman block wins outright (L5 elf
    // -0.4 -> -6.5%, tinyalpha -3.6 -> -41%). It encodes into a
    // scratch so the GLO payload survives a loss.
    if (dict_len) {
      memcpy(cat + dict_len, bdata, len);
      psz = zxch_encode_glo(cat, dict_len + len, dict_len, max_probes,
                            lazy, sufficient_len, step_base, step_shift,
                            cover_base, min_emit, dict_cl, payload, pcap);
    } else {
      psz = zxch_encode_glo(bdata, len, 0, max_probes, lazy,
                            sufficient_len, step_base, step_shift,
                            cover_base, min_emit, dict_cl, payload, pcap);
    }
    btype = 1;  // GLO
    static const int no_hl2 = getenv("ZXCH_NO_HUFLIT") != nullptr;
    if (!no_hl2) {
      uint64_t budget = len > BH ? len - BH : 0;
      if (psz >= 0 && (uint64_t)psz < budget) budget = (uint64_t)psz;
      static thread_local std::vector<uint8_t> hlbuf2;
      if (hlbuf2.size() < len + 1024) hlbuf2.resize(len + 1024);
      int64_t hl = zxch_encode_hufflit(bdata, len, hlbuf2.data(),
                                       hlbuf2.size(), budget);
      if (hl >= 0 && (uint64_t)hl <= pcap) {
        memcpy(payload, hlbuf2.data(), (size_t)hl);
        psz = hl;
      }
    }
  } else if (level <= 1) {
    // parse once; the GHI payload size is exact BEFORE emission (raw
    // literals + fixed-width words), so the entropy-fallback decision
    // runs first and only the winning encode is emitted — byte-
    // identical to emit-then-compare, without the double encode
    uint64_t max_seq = len / 5 + 8;
    zxch_parse_scratch(max_seq);
    const uint8_t *pdat = bdata;
    uint64_t pstart = 0;
    if (dict_len) {
      memcpy(cat + dict_len, bdata, len);
      pdat = cat;
      pstart = dict_len;
    }
    int64_t nseq = zxch_find_parse(pdat, pstart + len, pstart, max_probes,
                                   lazy, sufficient_len, step_base,
                                   step_shift, cover_base, min_emit,
                                   g_mp, g_ml, g_mo, max_seq);
    uint64_t lit_total = 0, n_ext = 0;
    int64_t ghi_need = nseq >= 0
        ? (int64_t)zxch_ghi_size(g_mp, g_ml, nseq, len, &lit_total,
                                 &n_ext)
        : -10;
    static const int no_hl = getenv("ZXCH_NO_HUFLIT") != nullptr;
    uint64_t budget = len > BH ? len - BH : 0;
    if (ghi_need >= 0 && (uint64_t)ghi_need < budget)
      budget = (uint64_t)ghi_need;
    int64_t hl = no_hl ? -1
        : zxch_encode_hufflit(bdata, len, payload, pcap, budget);
    if (hl >= 0) {
      psz = hl;
      btype = 1;  // GLO (all-literal Huffman)
    } else if (ghi_need >= 0 && (uint64_t)ghi_need <= pcap) {
      psz = zxch_emit_ghi(pdat, pstart, len, g_mp, g_ml, g_mo, nseq,
                          lit_total, n_ext, payload);
      btype = 2;  // GHI
    } else {
      psz = -10;
      btype = 2;
    }
  } else {
    psz = zxch_encode_glo(bdata, len, 0, max_probes, lazy,
                          sufficient_len, step_base, step_shift,
                          cover_base, min_emit, nullptr, payload, pcap);
    btype = 1;  // GLO
  }
  if (psz < 0 || (uint64_t)(BH + psz) >= len) {
    // RAW fallback (encode_chunk expansion rule, block_encode.py)
    memmove(payload, bdata, len);
    psz = (int64_t)len;
    btype = 0;
  }
  *btype_out = btype;
  return psz;
}

extern "C" {

int64_t zxch_compress_frame(const uint8_t *data, uint64_t n, int level,
                            int max_probes, int lazy, int sufficient_len,
                            int step_base, int step_shift, int cover_base,
                            int min_emit,
                            uint64_t block_size, int block_size_code,
                            int checksum, int seekable,
                            const uint8_t *dict, uint64_t dict_len,
                            const uint8_t *dict_cl, uint32_t dict_id,
                            uint8_t *out, uint64_t cap) {
  const uint64_t HDR = 16, BH = 8, FOOT = 12;
  uint64_t w = 0;
  const uint64_t frame_epoch =
      g_enc_frame_epoch.fetch_add(1, std::memory_order_relaxed) + 1;
  if (cap < HDR) return -10;
  // file header (headers.py:20)
  memset(out, 0, HDR);
  out[0] = 0xF5; out[1] = 0x2E; out[2] = 0xB0; out[3] = 0x9C;  // MAGIC_WORD
  out[4] = 7;                                   // FORMAT_VERSION
  out[5] = (uint8_t)block_size_code;
  out[6] = checksum ? (uint8_t)0x80 : 0;  // FLAG_HAS_CHECKSUM|RAPIDHASH(0)
  if (dict_id) {
    out[6] |= 0x40;                       // FLAG_HAS_DICTIONARY
    memcpy(out + 7, &dict_id, 4);
  }
  uint16_t h16 = zxch_hash16(out);
  out[14] = (uint8_t)(h16 & 0xFF);
  out[15] = (uint8_t)(h16 >> 8);
  w = HDR;

  uint64_t n_blocks = (n + block_size - 1) / block_size;
  uint32_t *seek_sizes = seekable && n_blocks
      ? new uint32_t[n_blocks] : nullptr;
  uint32_t global_hash = 0;
  uint64_t bi = 0;
  for (uint64_t pos = 0; pos < n; pos += block_size, bi++) {
    uint64_t len = n - pos < block_size ? n - pos : block_size;
    if (w + BH + len + 64 + len / 4 > cap) {
      delete[] seek_sizes;
      return -10;
    }
    uint8_t *payload = out + w + BH;
    uint64_t pcap = cap - w - BH - 8;
    int btype;
    int64_t psz = zxch_encode_block_dispatch(
        data + pos, len, level, max_probes, lazy, sufficient_len,
        step_base, step_shift, cover_base, min_emit, dict, dict_len,
        dict_cl, payload, pcap, &btype, frame_epoch);
    // block header (headers.py:64)
    uint8_t *bh = out + w;
    memset(bh, 0, BH);
    bh[0] = (uint8_t)btype;
    bh[3] = (uint8_t)(psz & 0xFF);
    bh[4] = (uint8_t)((psz >> 8) & 0xFF);
    bh[5] = (uint8_t)((psz >> 16) & 0xFF);
    bh[6] = (uint8_t)((psz >> 24) & 0xFF);
    bh[7] = zxch_hash8(bh);
    w += BH + (uint64_t)psz;
    uint64_t blk_bytes = BH + (uint64_t)psz;
    if (checksum) {
      uint32_t cs = zxch_rapidhash32(payload, (size_t)psz, 0);
      out[w] = (uint8_t)(cs & 0xFF);
      out[w + 1] = (uint8_t)((cs >> 8) & 0xFF);
      out[w + 2] = (uint8_t)((cs >> 16) & 0xFF);
      out[w + 3] = (uint8_t)((cs >> 24) & 0xFF);
      w += 4;
      blk_bytes += 4;
      global_hash = ((global_hash << 1) | (global_hash >> 31)) ^ cs;
    }
    if (seek_sizes) seek_sizes[bi] = (uint32_t)blk_bytes;
  }

  // EOF block
  if (w + BH + FOOT > cap) { delete[] seek_sizes; return -10; }
  uint8_t *eof = out + w;
  memset(eof, 0, BH);
  eof[0] = 0xFF;
  eof[7] = zxch_hash8(eof);
  w += BH;
  // SEK table (headers.py:138: SEK block header + u32 sizes)
  if (seek_sizes && bi) {
    uint64_t body = 4 * bi;
    if (w + BH + body + FOOT > cap) { delete[] seek_sizes; return -10; }
    uint8_t *sh = out + w;
    memset(sh, 0, BH);
    sh[0] = 0xFE;
    sh[3] = (uint8_t)(body & 0xFF);
    sh[4] = (uint8_t)((body >> 8) & 0xFF);
    sh[5] = (uint8_t)((body >> 16) & 0xFF);
    sh[6] = (uint8_t)((body >> 24) & 0xFF);
    sh[7] = zxch_hash8(sh);
    w += BH;
    memcpy(out + w, seek_sizes, body);
    w += body;
  }
  delete[] seek_sizes;
  // footer: <QI> src_size, global_hash (0 when checksums off)
  for (int i = 0; i < 8; i++) out[w + i] = (uint8_t)((n >> (8 * i)) & 0xFF);
  uint32_t gh = checksum ? global_hash : 0;
  for (int i = 0; i < 4; i++)
    out[w + 8 + i] = (uint8_t)((gh >> (8 * i)) & 0xFF);
  w += FOOT;
  return (int64_t)w;
}

// Multi-threaded frame encode: the same per-block dispatch
// (zxch_encode_block_dispatch) fanned over the persistent worker pool.
// Blocks are encoded into per-block staging slots in waves (bounded
// memory: one wave = 4*threads slots), then stitched in order on the
// calling thread — headers, per-block rapidhash, the rolling global
// hash, and the SEK table are all writer-side, the same split as the
// reference's stream engine (workers own cctx + payload bytes, the
// ordered writer owns wire framing; zxc_driver.c:420-597). Archive
// bytes are identical to zxch_compress_frame because the dispatch and
// the stitch order are.
int64_t zxch_compress_frame_mt(const uint8_t *data, uint64_t n, int level,
                               int max_probes, int lazy, int sufficient_len,
                               int step_base, int step_shift, int cover_base,
                               int min_emit,
                               uint64_t block_size, int block_size_code,
                               int checksum, int seekable,
                               const uint8_t *dict, uint64_t dict_len,
                               const uint8_t *dict_cl, uint32_t dict_id,
                               uint8_t *out, uint64_t cap, int threads) {
  if (threads <= 1 || block_size == 0 || n <= block_size)
    return zxch_compress_frame(data, n, level, max_probes, lazy,
                               sufficient_len, step_base, step_shift,
                               cover_base, min_emit, block_size,
                               block_size_code, checksum, seekable, dict,
                               dict_len, dict_cl, dict_id, out, cap);
  const uint64_t HDR = 16, BH = 8, FOOT = 12;
  uint64_t w = 0;
  const uint64_t frame_epoch =
      g_enc_frame_epoch.fetch_add(1, std::memory_order_relaxed) + 1;
  if (cap < HDR) return -10;
  memset(out, 0, HDR);
  out[0] = 0xF5; out[1] = 0x2E; out[2] = 0xB0; out[3] = 0x9C;
  out[4] = 7;
  out[5] = (uint8_t)block_size_code;
  out[6] = checksum ? (uint8_t)0x80 : 0;
  if (dict_id) {
    out[6] |= 0x40;
    memcpy(out + 7, &dict_id, 4);
  }
  uint16_t h16 = zxch_hash16(out);
  out[14] = (uint8_t)(h16 & 0xFF);
  out[15] = (uint8_t)(h16 >> 8);
  w = HDR;

  uint64_t n_blocks = (n + block_size - 1) / block_size;
  int nt = threads;
  if ((uint64_t)nt > n_blocks) nt = (int)n_blocks;
  if (nt > 64) nt = 64;
  const uint64_t W = 4ull * nt;  // wave width (staging slots)
  // slot sizing: generous vs the sequential per-block guarantee
  // (len + len/4 + 64) so tight-pcap failure paths cannot diverge
  const uint64_t slot = block_size + block_size / 2 + 1024;
  // nothrow allocation: std::bad_alloc must not propagate out of this
  // extern "C" entry into ctypes/cgo/FFI callers (process abort/UB) —
  // at threads=64 and 2 MiB blocks the wave staging is ~770 MB
  std::unique_ptr<uint8_t[]> stage(new (std::nothrow) uint8_t[W * slot]);
  if (!stage) return -1;
  std::vector<int64_t> psz(W);
  std::vector<int> btype(W);
  std::vector<uint32_t> csum(W);
  uint32_t *seek_sizes =
      seekable ? new (std::nothrow) uint32_t[n_blocks] : nullptr;
  if (seekable && !seek_sizes) return -1;
  uint32_t global_hash = 0;

  for (uint64_t wave = 0; wave < n_blocks; wave += W) {
    const uint64_t wn = n_blocks - wave < W ? n_blocks - wave : W;
    std::atomic<uint64_t> widx(0);
    work_pool().run(nt, [&](int) {
      for (;;) {
        uint64_t j = widx.fetch_add(1, std::memory_order_relaxed);
        if (j >= wn) break;
        const uint64_t bi = wave + j;
        const uint64_t pos = bi * block_size;
        const uint64_t len = n - pos < block_size ? n - pos : block_size;
        uint8_t *payload = stage.get() + j * slot;
        int bt;
        psz[j] = zxch_encode_block_dispatch(
            data + pos, len, level, max_probes, lazy, sufficient_len,
            step_base, step_shift, cover_base, min_emit, dict, dict_len,
            dict_cl, payload, slot - 64, &bt, frame_epoch);
        btype[j] = bt;
        if (checksum && psz[j] >= 0)
          csum[j] = zxch_rapidhash32(payload, (size_t)psz[j], 0);
      }
    });
    // ordered stitch (writer role)
    for (uint64_t j = 0; j < wn; j++) {
      const uint64_t bi = wave + j;
      const uint64_t pos = bi * block_size;
      const uint64_t len = n - pos < block_size ? n - pos : block_size;
      if (w + BH + len + 64 + len / 4 > cap || psz[j] < 0) {
        delete[] seek_sizes;
        return -10;
      }
      uint8_t *bh = out + w;
      memset(bh, 0, BH);
      bh[0] = (uint8_t)btype[j];
      uint32_t ps = (uint32_t)psz[j];
      bh[3] = (uint8_t)(ps & 0xFF);
      bh[4] = (uint8_t)((ps >> 8) & 0xFF);
      bh[5] = (uint8_t)((ps >> 16) & 0xFF);
      bh[6] = (uint8_t)((ps >> 24) & 0xFF);
      bh[7] = zxch_hash8(bh);
      memcpy(out + w + BH, stage.get() + j * slot, (size_t)psz[j]);
      w += BH + (uint64_t)psz[j];
      uint64_t blk_bytes = BH + (uint64_t)psz[j];
      if (checksum) {
        uint32_t cs = csum[j];
        out[w] = (uint8_t)(cs & 0xFF);
        out[w + 1] = (uint8_t)((cs >> 8) & 0xFF);
        out[w + 2] = (uint8_t)((cs >> 16) & 0xFF);
        out[w + 3] = (uint8_t)((cs >> 24) & 0xFF);
        w += 4;
        blk_bytes += 4;
        global_hash = ((global_hash << 1) | (global_hash >> 31)) ^ cs;
      }
      if (seek_sizes) seek_sizes[bi] = (uint32_t)blk_bytes;
    }
  }

  // EOF + SEK + footer: identical to the sequential writer
  if (w + BH + FOOT > cap) { delete[] seek_sizes; return -10; }
  uint8_t *eof = out + w;
  memset(eof, 0, BH);
  eof[0] = 0xFF;
  eof[7] = zxch_hash8(eof);
  w += BH;
  if (seek_sizes && n_blocks) {
    uint64_t body = 4 * n_blocks;
    if (w + BH + body + FOOT > cap) { delete[] seek_sizes; return -10; }
    uint8_t *sh = out + w;
    memset(sh, 0, BH);
    sh[0] = 0xFE;
    sh[3] = (uint8_t)(body & 0xFF);
    sh[4] = (uint8_t)((body >> 8) & 0xFF);
    sh[5] = (uint8_t)((body >> 16) & 0xFF);
    sh[6] = (uint8_t)((body >> 24) & 0xFF);
    sh[7] = zxch_hash8(sh);
    w += BH;
    memcpy(out + w, seek_sizes, body);
    w += body;
  }
  delete[] seek_sizes;
  for (int i = 0; i < 8; i++) out[w + i] = (uint8_t)((n >> (8 * i)) & 0xFF);
  uint32_t gh = checksum ? global_hash : 0;
  for (int i = 0; i < 4; i++)
    out[w + 8 + i] = (uint8_t)((gh >> (8 * i)) & 0xFF);
  w += FOOT;
  return (int64_t)w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fully-native frame decode (the host hot path).
//
// One C call decodes a whole archive: frame walk, per-block section parse,
// entropy literal decode, and a FUSED token/extras/expand loop — no
// intermediate (ll, ml, off) arrays, no per-block Python round trips.
// Mirrors the conformance-verified Python pipeline in
// zxc_tpu/codec/frame.py (decompress) + codec/block_decode.py; reference
// behavior contract: zxc_dispatch.c:856-1055 + zxc_decompress.c:1495-1544.
//
// Output buffer contract: callers allocate n_blocks*block_size + 64 bytes
// so fixed-width wild copies may overshoot the logical write cursor; all
// LOGICAL bounds are still checked exactly (same error codes as Python).
// ---------------------------------------------------------------------------

namespace {

struct DecScratch {
  uint8_t *lit;  // block_size + 64 (decoded literal section)
  uint8_t *tok;  // block_size     (decoded token section)
  uint8_t *piv;  // block_size     (PivCo ping-pong scratch)
};

inline uint64_t rd16le(const uint8_t *p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// 1..3-byte prefix varint; returns consumed bytes or -8.
inline int64_t dec_varint(const uint8_t *p, uint64_t rem, uint64_t *v) {
  if (!rem) return -8;
  uint8_t b0 = p[0];
  if (b0 < 0x80) {
    *v = b0;
    return 1;
  }
  if (b0 < 0xC0) {
    if (rem < 2) return -8;
    *v = (uint64_t)(b0 & 0x3F) | ((uint64_t)p[1] << 6);
    return 2;
  }
  if (b0 < 0xE0) {
    if (rem < 3) return -8;
    *v = (uint64_t)(b0 & 0x1F) | ((uint64_t)p[1] << 5) |
         ((uint64_t)p[2] << 13);
    return 3;
  }
  return -8;
}

// Unpack the 128-byte nibble-packed code-length header (cap 11, not all 0).
inline int unpack_cl(const uint8_t *packed, uint8_t *cl) {
  int any = 0;
  for (int i = 0; i < 128; i++) {
    uint8_t b = packed[i];
    uint8_t lo = (uint8_t)(b & 15), hi = (uint8_t)(b >> 4);
    if (lo > 11 || hi > 11) return -8;
    cl[2 * i] = lo;
    cl[2 * i + 1] = hi;
    any |= b;
  }
  return any ? 0 : -8;
}

#if defined(__AVX512VBMI__) && defined(__AVX512VL__)
// vpermb index tables for the small-offset pattern copy: row o holds
// i % o, so one permutexvar replicates the o-byte repeating unit across
// a full 32-byte register (the VBMI analog of the reference's SSSE3
// shuffle masks, zxc_decompress.c:114-143).
static const uint8_t zxch_overlap_idx[16][32] = {
#define ZXCH_ROW(o) {0%(o),1%(o),2%(o),3%(o),4%(o),5%(o),6%(o),7%(o), \
  8%(o),9%(o),10%(o),11%(o),12%(o),13%(o),14%(o),15%(o),16%(o),17%(o), \
  18%(o),19%(o),20%(o),21%(o),22%(o),23%(o),24%(o),25%(o),26%(o),27%(o), \
  28%(o),29%(o),30%(o),31%(o)}
    ZXCH_ROW(1), ZXCH_ROW(1), ZXCH_ROW(2), ZXCH_ROW(3), ZXCH_ROW(4),
    ZXCH_ROW(5), ZXCH_ROW(6), ZXCH_ROW(7), ZXCH_ROW(8), ZXCH_ROW(9),
    ZXCH_ROW(10), ZXCH_ROW(11), ZXCH_ROW(12), ZXCH_ROW(13), ZXCH_ROW(14),
    ZXCH_ROW(15),
#undef ZXCH_ROW
};
#endif

// Overlap-aware match copy: wild 16-byte chunks once the effective
// distance reaches 16; below that, one vpermb replicates the o-byte
// pattern across a 32-byte register and wild stores advance by the
// largest multiple of o <= 32 (phase-preserving), replacing the
// store-forward-stalled doubling rounds (reference analog:
// zxc_decode_copy_overlap_run, zxc_decompress.c:159-207). Caller
// guarantees >= 32 bytes of physical slack past the logical end.
inline void copy_match(uint8_t *d, uint64_t o, uint64_t mlen) {
  if (o >= 32) {
    const uint8_t *sp = d - o;
    memcpy(d, sp, 32);
    if (mlen > 32)
      for (uint64_t k = 32; k < mlen; k += 32) memcpy(d + k, sp + k, 32);
    return;
  }
  if (o >= 16) {
    const uint8_t *sp = d - o;
    for (uint64_t k = 0; k < mlen; k += 16) memcpy(d + k, sp + k, 16);
    return;
  }
  if (o == 1) {
    memset(d, d[-1], mlen);
    return;
  }
#if defined(__AVX512VBMI__) && defined(__AVX512VL__)
  // o in [2,15]: the 16-byte load at d-o reads only readable slack past
  // d; vpermb indices never reference lanes >= o
  __m128i unit = _mm_loadu_si128((const __m128i *)(d - o));
  __m256i idx = _mm256_loadu_si256((const __m256i *)zxch_overlap_idx[o]);
  __m256i pat =
      _mm256_permutexvar_epi8(idx, _mm256_castsi128_si256(unit));
  const uint64_t stride = 32 - (32 % o);
  for (uint64_t k = 0; k < mlen; k += stride)
    _mm256_storeu_si256((__m256i *)(d + k), pat);
#else
  uint64_t done = 0, dist = o;
  while (dist < 16) {
    if (done + dist >= mlen) {
      for (; done < mlen; done++) d[done] = d[done - dist];
      return;
    }
    memcpy(d + done, d + done - dist, dist);
    done += dist;
    dist <<= 1;
  }
  for (; done < mlen; done += 16) memcpy(d + done, d + done - dist, 16);
#endif
}

// Literal copy: fixed-width wild chunks when the source has >= 32 bytes
// of readable slack (scratch buffers always do; raw payload sections only
// when not flush against the archive end).
inline void copy_literals(uint8_t *d, const uint8_t *s, uint64_t l,
                          int wild) {
  if (!wild) {
    memcpy(d, s, l);
    return;
  }
  memcpy(d, s, 16);
  if (l > 16)
    for (uint64_t k = 16; k < l; k += 32) memcpy(d + k, s + k, 32);
}

// GHI variant: 32-byte first chunk. GHI literal runs are longer than
// GLO's (byte ll field vs 4-bit token), where the wider first copy
// measured +9% at L1; on GLO's short runs it was neutral-to-negative,
// so GLO keeps the 16-byte first chunk.
inline void copy_literals32(uint8_t *d, const uint8_t *s, uint64_t l,
                            int wild) {
  if (!wild) {
    memcpy(d, s, l);
    return;
  }
  memcpy(d, s, 32);
  if (l > 32)
    for (uint64_t k = 32; k < l; k += 32) memcpy(d + k, s + k, 32);
}

// Decode one GLO or GHI payload into out[0..block_size). Returns produced
// bytes or a negative ZXC error (codes match the Python path exactly).
int64_t decode_gnr_block(int is_glo, const uint8_t *pl, uint64_t plen,
                         uint8_t *out, uint64_t block_size,
                         const uint8_t *dict, uint64_t n_dict,
                         const uint8_t *dict_cl, DecScratch *S,
                         int payload_wild) {
  const int n_sec = is_glo ? 4 : 3;
  const uint64_t HDR = 16 + 8u * n_sec;
  if (plen < HDR) return -6;  // BAD_HEADER: sub-header truncated
  uint32_t n_seq;
  memcpy(&n_seq, pl, 4);
  uint8_t enc_lit = pl[8], enc_tok = pl[9], enc_off = pl[11];
  uint64_t sz[4] = {0, 0, 0, 0}, raw[4] = {0, 0, 0, 0};
  uint64_t tile = HDR;
  for (int k = 0; k < n_sec; k++) {
    uint64_t d;
    memcpy(&d, pl + 16 + 8 * k, 8);
    sz[k] = d & 0xFFFFFFFFu;
    raw[k] = d >> 32;
    tile += sz[k];
  }
  if (tile != plen) return -8;  // sections do not tile payload
  const uint8_t *sec_lit = pl + HDR;
  const uint8_t *sec_b = sec_lit + sz[0];   // tokens (GLO) / words (GHI)
  const uint8_t *sec_c = sec_b + sz[1];     // offsets (GLO) / extras (GHI)
  const uint8_t *sec_ext = is_glo ? sec_c + sz[2] : sec_c;
  const uint64_t sz_ext = is_glo ? sz[3] : sz[2];
  if (n_seq > block_size / 5 + 1) return -8;  // cannot fit MIN_MATCH each

  // ---- literal section ----
  const uint8_t *lit;
  uint64_t n_lit;
  int lit_wild;
  if (!is_glo || enc_lit == 0) {  // GHI literals are always raw
    lit = sec_lit;
    n_lit = sz[0];
    lit_wild = payload_wild;
  } else {
    uint64_t rl = raw[0];
    if (rl > block_size) return -8;  // literal section larger than block
    lit = S->lit;
    n_lit = rl;
    lit_wild = 1;
    if (enc_lit == 1) {  // RLE
      if (rl) {
        int rc = zxch_rle_decode(sec_lit, sz[0], S->lit, rl);
        if (rc) return rc;
      }
    } else if (enc_lit == 2) {  // Huffman with inline lengths header
      if (rl) {
        if (sz[0] < 128) return -8;
        uint8_t cl[256];
        if (unpack_cl(sec_lit, cl)) return -8;
        int rc = zxch_pivco_decode_s(sec_lit + 128, sz[0] - 128, cl, rl,
                                     S->lit, S->piv);
        if (rc) return rc;
      }
    } else if (enc_lit == 3) {  // shared dictionary table
      if (!dict_cl) return -15;  // DICT_REQUIRED
      if (rl) {
        int rc = zxch_pivco_decode_s(sec_lit, sz[0], dict_cl, rl, S->lit,
                                     S->piv);
        if (rc) return rc;
      }
    } else {
      return -8;
    }
  }

  // ---- token / word section ----
  const uint8_t *tok = sec_b;
  if (is_glo) {
    if (enc_tok == 2) {
      if (n_seq) {
        if (sz[1] < 128) return -8;
        uint8_t cl[256];
        if (unpack_cl(sec_b, cl)) return -8;
        int rc = zxch_pivco_decode_s(sec_b + 128, sz[1] - 128, cl, n_seq,
                                     S->tok, S->piv);
        if (rc) return rc;
      }
      tok = S->tok;
    } else if (enc_tok == 0) {
      if (sz[1] < n_seq) return -8;
    } else {
      return -8;
    }
    uint64_t expected_off = (enc_off == 1) ? n_seq : 2u * n_seq;
    if (sz[2] < expected_off) return -8;
  } else {
    if (sz[1] < 4u * n_seq) return -8;
  }

  // ---- fused expand ----
  // SAFE/FAST split (reference zxc_decompress.c SAFE->FAST ladder): once
  // w >= 64KB the window guarantees o <= w, and away from the literal /
  // output ends the capacity checks cannot fire, so the burst loops run
  // with no per-sequence bounds checks — only the varint-escape test.
  uint64_t w = 0, r = 0, e = 0;
  uint64_t i = 0;
  const uint64_t WIN64 = 64 * 1024;
  const uint64_t wlim = block_size > 640 ? block_size - 640 : 0;
  const uint64_t rlim = n_lit > 300 ? n_lit - 300 : 0;
  while (i < n_seq) {
    if (w < WIN64) {
      // SAFE-phase bursts (reference SAFE 4x ladder, zxc_decompress.c:
      // 890-911): identical batch shape with one extra per-sequence
      // offset-validation test (o > w breaks to the checked path, which
      // produces the exact error / dict semantics). Without this the
      // first 64 KiB of every block pays the one-at-a-time checked loop.
      if (is_glo) {
        if (enc_off == 1) {
          while (i < n_seq && w < wlim && r < rlim) {
            uint64_t cap_w = (wlim - w) / 33;
            uint64_t cap_r = (rlim - r) / 14;
            uint64_t nb = n_seq - i;
            if (cap_w < nb) nb = cap_w;
            if (cap_r < nb) nb = cap_r;
            if (!nb) break;
            uint64_t end = i + nb;
            int esc = 0;
            for (; i < end; i++) {
              uint32_t t = tok[i];
              uint64_t l = t >> 4, m = t & 15;
              uint64_t o = (uint64_t)sec_c[i] + 1;
              if (l == 15 || m == 15 || o > w + l) { esc = 1; break; }
              copy_literals(out + w, lit + r, l, lit_wild);
              w += l; r += l;
              copy_match(out + w, o, m + 5);
              w += m + 5;
            }
            if (esc) break;
          }
        } else {
          while (i < n_seq && w < wlim && r < rlim) {
            uint64_t cap_w = (wlim - w) / 33;
            uint64_t cap_r = (rlim - r) / 14;
            uint64_t nb = n_seq - i;
            if (cap_w < nb) nb = cap_w;
            if (cap_r < nb) nb = cap_r;
            if (!nb) break;
            uint64_t end = i + nb;
            int esc = 0;
            for (; i < end; i++) {
              uint32_t t = tok[i];
              uint64_t l = t >> 4, m = t & 15;
              uint64_t o = rd16le(sec_c + 2 * i) + 1;
              if (l == 15 || m == 15 || o > w + l) { esc = 1; break; }
              copy_literals(out + w, lit + r, l, lit_wild);
              w += l; r += l;
              copy_match(out + w, o, m + 5);
              w += m + 5;
            }
            if (esc) break;
          }
        }
      } else {
        const uint64_t wlimg = block_size > 1300 ? block_size - 1300 : 0;
        const uint64_t rlimg = n_lit > 560 ? n_lit - 560 : 0;
        while (i + 2 <= n_seq && w < wlimg && r < rlimg && w < WIN64) {
          const uint64_t i0 = i, w0 = w, r0 = r;
          uint64_t wd2;
          memcpy(&wd2, sec_b + 4 * i, 8);
          int fail = 0;
#pragma GCC unroll 2
          for (int k = 0; k < 2; k++) {
            uint32_t wd = (uint32_t)(wd2 >> (32 * k));
            uint64_t l = wd >> 24, m = (wd >> 16) & 0xFF;
            uint64_t o = (wd & 0xFFFF) + 1;
            if (l == 255 || m == 255 || o > w + l) { fail = 1; break; }
            copy_literals32(out + w, lit + r, l, lit_wild);
            w += l;
            r += l;
            copy_match(out + w, o, m + 5);
            w += m + 5;
          }
          if (__builtin_expect(fail, 0)) {
            i = i0; w = w0; r = r0;
            break;
          }
          i += 2;
        }
      }
      if (i >= n_seq) break;
    } else {
      if (is_glo) {
        if (enc_off == 1) {
          // bound the iterations that cannot hit the w/r capacity
          // limits (max advance per sequence: 14 lit + 19 match), so
          // the burst loop tests ONLY the varint escape, two
          // sequences per iteration
          while (i < n_seq && w < wlim && r < rlim) {
            uint64_t cap_w = (wlim - w) / 33;
            uint64_t cap_r = (rlim - r) / 14;
            uint64_t nb = n_seq - i;
            if (cap_w < nb) nb = cap_w;
            if (cap_r < nb) nb = cap_r;
            if (!nb) {
              // capacity-checked stragglers, one at a time
              uint32_t t = tok[i];
              uint64_t l = t >> 4, m = t & 15;
              if (l == 15 || m == 15) break;
              uint64_t o = (uint64_t)sec_c[i] + 1;
              copy_literals(out + w, lit + r, l, lit_wild);
              w += l; r += l;
              copy_match(out + w, o, m + 5);
              w += m + 5;
              i++;
              continue;
            }
            uint64_t end = i + nb;
            int esc = 0;
            for (; i + 2 <= end; i += 2) {
              uint32_t t0 = tok[i], t1 = tok[i + 1];
              uint64_t l0 = t0 >> 4, m0 = t0 & 15;
              uint64_t l1 = t1 >> 4, m1 = t1 & 15;
              if (l0 == 15 || m0 == 15) { esc = 1; break; }
              uint64_t o0 = (uint64_t)sec_c[i] + 1;
              copy_literals(out + w, lit + r, l0, lit_wild);
              w += l0; r += l0;
              copy_match(out + w, o0, m0 + 5);
              w += m0 + 5;
              if (l1 == 15 || m1 == 15) { esc = 1; i++; break; }
              uint64_t o1 = (uint64_t)sec_c[i + 1] + 1;
              copy_literals(out + w, lit + r, l1, lit_wild);
              w += l1; r += l1;
              copy_match(out + w, o1, m1 + 5);
              w += m1 + 5;
            }
            if (!esc)
              for (; i < end; i++) {
                uint32_t t = tok[i];
                uint64_t l = t >> 4, m = t & 15;
                if (l == 15 || m == 15) { esc = 1; break; }
                uint64_t o = (uint64_t)sec_c[i] + 1;
                copy_literals(out + w, lit + r, l, lit_wild);
                w += l; r += l;
                copy_match(out + w, o, m + 5);
                w += m + 5;
              }
            if (esc) break;
          }
        } else {
          while (i < n_seq && w < wlim && r < rlim) {
            uint64_t cap_w = (wlim - w) / 33;
            uint64_t cap_r = (rlim - r) / 14;
            uint64_t nb = n_seq - i;
            if (cap_w < nb) nb = cap_w;
            if (cap_r < nb) nb = cap_r;
            if (!nb) {
              uint32_t t = tok[i];
              uint64_t l = t >> 4, m = t & 15;
              if (l == 15 || m == 15) break;
              uint64_t o = rd16le(sec_c + 2 * i) + 1;
              copy_literals(out + w, lit + r, l, lit_wild);
              w += l; r += l;
              copy_match(out + w, o, m + 5);
              w += m + 5;
              i++;
              continue;
            }
            uint64_t end = i + nb;
            int esc = 0;
            for (; i < end; i++) {
              uint32_t t = tok[i];
              uint64_t l = t >> 4, m = t & 15;
              if (l == 15 || m == 15) { esc = 1; break; }
              uint64_t o = rd16le(sec_c + 2 * i) + 1;
              copy_literals(out + w, lit + r, l, lit_wild);
              w += l; r += l;
              copy_match(out + w, o, m + 5);
              w += m + 5;
            }
            if (esc) break;
          }
        }
      } else {
        // GHI 4x batch (the reference DECODE_GHI 4x shape,
        // zxc_decompress.c:469-543): one 16-byte load carries four
        // sequence words; varint escapes handled INLINE under UNLIKELY
        // with exact capacity checks and a whole-batch rollback on
        // failure (re-emission through the checked path is idempotent:
        // the output bytes are a pure function of (i, w, r, e)). Inline
        // advance per batch <= 4*(254+259) = 2052 < 2600 margin,
        // literals <= 1016 < 1100. (Round-5: widened from the 2x pair
        // batch — the round-4 GLO 4x probe failed on rollback
        // bookkeeping, but GHI's word-per-sequence format needs none.)
        const uint64_t wlimg = block_size > 2600 ? block_size - 2600 : 0;
        const uint64_t rlimg = n_lit > 1100 ? n_lit - 1100 : 0;
        while (i + 4 <= n_seq && w < wlimg && r < rlimg) {
          const uint64_t i0 = i, w0 = w, r0 = r, e0 = e;
          uint64_t wd2, wd3;
          memcpy(&wd2, sec_b + 4 * i, 8);
          memcpy(&wd3, sec_b + 4 * i + 8, 8);
          __builtin_prefetch(lit + r + 384);
          __builtin_prefetch(sec_b + 4 * i + 64);
          int fail = 0;
#pragma GCC unroll 4
          for (int k = 0; k < 4; k++) {
            uint32_t wd = (uint32_t)((k < 2 ? wd2 : wd3) >> (32 * (k & 1)));
            uint64_t l = wd >> 24, m = (wd >> 16) & 0xFF;
            uint64_t o = (wd & 0xFFFF) + 1;
            if (__builtin_expect(l == 255, 0)) {
              uint64_t v;
              int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
              if (c < 0 || r + 255 + v > rlimg || w + 255 + v > wlimg) {
                fail = 1;
                break;
              }
              e += (uint64_t)c;
              l += v;
            }
            if (__builtin_expect(m == 255, 0)) {
              uint64_t v;
              int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
              if (c < 0 || w + l + 255 + v > wlimg) {
                fail = 1;
                break;
              }
              e += (uint64_t)c;
              m += v;
            }
            copy_literals32(out + w, lit + r, l, lit_wild);
            w += l;
            r += l;
            copy_match(out + w, o, m + 5);
            w += m + 5;
          }
          if (__builtin_expect(fail, 0)) {
            i = i0; w = w0; r = r0; e = e0;
            break;
          }
          i += 4;
        }
      }
      if (i >= n_seq) break;
    }
    // checked path: one sequence (buffer edges, varint escapes, dict)
    uint64_t l, m, o;
    if (is_glo) {
      uint32_t t = tok[i];
      l = t >> 4;
      m = t & 15;
      if (l == 15) {
        uint64_t v;
        int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
        if (c < 0) return -8;
        e += (uint64_t)c;
        l += v;
      }
      if (m == 15) {
        uint64_t v;
        int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
        if (c < 0) return -8;
        e += (uint64_t)c;
        m += v;
      }
      o = (enc_off == 1) ? (uint64_t)sec_c[i] + 1 : rd16le(sec_c + 2 * i) + 1;
    } else {
      uint32_t wd;
      memcpy(&wd, sec_b + 4 * i, 4);
      l = wd >> 24;
      m = (wd >> 16) & 0xFF;
      o = (wd & 0xFFFF) + 1;
      if (l == 255) {
        uint64_t v;
        int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
        if (c < 0) return -8;
        e += (uint64_t)c;
        l += v;
      }
      if (m == 255) {
        uint64_t v;
        int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
        if (c < 0) return -8;
        e += (uint64_t)c;
        m += v;
      }
    }
    m += 5;  // MIN_MATCH
    if (r + l > n_lit) return -10;          // literal stream exhausted
    if (w + l + m > block_size) return -10; // exceeds capacity
    copy_literals(out + w, lit + r, l, lit_wild);
    w += l;
    r += l;
    if (o > w + n_dict) return -9;  // BAD_OFFSET
    uint64_t mlen = m;
    if (o > w) {  // leading bytes come from the dictionary window
      uint64_t from_dict = o - w;
      uint64_t take = from_dict < mlen ? from_dict : mlen;
      memcpy(out + w, dict + n_dict - from_dict, take);
      w += take;
      mlen -= take;
    }
    if (mlen) {
      copy_match(out + w, o, mlen);
      w += mlen;
    }
    i++;
  }
  uint64_t trailing = n_lit - r;
  if (w + trailing > block_size) return -10;
  memcpy(out + w, lit + r, trailing);
  return (int64_t)(w + trailing);
}

}  // namespace

extern "C" {

// Decode one data block payload (chunk-wrapper equivalent without the
// checksum step). out must have block_size + 64 bytes. Scratch is
// allocated per call; use zxch_decompress_frame for whole archives.
int64_t zxch_decode_block(int block_type, const uint8_t *pl, uint64_t plen,
                          uint8_t *out, uint64_t block_size,
                          const uint8_t *dict, uint64_t n_dict,
                          const uint8_t *dict_cl) {
  if (block_type == 0) {  // RAW
    if (plen > block_size) return -10;
    memcpy(out, pl, plen);
    return (int64_t)plen;
  }
  if (block_type != 1 && block_type != 2) return -13;
  uint8_t *mem = new uint8_t[3 * block_size + 64];
  DecScratch S = {mem, mem + block_size + 64, mem + 2 * block_size + 64};
  int64_t rc = decode_gnr_block(block_type == 1, pl, plen, out, block_size,
                                dict, n_dict, dict_cl, &S, 0);
  delete[] mem;
  return rc;
}

// Whole-frame decode starting after the (caller-validated) 16-byte file
// header. dst_alloc must be >= n_blocks*block_size + 64. Returns produced
// bytes or a negative ZXC error code.
int64_t zxch_decompress_frame(const uint8_t *src, uint64_t n,
                              uint64_t block_size, int has_checksum,
                              int verify, const uint8_t *dict,
                              uint64_t n_dict, const uint8_t *dict_cl,
                              uint8_t *dst, uint64_t dst_alloc) {
  if (n < 16 + 12) return -3;
  uint64_t p = 16, w_total = 0;
  uint32_t ghash = 0;
  const uint64_t tail = has_checksum ? 4 : 0;
  const uint64_t bound = 8 + block_size + 4;  // compress_block_bound
  // per-thread reused scratch (lit/tok/piv + a bounce block for tail
  // blocks without wild-copy headroom): the old per-call new[] cost a
  // 1.5-2 MB allocation + first-touch faults on every frame decode
  static thread_local uint8_t *mem = nullptr;
  static thread_local uint64_t mem_cap = 0;
  const uint64_t need = 4 * block_size + 128;
  if (need > mem_cap) {
    delete[] mem;
    mem = new uint8_t[need];
    mem_cap = need;
  }
  DecScratch S = {mem, mem + block_size + 64, mem + 2 * block_size + 64};
  uint8_t *bounce = mem + 3 * block_size + 64;  // block_size + 64 usable
  int64_t err = 0;
  int saw_eof = 0;
  while (p + 8 <= n) {
    uint8_t hdr[8];
    memcpy(hdr, src + p, 8);
    uint8_t crc = hdr[7];
    hdr[7] = 0;
    if (zxch_hash8(hdr) != crc) {
      err = -6;
      break;
    }
    uint8_t bt = hdr[0];
    uint32_t csz;
    memcpy(&csz, hdr + 3, 4);
    if (bt == 255) {  // EOF
      if (csz != 0) {
        err = -6;
        break;
      }
      saw_eof = 1;
      break;
    }
    uint64_t poff = p + 8;
    if (poff + csz + tail > n) {
      err = -3;
      break;
    }
    if (csz > bound) {
      err = -8;
      break;
    }
    const uint8_t *pl = src + poff;
    if (has_checksum) {
      uint32_t stored;
      memcpy(&stored, src + poff + csz, 4);
      if (verify) {
        ghash = ((ghash << 1) | (ghash >> 31)) ^ stored;
        if (zxch_rapidhash32(pl, csz, 0) != stored) {
          err = -7;
          break;
        }
      }
    }
    // blocks with full wild-copy headroom decode straight into dst;
    // tail blocks (an exactly-sized caller buffer has none) decode into
    // the bounce block and memcpy the exact byte count — this is what
    // lets the Python layer hand us the result PyBytes' own buffer
    // (footer-sized) instead of a scratch + whole-output copy
    const int direct = (w_total + block_size + 64 <= dst_alloc);
    uint8_t *bdst = direct ? dst + w_total : bounce;
    int payload_wild = (poff + csz + 32 <= n);
    int64_t out_n;
    if (bt == 0) {  // RAW
      if (csz > block_size || w_total + csz > dst_alloc) {
        err = -10;
        break;
      }
      memcpy(dst + w_total, pl, csz);
      out_n = csz;
    } else if (bt == 1 || bt == 2) {
      out_n = decode_gnr_block(bt == 1, pl, csz, bdst, block_size,
                               dict, n_dict, dict_cl, &S, payload_wild);
      if (out_n >= 0 && !direct) {
        if (w_total + (uint64_t)out_n > dst_alloc) {
          err = -8;  // output exceeds the footer-declared size
          break;
        }
        memcpy(dst + w_total, bounce, (size_t)out_n);
      }
    } else {
      err = -13;
      break;
    }
    if (out_n < 0) {
      err = out_n;
      break;
    }
    w_total += (uint64_t)out_n;
    p = poff + csz + tail;
  }
  if (err) return err;
  if (!saw_eof) return -3;  // missing EOF block
  uint64_t stored_size;
  uint32_t stored_hash;
  memcpy(&stored_size, src + n - 12, 8);
  memcpy(&stored_hash, src + n - 4, 4);
  if (stored_size != w_total) return -8;  // footer size mismatch
  if (verify && stored_hash != ghash) return -7;
  return (int64_t)w_total;
}


// Worker scratch pool for the MT frame decode: fork-join workers are
// born and die per call, so thread_local reuse (the T=1 path's trick)
// does not apply — a fresh 2 MB new[] per worker per call would re-pay
// mmap + first-touch page faults inside the parallel region every
// frame. Buffers are pooled process-wide and only ever grow to the
// high-water concurrency (bounded: pool keeps at most 16 entries).
static std::mutex g_dec_scratch_mu;
struct DecScratchSlot {
  uint64_t cap;
  uint8_t *ptr;
};
static std::vector<DecScratchSlot> g_dec_scratch_pool;

static uint8_t *dec_scratch_acquire(uint64_t need, uint64_t *cap_out) {
  {
    std::lock_guard<std::mutex> g(g_dec_scratch_mu);
    for (size_t k = 0; k < g_dec_scratch_pool.size(); k++) {
      if (g_dec_scratch_pool[k].cap >= need) {
        uint8_t *p = g_dec_scratch_pool[k].ptr;
        // hand back the TRUE capacity: releasing at `need` would
        // permanently shrink a larger pooled slot (review finding)
        *cap_out = g_dec_scratch_pool[k].cap;
        g_dec_scratch_pool.erase(g_dec_scratch_pool.begin() + k);
        return p;
      }
    }
  }
  *cap_out = need;
  return new uint8_t[need];
}

static void dec_scratch_release(uint8_t *p, uint64_t cap) {
  std::lock_guard<std::mutex> g(g_dec_scratch_mu);
  if (g_dec_scratch_pool.size() >= 16) {
    delete[] p;
    return;
  }
  g_dec_scratch_pool.push_back({cap, p});
}

// Multi-threaded whole-frame decode (the reference decodes archives
// through its pthread stream engine, zxc_driver.c:639-1035 — N workers
// with thread-local contexts and an ordering writer; our blocks decode
// to deterministic offsets i*block_size, so the "writer" degenerates to
// writing in place and only a fork-join pool remains, the same shape as
// the reference's seekable MT range decode, zxc_seekable.c:1005-1123).
//
// Semantics are bit-identical to zxch_decompress_frame, including error
// codes on corrupt archives: any frame-walk error or any block shape
// that breaks the i*block_size output mapping (a non-final block that
// does not decode to exactly block_size — our encoder and the reference
// never emit one, but a crafted archive may) falls back to the
// sequential walk, which is the semantics oracle.
int64_t zxch_decompress_frame_mt(const uint8_t *src, uint64_t n,
                                 uint64_t block_size, int has_checksum,
                                 int verify, const uint8_t *dict,
                                 uint64_t n_dict, const uint8_t *dict_cl,
                                 uint8_t *dst, uint64_t dst_alloc,
                                 int threads) {
  if (threads <= 1 || block_size == 0)
    return zxch_decompress_frame(src, n, block_size, has_checksum, verify,
                                 dict, n_dict, dict_cl, dst, dst_alloc);
  if (n < 16 + 12) return -3;
  const uint64_t bound = 8 + block_size + 4;
  const uint64_t tail = has_checksum ? 4 : 0;
  uint64_t stored_size;
  uint32_t stored_hash;
  memcpy(&stored_size, src + n - 12, 8);
  memcpy(&stored_hash, src + n - 4, 4);
  // size the block table from the footer, NOT n/8 (that upper bound is
  // ~n/8 entries and its zero-fill alone would cost more than the
  // decode). A valid offset-mapped frame has ceil(size/bs) blocks;
  // anything longer (e.g. empty RAW blocks) overflows the walk and
  // takes the sequential fallback, which owns those semantics anyway.
  if (stored_size > ((uint64_t)1 << 62))
    return zxch_decompress_frame(src, n, block_size, has_checksum, verify,
                                 dict, n_dict, dict_cl, dst, dst_alloc);
  uint64_t max_blocks = stored_size / block_size + 16;
  std::unique_ptr<uint64_t[]> pos(new uint64_t[max_blocks]);
  std::unique_ptr<uint64_t[]> comp(new uint64_t[max_blocks]);
  std::unique_ptr<uint8_t[]> typ(new uint8_t[max_blocks]);
  uint64_t eof = 0;
  int64_t nb = zxch_walk_frame(src, n, has_checksum, bound, 16, pos.get(),
                               typ.get(), comp.get(), max_blocks, &eof);
  if (nb < 0)  // corrupt walk / overflow: sequential owns the semantics
    return zxch_decompress_frame(src, n, block_size, has_checksum, verify,
                                 dict, n_dict, dict_cl, dst, dst_alloc);
  // the offset mapping requires every non-final block to produce exactly
  // block_size; the footer can reject most violations upfront
  if (nb == 0) {
    if (stored_size != 0) return -8;
    if (verify && stored_hash != 0) return -7;  // sequential: ghash==0
    return 0;
  }
  if (stored_size > (uint64_t)nb * block_size ||
      (nb > 1 && stored_size <= (uint64_t)(nb - 1) * block_size))
    return zxch_decompress_frame(src, n, block_size, has_checksum, verify,
                                 dict, n_dict, dict_cl, dst, dst_alloc);
  int nt = threads;
  if ((int64_t)nt > nb) nt = (int)nb;
  if (nt > 64) nt = 64;
  // static contiguous ranges: a block's wild copies write up to 64 B of
  // slack past its logical end, which the SEQUENTIAL walk overwrites
  // when it decodes the next block. Interleaved block claiming lets a
  // neighbor decode first and then get its first bytes trampled by that
  // slack, so each worker owns a contiguous range, decodes it in order
  // (its own slack is overwritten by its own next block), and bounces
  // its FINAL block through scratch — no worker ever stores outside its
  // own output region.
  std::atomic<int> had_err(0);
  std::atomic<int> need_seq(0);  // offset-mapping/capacity anomaly
  std::vector<int64_t> out_n((size_t)nb, 0);
  std::vector<int64_t> berr((size_t)nb, 0);
  const uint64_t per = ((uint64_t)nb + nt - 1) / nt;
  const uint64_t scratch_need = 4 * block_size + 128;
  auto range_worker = [&](uint64_t b0, uint64_t b1) {
    uint64_t scratch_cap = 0;
    uint8_t *mem = dec_scratch_acquire(scratch_need, &scratch_cap);
    DecScratch S = {mem, mem + block_size + 64, mem + 2 * block_size + 64};
    uint8_t *bounce = mem + 3 * block_size + 64;
    for (uint64_t i = b0; i < b1; i++) {
      // no cross-range early bail: each worker walks its range in order
      // and stops only on ITS error, so the post-join min-index scan
      // returns exactly the sequential walk's first error
      const uint64_t poff = pos[i] + 8, csz = comp[i];
      const uint8_t *pl = src + poff;
      const uint8_t bt = typ[i];
      int64_t rc;
      if (has_checksum && verify) {
        uint32_t stored;
        memcpy(&stored, src + poff + csz, 4);
        if (zxch_rapidhash32(pl, csz, 0) != stored) {
          berr[i] = -7;
          had_err.store(1, std::memory_order_relaxed);
          break;
        }
      }
      const uint64_t off = i * block_size;
      const int direct =
          (i + 1 < b1) && (off + block_size + 64 <= dst_alloc);
      uint8_t *bdst = direct ? dst + off : bounce;
      const int payload_wild = (poff + csz + 32 <= n);
      if (bt == 0) {  // RAW
        if (csz > block_size) {
          rc = -10;  // position-independent: sequential rejects too
        } else if (off + csz > dst_alloc) {
          // only reachable when an EARLIER short block shifted the
          // sequential write cursor below i*block_size — the
          // sequential walk (w_total-relative bounds) may accept this
          // archive, so it owns the semantics (review finding)
          need_seq.store(1, std::memory_order_relaxed);
          break;
        } else {
          rc = (int64_t)csz;
          memcpy(dst + off, pl, csz);
        }
      } else if (bt == 1 || bt == 2) {
        rc = decode_gnr_block(bt == 1, pl, csz, bdst, block_size, dict,
                              n_dict, dict_cl, &S, payload_wild);
        if (rc >= 0 && !direct) {
          if (off + (uint64_t)rc > dst_alloc) {
            // same offset-mapping anomaly as the RAW case above
            need_seq.store(1, std::memory_order_relaxed);
            break;
          }
          memcpy(dst + off, bounce, (size_t)rc);
        }
      } else {
        rc = -13;
      }
      if (rc < 0) {
        berr[i] = rc;
        had_err.store(1, std::memory_order_relaxed);
        break;
      }
      out_n[i] = rc;
    }
    dec_scratch_release(mem, scratch_cap);
  };
  work_pool().run(nt, [&](int t) {
    uint64_t b0 = (uint64_t)t * per;
    uint64_t b1 = b0 + per;
    if (b0 > (uint64_t)nb) b0 = (uint64_t)nb;
    if (b1 > (uint64_t)nb) b1 = (uint64_t)nb;
    range_worker(b0, b1);
  });
  if (need_seq.load())
    return zxch_decompress_frame(src, n, block_size, has_checksum, verify,
                                 dict, n_dict, dict_cl, dst, dst_alloc);
  if (had_err.load()) {
    // lowest failing block == the sequential walk's first error (all
    // blocks before it decoded clean in their owning ranges)
    for (int64_t i = 0; i < nb; i++)
      if (berr[(size_t)i] < 0) return berr[(size_t)i];
  }
  uint64_t w_total = 0;
  for (int64_t i = 0; i < nb; i++) {
    if (i + 1 < nb && (uint64_t)out_n[i] != block_size)
      // offset mapping violated but every block decoded: the sequential
      // walk is the semantics oracle (concatenated, not strided)
      return zxch_decompress_frame(src, n, block_size, has_checksum,
                                   verify, dict, n_dict, dict_cl, dst,
                                   dst_alloc);
    w_total += (uint64_t)out_n[i];
  }
  if (stored_size != w_total) return -8;
  if (verify) {
    // sequential checks `stored_hash != ghash` UNCONDITIONALLY under
    // verify; ghash is 0 when the frame carries no checksums
    uint32_t ghash = 0;
    if (has_checksum)
      for (int64_t i = 0; i < nb; i++) {
        uint32_t stored;
        memcpy(&stored, src + pos[i] + 8 + comp[i], 4);
        ghash = ((ghash << 1) | (ghash >> 31)) ^ stored;
      }
    if (stored_hash != ghash) return -7;
  }
  (void)tail;
  (void)eof;
  return (int64_t)w_total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Simple one-call ABI for language bindings (Node/Go/WASM wrappers).
//
// These wrap the full-frame codec behind the kind of surface the
// reference exposes to its wrappers (zxc_compress / zxc_decompress /
// zxc_get_decompressed_size, include/zxc_buffer.h): header parse and
// validation included, no Python-side orchestration required.
// ---------------------------------------------------------------------------

extern "C" {

// Parse + validate the 16-byte file header. Returns 0 and fills
// (block_size, has_checksum, dict_id) or a negative ZXC error.
int zxch_frame_info(const uint8_t *src, uint64_t n, uint64_t *block_size,
                    int *has_checksum, uint32_t *dict_id) {
  if (n < 16 + 12) return -3;
  uint32_t magic;
  memcpy(&magic, src, 4);
  if (magic != 0x9CB02EF5u) return -4;
  if (src[4] != 7) return -5;  // FORMAT_VERSION
  uint8_t tmp[16];
  memcpy(tmp, src, 16);
  tmp[14] = tmp[15] = 0;
  uint16_t stored;
  memcpy(&stored, src + 14, 2);
  if (stored != zxch_hash16(tmp) || (src[6] & 0x0F) != 0) return -6;
  uint8_t code = src[5];
  if (code < 12 || code > 21) return -14;  // BAD_BLOCK_SIZE
  *block_size = 1ull << code;
  *has_checksum = (src[6] & 0x80) != 0;
  *dict_id = 0;
  if (src[6] & 0x40) memcpy(dict_id, src + 7, 4);  // FLAG_HAS_DICTIONARY
  return 0;
}

// Footer-declared decompressed size (after header validation); negative
// ZXC error when the frame is malformed.
int64_t zxch_get_decompressed_size(const uint8_t *src, uint64_t n) {
  uint64_t bs;
  int ck;
  uint32_t did;
  int rc = zxch_frame_info(src, n, &bs, &ck, &did);
  if (rc) return rc;
  uint64_t size;
  memcpy(&size, src + n - 12, 8);
  if (size > (int64_t)1 << 62) return -8;
  return (int64_t)size;
}

// One-call frame decode: header parse, frame walk (sizes the logical
// output), decode. dst_cap must be >= zxch_get_decompressed_size() +
// block_size + 64 (wild-copy slack; zxch_simple_decompress_bound gives
// this). dict/dict_cl may be NULL (non-dictionary frames).
int64_t zxch_simple_decompress_mt(const uint8_t *src, uint64_t n,
                                  uint8_t *dst, uint64_t dst_cap,
                                  const uint8_t *dict, uint64_t n_dict,
                                  const uint8_t *dict_cl, int verify,
                                  int threads);
int64_t zxch_simple_compress_mt(const uint8_t *data, uint64_t n, int level,
                                uint64_t block_size, int checksum,
                                int seekable, uint8_t *dst,
                                uint64_t dst_cap, int threads);

int64_t zxch_simple_decompress(const uint8_t *src, uint64_t n, uint8_t *dst,
                               uint64_t dst_cap, const uint8_t *dict,
                               uint64_t n_dict, const uint8_t *dict_cl,
                               int verify) {
  // the _mt variant at threads=1 IS the sequential path (shared
  // preamble; review finding: the two bodies had drifted into copies)
  return zxch_simple_decompress_mt(src, n, dst, dst_cap, dict, n_dict,
                                   dict_cl, verify, 1);
}

// zxch_simple_decompress over the MT frame decode (threads <= 1 is the
// sequential walk; output and error codes identical at every count).
int64_t zxch_simple_decompress_mt(const uint8_t *src, uint64_t n,
                                  uint8_t *dst, uint64_t dst_cap,
                                  const uint8_t *dict, uint64_t n_dict,
                                  const uint8_t *dict_cl, int verify,
                                  int threads) {
  uint64_t bs;
  int ck;
  uint32_t did;
  int rc = zxch_frame_info(src, n, &bs, &ck, &did);
  if (rc) return rc;
  if (did != 0 && dict == nullptr) return -15;  // DICT_REQUIRED
  uint64_t max_blocks = n / 8 + 2;
  uint64_t *pos = new uint64_t[max_blocks];
  uint64_t *comp = new uint64_t[max_blocks];
  uint8_t *typ = new uint8_t[max_blocks];
  uint64_t eof = 0;
  int64_t nb = zxch_walk_frame(src, n, ck, 8 + bs + 4, 16, pos, typ, comp,
                               max_blocks, &eof);
  delete[] pos;
  delete[] comp;
  delete[] typ;
  if (nb < 0) return nb;
  if ((uint64_t)nb * bs + 64 > dst_cap) return -2;  // DST_TOO_SMALL
  return zxch_decompress_frame_mt(src, n, bs, ck, verify, dict, n_dict,
                                  dict_cl, dst, dst_cap, threads);
}

// Safe capacity for zxch_simple_decompress's dst buffer.
int64_t zxch_simple_decompress_bound(const uint8_t *src, uint64_t n) {
  uint64_t bs;
  int ck;
  uint32_t did;
  int rc = zxch_frame_info(src, n, &bs, &ck, &did);
  if (rc) return rc;
  uint64_t max_blocks = n / 8 + 2;
  uint64_t *pos = new uint64_t[max_blocks];
  uint64_t *comp = new uint64_t[max_blocks];
  uint8_t *typ = new uint8_t[max_blocks];
  uint64_t eof = 0;
  int64_t nb = zxch_walk_frame(src, n, ck, 8 + bs + 4, 16, pos, typ, comp,
                               max_blocks, &eof);
  delete[] pos;
  delete[] comp;
  delete[] typ;
  if (nb < 0) return nb;
  return (int64_t)((uint64_t)nb * bs + 64);
}

// Worst-case archive size for zxch_simple_compress (RAW fallback bound).
int64_t zxch_compress_bound(uint64_t n, uint64_t block_size) {
  if (block_size == 0) block_size = 512 * 1024;
  uint64_t nb = (n + block_size - 1) / block_size;
  return (int64_t)(16 + 12 + n + nb * (8 + 4 + 64) + n / 4 + 4 * nb + 4096);
}

// One-call frame encode at `level` (1-7; levels 6-7 run the native
// archival pipeline — DP optimal parse + Huffman literal/token
// candidates). block_size 0 selects the 512 KB default.
int64_t zxch_simple_compress(const uint8_t *data, uint64_t n, int level,
                             uint64_t block_size, int checksum, int seekable,
                             uint8_t *dst, uint64_t dst_cap) {
  // the _mt variant at threads=1 IS the sequential encoder; the
  // level-param table lives in one place (review finding)
  return zxch_simple_compress_mt(data, n, level, block_size, checksum,
                                 seekable, dst, dst_cap, 1);
}

// zxch_simple_compress over the MT frame encode (same bytes at every
// thread count; threads <= 1 or a single-block input is sequential).
int64_t zxch_simple_compress_mt(const uint8_t *data, uint64_t n, int level,
                                uint64_t block_size, int checksum,
                                int seekable, uint8_t *dst,
                                uint64_t dst_cap, int threads) {
  if (level < 1) level = 1;
  if (level > 7) level = 7;
  if (block_size == 0) block_size = 512 * 1024;
  if (block_size & (block_size - 1)) return -14;
  int code = 0;
  while ((1ull << code) < block_size) code++;
  if (code < 12 || code > 21) return -14;
  struct Par { int probes, lazy, suff, sb, ss, cover, min_emit; };
  static const Par tab[7] = {{2, 0, 16, 1, 4, 4, 5},  {2, 0, 24, 1, 4, 4, 5},
                             {5, 0, 32, 1, 5, 4, 5},  {8, 0, 64, 1, 0, 2, 5},
                             {24, 1, 128, 1, 0, 2, 5}, {64, 1, 0, 1, 0, 1, 5},
                             {192, 1, 0, 1, 0, 1, 5}};
  Par p = tab[level - 1];
  return zxch_compress_frame_mt(data, n, level, p.probes, p.lazy, p.suff,
                                p.sb, p.ss, p.cover, p.min_emit,
                                block_size, code, checksum, seekable,
                                nullptr, 0, nullptr, 0, dst, dst_cap,
                                threads);
}

// 32-bit id binding a (content, table) pair (FORMAT.md section 12;
// dictionary.py dict_id): the content checksum seeds the 128-byte
// packed-table checksum. huf may be NULL (content-only dictionaries).
uint32_t zxch_dict_id(const uint8_t *content, uint64_t n,
                      const uint8_t *huf) {
  if (!content || n == 0) return 0;
  uint32_t base = zxch_rapidhash32(content, (size_t)n, 0);
  if (!huf) return base;
  uint64_t h = zxch_rapidhash64(huf, 128, base);
  return (uint32_t)((h ^ (h >> 32)) & 0xFFFFFFFFu);
}

// zxch_simple_compress with a dictionary: `dict` becomes the parse
// window prefix of every block; `dict_cl256` (256 per-symbol code
// lengths, same convention as zxch_simple_decompress, or NULL)
// additionally enables the shared-table literal candidate. The dict id
// is computed (over the packed 128-byte table form, matching .zxd /
// zxc_dict.c) and stamped into the frame header; decode with
// zxch_simple_decompress passing the same dict/table.
int64_t zxch_simple_compress_dict(const uint8_t *data, uint64_t n,
                                  int level, uint64_t block_size,
                                  int checksum, int seekable,
                                  const uint8_t *dict, uint64_t n_dict,
                                  const uint8_t *dict_cl256,
                                  uint8_t *dst, uint64_t dst_cap) {
  if (level < 1) level = 1;
  if (level > 7) level = 7;
  if (block_size == 0) block_size = 512 * 1024;
  if (block_size & (block_size - 1)) return -14;
  if (n_dict > (1ull << 20)) return -17;  // DICT_TOO_LARGE (1 MiB cap)
  int code = 0;
  while ((1ull << code) < block_size) code++;
  if (code < 12 || code > 21) return -14;
  struct Par { int probes, lazy, suff, sb, ss, cover, min_emit; };
  static const Par tab[7] = {{2, 0, 16, 1, 4, 4, 5},  {2, 0, 24, 1, 4, 4, 5},
                             {5, 0, 32, 1, 5, 4, 5},  {8, 0, 64, 1, 0, 2, 5},
                             {24, 1, 128, 1, 0, 2, 5}, {64, 1, 0, 1, 0, 1, 5},
                             {192, 1, 0, 1, 0, 1, 5}};
  Par p = tab[level - 1];
  uint8_t packed[128];
  const uint8_t *huf = nullptr;
  if (dict_cl256) {
    for (int i = 0; i < 128; i++)
      packed[i] = (uint8_t)((dict_cl256[2 * i] & 0x0F)
                            | (dict_cl256[2 * i + 1] << 4));
    huf = packed;
  }
  const uint8_t *dcl = dict_cl256;
  uint32_t did = zxch_dict_id(dict, n_dict, huf);
  return zxch_compress_frame(data, n, level, p.probes, p.lazy, p.suff,
                             p.sb, p.ss, p.cover, p.min_emit,
                             block_size, code, checksum, seekable,
                             dict, n_dict, dcl, did, dst, dst_cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seekable range decode for the simple ABI (zxc_seekable_decompress_range
// parity, zxc_seekable.c:701-825): backward SEK detection, decode only the
// blocks overlapping [offset, offset+length), copy the slice.
// ---------------------------------------------------------------------------

extern "C" {

int64_t zxch_seekable_range(const uint8_t *src, uint64_t n, uint64_t offset,
                            uint64_t length, uint8_t *dst, uint64_t dst_cap,
                            const uint8_t *dict, uint64_t n_dict,
                            const uint8_t *dict_cl) {
  uint64_t bs;
  int ck;
  uint32_t did;
  int rc = zxch_frame_info(src, n, &bs, &ck, &did);
  if (rc) return rc;
  uint64_t dsize;
  memcpy(&dsize, src + n - 12, 8);
  if (offset >= dsize || length == 0) return 0;
  if (offset + length > dsize) length = dsize - offset;
  if (length > dst_cap) return -2;
  uint64_t nb = (dsize + bs - 1) / bs;
  if (nb == 0) return 0;
  uint64_t sek_size = 8 + nb * 4;
  if (n < 12 + sek_size + 16) return -8;
  uint64_t sek_pos = n - 12 - sek_size;
  uint8_t hdr[8];
  memcpy(hdr, src + sek_pos, 8);
  uint8_t crc = hdr[7];
  hdr[7] = 0;
  if (zxch_hash8(hdr) != crc || hdr[0] != 254) return -8;  // no SEK table
  uint32_t body;
  memcpy(&body, hdr + 3, 4);
  if (body != nb * 4) return -8;
  // cumulative compressed offsets (entries span header+payload+checksum)
  uint64_t first = offset / bs, last = (offset + length - 1) / bs;
  if (last >= nb) return -8;
  uint64_t cpos = 16;
  for (uint64_t b = 0; b < first; b++) {
    uint32_t e;
    memcpy(&e, src + sek_pos + 8 + 4 * b, 4);
    cpos += e;
  }
  uint8_t *tmp = new uint8_t[bs + 64];
  uint64_t w = 0;
  int64_t err = 0;
  for (uint64_t b = first; b <= last; b++) {
    uint32_t e;
    memcpy(&e, src + sek_pos + 8 + 4 * b, 4);
    if (cpos + e > n) { err = -3; break; }
    // block header
    uint8_t bh[8];
    memcpy(bh, src + cpos, 8);
    uint8_t bcrc = bh[7];
    bh[7] = 0;
    if (zxch_hash8(bh) != bcrc) { err = -6; break; }
    uint8_t bt = bh[0];
    uint32_t csz;
    memcpy(&csz, bh + 3, 4);
    if (8 + csz + (ck ? 4u : 0u) != e) { err = -8; break; }
    int64_t out_n = zxch_decode_block(bt, src + cpos + 8, csz, tmp, bs,
                                      dict, n_dict, dict_cl);
    if (out_n < 0) { err = out_n; break; }
    uint64_t blk_start = b * bs;
    uint64_t lo = offset > blk_start ? offset - blk_start : 0;
    uint64_t hi = offset + length - blk_start;
    if (hi > (uint64_t)out_n) hi = (uint64_t)out_n;
    if (lo < hi) {
      memcpy(dst + w, tmp + lo, hi - lo);
      w += hi - lo;
    }
    cpos += e;
  }
  delete[] tmp;
  return err ? err : (int64_t)w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// v9 lane-op emission: split device_pure pieces into (32,128)-tile batched
// lane ops for the per-sublane Pallas decode kernel.
//
// Each op covers lanes [s, e) of ONE 128-byte output row and reads from
// ONE 128-byte lit_full row at a fixed lane offset (roll), so the kernel
// can process 32 ops as one (32,128) tile: one take_along_axis shuffle +
// one mask/select, with only the 32 source-row fetches scalar-issued.
// Ops are layered per tile: batch b of tile t holds the b-th op of every
// output row (sublane) in that tile, padded with s==e (no-op) entries.
// ---------------------------------------------------------------------------

extern "C" {

// rows/roll/s/e: caller arrays of capacity max_batches*32 (i32).
// tile_start: capacity n_tiles+1 where n_tiles = ceil(total/4096).
// Returns n_batches, or -10 when a cap is exceeded.
int64_t zxch_lane_ops(const int32_t *po, const int32_t *pc,
                      const int32_t *ps, const int32_t *pk, uint64_t n,
                      int64_t total, int32_t *rows, int32_t *roll,
                      int32_t *s_out, int32_t *e_out, int32_t *tile_start,
                      uint64_t max_batches) {
  if (total <= 0) {
    tile_start[0] = 0;
    return 0;
  }
  const int64_t n_rows = (total + 127) >> 7;
  const int64_t n_tiles = (n_rows + 31) >> 5;
  // pass 1: split pieces into per-row op lists
  struct Op { int32_t row, src_row, roll, s, e; };
  static thread_local Op *ops = nullptr;
  static thread_local uint64_t ops_cap = 0;
  static thread_local int32_t *row_cnt = nullptr;
  static thread_local uint64_t row_cap = 0;
  if ((uint64_t)n_rows > row_cap) {
    delete[] row_cnt;
    row_cap = n_rows * 2;
    row_cnt = new int32_t[row_cap];
  }
  memset(row_cnt, 0, n_rows * sizeof(int32_t));
  uint64_t nops = 0;
  for (uint64_t j = 0; j < n; j++) {
    int64_t q = po[j];
    int64_t end = (j + 1 < n) ? po[j + 1] : total;
    int64_t c = pc[j], sd = ps[j], k = pk[j];
    while (q < end) {
      int64_t row = q >> 7;
      int64_t s = q & 127;
      int64_t row_end = (row + 1) << 7;
      if (row_end > end) row_end = end;
      int64_t src = (k >= ZXCH_KBIG) ? c + (q - sd) : c + ((q - sd) % k);
      int64_t src_lane = src & 127;
      int64_t len = row_end - q;
      if (len > 128 - src_lane) len = 128 - src_lane;
      if (nops >= ops_cap) {
        uint64_t nc = ops_cap ? ops_cap * 2 : 4096;
        Op *no = new Op[nc];
        memcpy(no, ops, nops * sizeof(Op));
        delete[] ops;
        ops = no;
        ops_cap = nc;
      }
      ops[nops++] = {(int32_t)row, (int32_t)(src >> 7),
                     (int32_t)((src_lane - s) & 127), (int32_t)s,
                     (int32_t)(s + len)};
      row_cnt[row]++;
      q += len;
    }
  }
  // pass 2: layered placement. Ops arrive sorted by output position, so
  // per-row op order is already layer order; compute per-tile layer
  // counts and batch offsets, then scatter.
  static thread_local int32_t *row_fill = nullptr;
  static thread_local uint64_t fill_cap = 0;
  if ((uint64_t)n_rows > fill_cap) {
    delete[] row_fill;
    fill_cap = n_rows * 2;
    row_fill = new int32_t[fill_cap];
  }
  memset(row_fill, 0, n_rows * sizeof(int32_t));
  uint64_t nb = 0;
  for (int64_t t = 0; t < n_tiles; t++) {
    tile_start[t] = (int32_t)nb;
    int32_t layers = 0;
    int64_t r0 = t << 5;
    int64_t r1 = r0 + 32 < n_rows ? r0 + 32 : n_rows;
    for (int64_t r = r0; r < r1; r++)
      if (row_cnt[r] > layers) layers = row_cnt[r];
    layers = (layers + 3) & ~3;  // pad to quads: the kernel unrolls 4x
    nb += (uint64_t)layers;
    if (nb > max_batches) return -10;
  }
  tile_start[n_tiles] = (int32_t)nb;
  // initialize pads: src_row 0, roll 0, s=e=0 (masked no-op)
  memset(rows, 0, nb * 32 * sizeof(int32_t));
  memset(roll, 0, nb * 32 * sizeof(int32_t));
  memset(s_out, 0, nb * 32 * sizeof(int32_t));
  memset(e_out, 0, nb * 32 * sizeof(int32_t));
  for (uint64_t i = 0; i < nops; i++) {
    const Op &o = ops[i];
    int64_t tile = o.row >> 5;
    int64_t sub = o.row & 31;
    int64_t b = tile_start[tile] + row_fill[o.row]++;
    int64_t slot = b * 32 + sub;
    rows[slot] = o.src_row;
    roll[slot] = o.roll;
    s_out[slot] = o.s;
    e_out[slot] = o.e;
  }
  return (int64_t)nb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused v19 dispatch prep: one call per block, payload -> packed device
// control arrays.
//
// This is the host half of the END-TO-END device decode pipeline. It fuses
// what rounds 1-2 ran as four passes with Python/NumPy glue between them
// (section parse -> entropy literal decode -> zxch_resolve_pieces ->
// zxch_lane_ops -> pack_blocks_v19-in-NumPy) into a single cache-hot walk
// that writes the v19 kernel's control slices directly:
//
//   qs    (NST+1,)        per-128-row-supertile quad prefix
//   qbase (MAXQ,)         per-quad 16-aligned source-window base row
//   pctrl (K*NG32, 128)   per-slot packed control, one plane per sub-op
//   tq    (MAXQ, 128) u8  per-slot target rows (tgt < 128)
//   lit8  (RLP, 128)      dict ++ literals ++ resolver-materialized bytes
//
// Layouts are BYTE-IDENTICAL to ops/pallas_decode.pack_blocks_v19 (asserted
// by tests/test_device_pipeline.py): the NumPy packer's stable argsort by
// key = src_row*128 + tgt is reproduced by a counting sort over src_row —
// lane ops are emitted in output order, which within one src_row bucket is
// exactly ascending (tgt, lane), so stable-counting == stable-argsort.
// Supertiles complete monotonically (pieces are emitted in output order),
// so each one is sorted, slot-grouped, quad-chunked and scattered while
// still in cache.
//
// Behavior contract: the reference's one-call hot path
// (zxc_decompress.c:680-1045 section parse + literal decode + sequences,
// dispatched per block from zxc_dispatch.c:856-1055); here the sequence
// copies move to the TPU and this call emits their control stream instead.
// ---------------------------------------------------------------------------

namespace {

struct PrepTL {  // per-thread scratch, grown on demand
  uint8_t *tok = nullptr; uint64_t tok_cap = 0;
  uint8_t *piv = nullptr; uint64_t piv_cap = 0;
  int32_t *ll = nullptr, *ml = nullptr, *off = nullptr; uint64_t seq_cap = 0;
  int32_t *po = nullptr, *pc = nullptr, *ps = nullptr, *pk = nullptr;
  uint64_t piece_cap = 0;
  // per-supertile op bucket (row, src_row, roll, s, e packed per op)
  int32_t *ops = nullptr; uint64_t ops_cap = 0;
  int32_t *ops_sorted = nullptr;
  // slot arrays (per supertile)
  int32_t *ssrc = nullptr, *stgt = nullptr, *sctl = nullptr;  // sctl K*3 per slot
  uint64_t slot_cap = 0;
  int32_t *counts = nullptr; uint64_t counts_cap = 0;
};

// growth PRESERVES contents: the lane-op bucket grows mid-supertile with
// live entries (the first cut dropped them and read uninitialized memory)
inline void grow_i32(int32_t **p, uint64_t *cap, uint64_t need) {
  if (need <= *cap) return;
  uint64_t nc = *cap ? *cap : 4096;
  while (nc < need) nc *= 2;
  int32_t *np_ = new int32_t[nc];
  if (*p) memcpy(np_, *p, *cap * sizeof(int32_t));
  delete[] *p;
  *p = np_;
  *cap = nc;
}

inline void grow_u8(uint8_t **p, uint64_t *cap, uint64_t need) {
  if (need <= *cap) return;
  uint64_t nc = *cap ? *cap : 4096;
  while (nc < need) nc *= 2;
  uint8_t *np_ = new uint8_t[nc];
  if (*p) memcpy(np_, *p, *cap);
  delete[] *p;
  *p = np_;
  *cap = nc;
}


// Parsed GLO/GHI section table (zxc_internal.h block sub-header layout).
struct SecView {
  int is_glo;
  uint32_t n_seq;
  uint8_t enc_lit, enc_tok, enc_off;
  uint64_t sz[4], raw[4];
  const uint8_t *sec_lit, *sec_b, *sec_c, *sec_ext;
  uint64_t sz_ext;
};

static int parse_sections(const uint8_t *pl, uint64_t plen, int block_type,
                          uint64_t block_size, SecView *v) {
  v->is_glo = block_type == 1;
  const int n_sec = v->is_glo ? 4 : 3;
  const uint64_t HDR = 16 + 8u * n_sec;
  if (plen < HDR) return -6;
  memcpy(&v->n_seq, pl, 4);
  v->enc_lit = pl[8];
  v->enc_tok = pl[9];
  v->enc_off = pl[11];
  v->sz[3] = v->raw[3] = 0;
  uint64_t tile = HDR;
  for (int k = 0; k < n_sec; k++) {
    uint64_t d;
    memcpy(&d, pl + 16 + 8 * k, 8);
    v->sz[k] = d & 0xFFFFFFFFu;
    v->raw[k] = d >> 32;
    tile += v->sz[k];
  }
  if (tile != plen) return -8;
  v->sec_lit = pl + HDR;
  v->sec_b = v->sec_lit + v->sz[0];
  v->sec_c = v->sec_b + v->sz[1];
  v->sec_ext = v->is_glo ? v->sec_c + v->sz[2] : v->sec_c;
  v->sz_ext = v->is_glo ? v->sz[3] : v->sz[2];
  if (v->n_seq > block_size / 5 + 1) return -8;
  return 0;
}

// Decode the literal section into lit (RLE / inline-Huffman / shared
// dict table / raw), shared by the full prep and the hint-replay loader.
// Returns 0, or a negative error; on -10 (*need_rows) holds the litrows
// lower bound for the caller's resize path.
static int64_t decode_block_literals(const SecView &v, uint64_t block_size,
                                     const uint8_t *dict_cl, uint8_t *lit,
                                     uint64_t n_dict, uint64_t lit_cap,
                                     PrepTL &T, uint64_t *n_lit_out,
                                     int64_t *need_rows) {
  if (!v.is_glo || v.enc_lit == 0) {
    uint64_t n_lit = v.sz[0];
    if (n_dict + n_lit + 64 > lit_cap) {
      *need_rows = (int64_t)((n_dict + n_lit + 64 + 127) / 128);
      return -10;
    }
    memcpy(lit, v.sec_lit, n_lit);
    *n_lit_out = n_lit;
    return 0;
  }
  uint64_t rl = v.raw[0];
  if (rl > block_size) return -8;
  if (n_dict + rl + 64 > lit_cap) {
    *need_rows = (int64_t)((n_dict + rl + 64 + 127) / 128);
    return -10;
  }
  grow_u8(&T.piv, &T.piv_cap, block_size + 64);
  *n_lit_out = rl;
  if (v.enc_lit == 1) {  // RLE
    if (rl) {
      int rc = zxch_rle_decode(v.sec_lit, v.sz[0], lit, rl);
      if (rc) return rc;
    }
  } else if (v.enc_lit == 2) {  // Huffman, inline lengths header
    if (rl) {
      if (v.sz[0] < 128) return -8;
      uint8_t cl[256];
      if (unpack_cl(v.sec_lit, cl)) return -8;
      int rc = zxch_pivco_decode_s(v.sec_lit + 128, v.sz[0] - 128, cl, rl,
                                   lit, T.piv);
      if (rc) return rc;
    }
  } else if (v.enc_lit == 3) {  // shared dictionary table
    if (!dict_cl) return -15;
    if (rl) {
      int rc = zxch_pivco_decode_s(v.sec_lit, v.sz[0], dict_cl, rl, lit,
                                   T.piv);
      if (rc) return rc;
    }
  } else {
    return -8;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns the block's decoded size >= 0, or a negative ZXC error code
// (-10 also covers "MAXQ/RLP too small": *out_nq / *out_maxrow /
// *out_litrows hold best-known lower bounds so the caller can resize).
// Requires block_size % 16384 == 0 (the v19 supertile contract).
static int64_t v19_prep_block_impl(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    int K, int quad_align,
    int32_t *qs, int32_t *qbase, int32_t *pctrl, uint8_t *tq, uint8_t *lit8,
    int64_t MAXQ, int64_t NG32, int64_t RLP,
    int64_t *out_nq, int64_t *out_maxrow, int64_t *out_litrows,
    int32_t *plan, int64_t plan_cap, int64_t *out_nplan,
    int64_t *out_litlen, int self_ref = 0) {
  // self_ref = the v26 unified-window contract: KOUT pieces' sources
  // pack as scratch rows RLP + out_row (the kernel's window is
  // [lit8 rows 0..RLP) ++ decoded tiles [RLP, RLP+NR)); lit8 then holds
  // literals + patterns only — materialization for earlier-supertile
  // sources disappears from both host prep and H2D.
  if (block_size % 16384 || K < 1 || K > 4) return -1;
  const int64_t NST = (int64_t)(block_size / 16384);
  const int64_t NROWS = (int64_t)(block_size / 128);
  *out_nq = 0; *out_maxrow = 128; *out_litrows = 0;
  if (out_nplan) *out_nplan = 0;
  static thread_local PrepTL T;
  const uint64_t lit_cap = (uint64_t)RLP * 128;

  // ---- phase 1: sections -> (ll, ml, off) + literals in lit8 ----
  uint64_t n_lit = 0, n_seq64 = 0;
  if (n_dict) {
    if (n_dict + 64 > lit_cap) return -10;
    memcpy(lit8, dict, n_dict);
  }
  uint8_t *lit = lit8 + n_dict;
  if (block_type == 0) {  // RAW: all-literal block
    if (plen > block_size) return -10;
    if (n_dict + plen + 64 > lit_cap) { *out_litrows = (int64_t)((n_dict + plen + 64 + 127) / 128); return -10; }
    memcpy(lit, pl, plen);
    n_lit = plen;
  } else if (block_type == 1 || block_type == 2) {
    const int is_glo = block_type == 1;
    const int n_sec = is_glo ? 4 : 3;
    const uint64_t HDR = 16 + 8u * n_sec;
    if (plen < HDR) return -6;
    uint32_t n_seq;
    memcpy(&n_seq, pl, 4);
    uint8_t enc_lit = pl[8], enc_tok = pl[9], enc_off = pl[11];
    uint64_t sz[4] = {0, 0, 0, 0}, raw[4] = {0, 0, 0, 0};
    uint64_t tile = HDR;
    for (int k = 0; k < n_sec; k++) {
      uint64_t d;
      memcpy(&d, pl + 16 + 8 * k, 8);
      sz[k] = d & 0xFFFFFFFFu;
      raw[k] = d >> 32;
      tile += sz[k];
    }
    if (tile != plen) return -8;
    const uint8_t *sec_lit = pl + HDR;
    const uint8_t *sec_b = sec_lit + sz[0];
    const uint8_t *sec_c = sec_b + sz[1];
    const uint8_t *sec_ext = is_glo ? sec_c + sz[2] : sec_c;
    const uint64_t sz_ext = is_glo ? sz[3] : sz[2];
    if (n_seq > block_size / 5 + 1) return -8;
    n_seq64 = n_seq;

    // literal section -> lit (within lit8); shared with the hint loader
    {
      SecView v;
      int prc = parse_sections(pl, plen, block_type, block_size, &v);
      if (prc) return prc;
      int64_t rc = decode_block_literals(v, block_size, dict_cl, lit,
                                         n_dict, lit_cap, T, &n_lit,
                                         out_litrows);
      if (rc) return rc;
    }

    // token / word section -> (ll, ml, off) with inline extras varints
    grow_i32(&T.ll, &T.seq_cap, n_seq ? n_seq : 1);
    // seq_cap tracks ll only; ml/off ride along
    if (T.seq_cap > 0) {
      static thread_local uint64_t mloff_cap = 0;
      if (T.seq_cap > mloff_cap) {
        delete[] T.ml; delete[] T.off;
        T.ml = new int32_t[T.seq_cap];
        T.off = new int32_t[T.seq_cap];
        mloff_cap = T.seq_cap;
      }
    }
    const uint8_t *tok = sec_b;
    if (is_glo) {
      if (enc_tok == 2) {
        if (n_seq) {
          if (sz[1] < 128) return -8;
          uint8_t cl[256];
          {
            int any = 0;
            for (int i = 0; i < 128; i++) {
              uint8_t b = sec_b[i];
              uint8_t lo = (uint8_t)(b & 15), hi = (uint8_t)(b >> 4);
              if (lo > 11 || hi > 11) return -8;
              cl[2 * i] = lo; cl[2 * i + 1] = hi;
              any |= b;
            }
            if (!any) return -8;
          }
          grow_u8(&T.tok, &T.tok_cap, block_size + 64);
          grow_u8(&T.piv, &T.piv_cap, block_size + 64);
          int rc = zxch_pivco_decode_s(sec_b + 128, sz[1] - 128, cl, n_seq,
                                       T.tok, T.piv);
          if (rc) return rc;
          tok = T.tok;
        }
      } else if (enc_tok != 0) {
        return -8;
      } else if (sz[1] < n_seq) {
        return -8;
      }
      uint64_t expected_off = (enc_off == 1) ? n_seq : 2u * n_seq;
      if (sz[2] < expected_off) return -8;
      uint64_t e = 0;
      for (uint64_t i = 0; i < n_seq; i++) {
        uint32_t t = tok[i];
        uint64_t l = t >> 4, m = t & 15;
        if (l == 15) {
          uint64_t v; int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
          if (c < 0) return -8;
          e += (uint64_t)c; l += v;
        }
        if (m == 15) {
          uint64_t v; int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
          if (c < 0) return -8;
          e += (uint64_t)c; m += v;
        }
        T.ll[i] = (int32_t)l;
        T.ml[i] = (int32_t)(m + 5);
        T.off[i] = (enc_off == 1) ? (int32_t)sec_c[i] + 1
                                  : (int32_t)rd16le(sec_c + 2 * i) + 1;
      }
    } else {
      if (sz[1] < 4u * n_seq) return -8;
      uint64_t e = 0;
      for (uint64_t i = 0; i < n_seq; i++) {
        uint32_t wd;
        memcpy(&wd, sec_b + 4 * i, 4);
        uint64_t l = wd >> 24, m = (wd >> 16) & 0xFF;
        if (l == 255) {
          uint64_t v; int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
          if (c < 0) return -8;
          e += (uint64_t)c; l += v;
        }
        if (m == 255) {
          uint64_t v; int64_t c = dec_varint(sec_ext + e, sz_ext - e, &v);
          if (c < 0) return -8;
          e += (uint64_t)c; m += v;
        }
        T.ll[i] = (int32_t)l;
        T.ml[i] = (int32_t)(m + 5);
        T.off[i] = (int32_t)(wd & 0xFFFF) + 1;
      }
    }
  } else {
    return -13;  // BAD_BLOCK_TYPE
  }

  // logical size validation (python plan_frame parity)
  uint64_t lit_used = 0, total_seq = 0;
  for (uint64_t i = 0; i < n_seq64; i++) {
    lit_used += (uint64_t)T.ll[i];
    total_seq += (uint64_t)T.ll[i] + (uint64_t)T.ml[i];
  }
  if (lit_used > n_lit) return -10;
  const uint64_t total = total_seq + (n_lit - lit_used);
  if (total > block_size) return -10;

  // ---- phase 2: resolve into device-pure pieces (max_frag=1) ----
  grow_i32(&T.po, &T.piece_cap, 8 * (n_seq64 ? n_seq64 : 1) + 64);
  {
    static thread_local uint64_t pcsk_cap = 0;
    if (T.piece_cap > pcsk_cap) {
      delete[] T.pc; delete[] T.ps; delete[] T.pk;
      T.pc = new int32_t[T.piece_cap];
      T.ps = new int32_t[T.piece_cap];
      T.pk = new int32_t[T.piece_cap];
      pcsk_cap = T.piece_cap;
    }
  }
  uint64_t lit_out = 0;
  int64_t np = resolve_pieces_impl(T.ll, T.ml, T.off, n_seq64, lit8,
                                   n_dict + n_lit, lit_cap, n_dict,
                                   T.po, T.pc, T.ps, T.pk, T.piece_cap,
                                   &lit_out, /*device_pure=*/1,
                                   /*max_frag=*/1,
                                   plan, plan_cap, out_nplan, self_ref);
  if (np == -10) { *out_litrows = (int64_t)((lit_out ? lit_out : lit_cap + (block_size >> 2)) + 127) / 128 + 8; return -10; }
  if (np < 0) return np;
  const int64_t litrows = (int64_t)((lit_out + 127) / 128);
  *out_litrows = litrows;
  if (out_litlen) *out_litlen = (int64_t)lit_out;
  // zero-pad the literal tail row (deterministic H2D content)
  if ((uint64_t)litrows * 128 > lit_out)
    memset(lit8 + lit_out, 0, (uint64_t)litrows * 128 - lit_out);

  // ---- phase 3: lane ops per supertile -> sort -> slots -> quads ----
  int64_t nq = 0;           // quads emitted so far (block-relative)
  int64_t maxrow = 0;
  int64_t cur_st = 0;       // next supertile to flush
  uint64_t bucket_n = 0;    // ops in the open supertile's bucket
  qs[0] = 0;
  grow_i32(&T.counts, &T.counts_cap, (uint64_t)(RLP + NROWS) + 2);
  int64_t bkt_minrow = 1 << 30, bkt_maxrow = -1;

  // flush the open supertile bucket as quads; returns 0 or -10
  auto flush_one = [&]() -> int {
    // counting sort by src_row (stable: bucket order is output order,
    // which within a src_row is ascending (tgt, lane) — argsort parity)
    const int64_t n = (int64_t)bucket_n;
    int32_t *B = T.ops;            // packed 5 x i32 per op
    int32_t *S = T.ops_sorted;
    int64_t n_slots = 0;
    if (n) {
      const int64_t lo = bkt_minrow, hi = bkt_maxrow;
      int32_t *cnt = T.counts;
      memset(cnt, 0, (size_t)(hi - lo + 2) * sizeof(int32_t));
      for (int64_t i = 0; i < n; i++) cnt[B[5 * i + 1] - lo + 1]++;
      for (int64_t r = 0; r <= hi - lo; r++) cnt[r + 1] += cnt[r];
      for (int64_t i = 0; i < n; i++) {
        int64_t d = cnt[B[5 * i + 1] - lo]++;
        memcpy(S + 5 * d, B + 5 * i, 5 * sizeof(int32_t));
      }
      // slot grouping: runs of equal (src_row, tgt), K sub-ops per slot
      grow_i32(&T.ssrc, &T.slot_cap, (uint64_t)n);
      {
        static thread_local uint64_t sl2_cap = 0;
        if (T.slot_cap > sl2_cap) {
          delete[] T.stgt; delete[] T.sctl;
          T.stgt = new int32_t[T.slot_cap];
          T.sctl = new int32_t[T.slot_cap * 4 * 3];
          sl2_cap = T.slot_cap;
        }
      }
      int32_t cur_src = -1, cur_tgt = -1;
      int within = 0;
      for (int64_t i = 0; i < n; i++) {
        const int32_t *o = S + 5 * i;   // row, src_row, roll, s, e
        const int32_t tgt = (int32_t)((o[0] & 31) + 32 * ((o[0] >> 5) & 3));
        if (o[1] != cur_src || tgt != cur_tgt) {
          cur_src = o[1]; cur_tgt = tgt; within = 0;
        }
        if (within % K == 0) {
          int64_t s_ = n_slots++;
          T.ssrc[s_] = cur_src;
          T.stgt[s_] = cur_tgt;
          for (int k = 0; k < K; k++) {
            T.sctl[(s_ * K + k) * 3 + 0] = 0;
            T.sctl[(s_ * K + k) * 3 + 1] = 1;   // empty: s=1 > e-1=0
            T.sctl[(s_ * K + k) * 3 + 2] = 0;
          }
        }
        const int64_t s_ = n_slots - 1;
        const int k = within % K;
        T.sctl[(s_ * K + k) * 3 + 0] = o[2];
        T.sctl[(s_ * K + k) * 3 + 1] = o[3];
        T.sctl[(s_ * K + k) * 3 + 2] = o[4] - 1;
        within++;
      }
    }
    // quad chunking over slots (ssrc non-decreasing)
    const int64_t q_first = nq;
    int64_t i = 0;
    while (i < n_slots) {
      int32_t base = T.ssrc[i] & ~15;
      const int32_t base_cap = (int32_t)(RLP + NROWS - 128);
      if (self_ref && base > base_cap) base = base_cap;  // window fits scratch
      int64_t j = i + 128 < n_slots ? i + 128 : n_slots;
      while (T.ssrc[j - 1] - base > 127) j--;
      if (nq >= MAXQ) { *out_nq = nq + 1; return -10; }
      // scatter this quad. maxrow sizes the caller's RLP so lit windows
      // fit; under self_ref, lit windows may poke into the scratch's
      // zero-initialized out region (rows >= RLP) harmlessly, so the
      // report caps at RLP and excludes OUT bases.
      qbase[nq] = base;
      {
        int64_t wend = base + 128;
        if (self_ref) wend = (base < RLP) ? (wend < RLP ? wend : RLP) : 0;
        if (wend > maxrow) maxrow = wend;
      }
      uint8_t *tqrow = tq + nq * 128;
      const int64_t qn = j - i;
      for (int64_t c = 0; c < 128; c++) {
        const int64_t bat = 4 * nq + (c >> 5);
        int32_t *cell = pctrl + ((bat >> 7) * 32 + (c & 31)) * 128
                        + (bat & 127);
        if (c < qn) {
          const int64_t s_ = i + c;
          const int32_t *ct = T.sctl + s_ * K * 3;
          cell[0] = ct[0] | (ct[1] << 7) | (ct[2] << 14)
                    | ((T.ssrc[s_] - base) << 21);
          for (int k = 1; k < K; k++)
            cell[(int64_t)k * NG32 * 128] =
                ct[k * 3 + 0] | (ct[k * 3 + 1] << 7) | (ct[k * 3 + 2] << 14);
          tqrow[c] = (uint8_t)T.stgt[s_];
        } else {
          cell[0] = 1 << 7;
          for (int k = 1; k < K; k++) cell[(int64_t)k * NG32 * 128] = 1 << 7;
          tqrow[c] = 0;
        }
      }
      nq++;
      i = j;
    }
    if (n_slots == 0) {
      // python parity: an empty supertile still emits one empty quad
      if (nq >= MAXQ) { *out_nq = nq + 1; return -10; }
      qbase[nq] = 0;
      if (maxrow < 128) maxrow = 128;
      uint8_t *tqrow = tq + nq * 128;
      for (int64_t c = 0; c < 128; c++) {
        const int64_t bat = 4 * nq + (c >> 5);
        int32_t *cell = pctrl + ((bat >> 7) * 32 + (c & 31)) * 128
                        + (bat & 127);
        cell[0] = 1 << 7;
        for (int k = 1; k < K; k++) cell[(int64_t)k * NG32 * 128] = 1 << 7;
        tqrow[c] = 0;
      }
      nq++;
    }
    // alignment padding quads
    while ((nq - q_first) % quad_align) {
      if (nq >= MAXQ) { *out_nq = nq + 1; return -10; }
      qbase[nq] = 0;
      if (maxrow < 128) maxrow = 128;
      uint8_t *tqrow = tq + nq * 128;
      for (int64_t c = 0; c < 128; c++) {
        const int64_t bat = 4 * nq + (c >> 5);
        int32_t *cell = pctrl + ((bat >> 7) * 32 + (c & 31)) * 128
                        + (bat & 127);
        cell[0] = 1 << 7;
        for (int k = 1; k < K; k++) cell[(int64_t)k * NG32 * 128] = 1 << 7;
        tqrow[c] = 0;
      }
      nq++;
    }
    bucket_n = 0;
    bkt_minrow = 1 << 30; bkt_maxrow = -1;
    return 0;
  };

  for (int64_t j = 0; j < np; j++) {
    int64_t q = T.po[j];
    int64_t end = (j + 1 < np) ? T.po[j + 1] : (int64_t)total;
    const int64_t c = T.pc[j], sd = T.ps[j], k = T.pk[j];
    while (q < end) {
      const int64_t row = q >> 7;
      const int64_t st = row >> 7;
      while (st >= cur_st + 1) {   // piece crossed into a new supertile
        int rc = flush_one();
        if (rc) return rc;
        cur_st++;
        qs[cur_st] = (int32_t)nq;
      }
      const int64_t s = q & 127;
      int64_t row_end = (row + 1) << 7;
      if (row_end > end) row_end = end;
      const int64_t src = (k >= ZXCH_KBIG) ? c + (q - sd)
                                           : c + ((q - sd) % k);
      const int64_t row_off = (k == ZXCH_KOUT) ? RLP : 0;
      const int64_t src_lane = src & 127;
      int64_t len = row_end - q;
      if (len > 128 - src_lane) len = 128 - src_lane;
      grow_i32(&T.ops, &T.ops_cap, (bucket_n + 1) * 5);
      {
        static thread_local uint64_t srt_cap = 0;
        if (T.ops_cap > srt_cap) {
          delete[] T.ops_sorted;
          T.ops_sorted = new int32_t[T.ops_cap];
          srt_cap = T.ops_cap;
        }
      }
      int32_t *o = T.ops + bucket_n * 5;
      o[0] = (int32_t)row;   // full output row; tgt = (row&31) + 32*((row>>5)&3)
      o[1] = (int32_t)((src >> 7) + row_off);
      o[2] = (int32_t)((src_lane - s) & 127);
      o[3] = (int32_t)s;
      o[4] = (int32_t)(s + len);
      if (o[1] < bkt_minrow) bkt_minrow = o[1];
      if (o[1] > bkt_maxrow) bkt_maxrow = o[1];
      bucket_n++;
      q += len;
    }
  }
  // flush remaining supertiles (incl. trailing empties)
  while (cur_st < NST) {
    int rc = flush_one();
    if (rc) return rc;
    cur_st++;
    qs[cur_st] = (int32_t)nq;
  }
  *out_nq = nq;
  *out_maxrow = maxrow;
  // the kernel reads lit8[base : base+128) per quad: RLP must cover the
  // highest window, not just the literal rows
  if (maxrow > RLP) return -10;
  return (int64_t)total;
}

int64_t zxch_v19_prep_block(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    int K, int quad_align,
    int32_t *qs, int32_t *qbase, int32_t *pctrl, uint8_t *tq, uint8_t *lit8,
    int64_t MAXQ, int64_t NG32, int64_t RLP,
    int64_t *out_nq, int64_t *out_maxrow, int64_t *out_litrows) {
  return v19_prep_block_impl(pl, plen, block_type, block_size, dict, n_dict,
                             dict_cl, K, quad_align, qs, qbase, pctrl, tq,
                             lit8, MAXQ, NG32, RLP, out_nq, out_maxrow,
                             out_litrows, nullptr, 0, nullptr, nullptr);
}

// v26 unified-window prep: identical layout, but the resolver runs in
// self_ref mode and KOUT sources pack as scratch rows RLP + out_row for
// the v26 kernel ([lit8 ++ own decoded tiles] window). lit8 holds
// literals + patterns only.
int64_t zxch_v26_prep_block(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    int K, int quad_align,
    int32_t *qs, int32_t *qbase, int32_t *pctrl, uint8_t *tq, uint8_t *lit8,
    int64_t MAXQ, int64_t NG32, int64_t RLP,
    int64_t *out_nq, int64_t *out_maxrow, int64_t *out_litrows) {
  return v19_prep_block_impl(pl, plen, block_type, block_size, dict, n_dict,
                             dict_cl, K, quad_align, qs, qbase, pctrl, tq,
                             lit8, MAXQ, NG32, RLP, out_nq, out_maxrow,
                             out_litrows, nullptr, 0, nullptr, nullptr, 1);
}

// Hint-producing prep (encode-time / first-decode cache): identical output
// to zxch_v19_prep_block PLUS the lit8 replay plan — the control records
// that rebuild the resolver-materialized tail of lit8 from the
// archive-decoded literal/dict prefix without re-running resolution.
// Returns -16 when plan_cap is too small (grow and retry).
int64_t zxch_v19_prep_block_plan(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    int K, int quad_align,
    int32_t *qs, int32_t *qbase, int32_t *pctrl, uint8_t *tq, uint8_t *lit8,
    int64_t MAXQ, int64_t NG32, int64_t RLP,
    int64_t *out_nq, int64_t *out_maxrow, int64_t *out_litrows,
    int32_t *plan, int64_t plan_cap, int64_t *out_nplan,
    int64_t *out_litlen) {
  return v19_prep_block_impl(pl, plen, block_type, block_size, dict, n_dict,
                             dict_cl, K, quad_align, qs, qbase, pctrl, tq,
                             lit8, MAXQ, NG32, RLP, out_nq, out_maxrow,
                             out_litrows, plan, plan_cap, out_nplan,
                             out_litlen);
}

// v26 hint-producing prep (self_ref geometry + replay plan).
int64_t zxch_v26_prep_block_plan(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    int K, int quad_align,
    int32_t *qs, int32_t *qbase, int32_t *pctrl, uint8_t *tq, uint8_t *lit8,
    int64_t MAXQ, int64_t NG32, int64_t RLP,
    int64_t *out_nq, int64_t *out_maxrow, int64_t *out_litrows,
    int32_t *plan, int64_t plan_cap, int64_t *out_nplan,
    int64_t *out_litlen) {
  return v19_prep_block_impl(pl, plen, block_type, block_size, dict, n_dict,
                             dict_cl, K, quad_align, qs, qbase, pctrl, tq,
                             lit8, MAXQ, NG32, RLP, out_nq, out_maxrow,
                             out_litrows, plan, plan_cap, out_nplan,
                             out_litlen, 1);
}

// Hint-replay lit8 build: literal-section decode (the only data-bearing
// phase — all bytes come from the ARCHIVE) + plan replay rebuilding the
// resolver-materialized tail, skipping piece resolution and lane-op
// packing entirely (those ship verbatim in the hint). Plan records are
// bounds-checked against lit_cap, so a corrupt hint fails cleanly.
// Returns litrows >= 0 or a negative ZXC error.
int64_t zxch_v19_lit8_load(
    const uint8_t *pl, uint64_t plen, int block_type, uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    const int32_t *plan, int64_t n_plan, int64_t lit_len,
    uint8_t *lit8, int64_t RLP) {
  if (block_size % 16384) return -1;
  static thread_local PrepTL T;
  const uint64_t lit_cap = (uint64_t)RLP * 128;
  uint64_t n_lit = 0;
  if (n_dict) {
    if (n_dict + 64 > lit_cap) return -10;
    memcpy(lit8, dict, n_dict);
  }
  uint8_t *lit = lit8 + n_dict;
  if (block_type == 0) {  // RAW
    if (plen > block_size) return -10;
    if (n_dict + plen + 64 > lit_cap) return -10;
    memcpy(lit, pl, plen);
    n_lit = plen;
  } else if (block_type == 1 || block_type == 2) {
    SecView v;
    int prc = parse_sections(pl, plen, block_type, block_size, &v);
    if (prc) return prc;
    int64_t need = 0;
    int64_t rc = decode_block_literals(v, block_size, dict_cl, lit, n_dict,
                                       lit_cap, T, &n_lit, &need);
    if (rc) return rc;
  } else {
    return -13;
  }
  int64_t base = (int64_t)(n_dict + n_lit);
  if (lit_len < base || (uint64_t)lit_len > lit_cap) return -8;
  for (int64_t i = 0; i < n_plan; i++) {
    const int32_t *pr = plan + 4 * i;
    const int64_t dst = pr[1], len = pr[3];
    if (len < 0 || dst < base || dst + len > lit_len) return -8;
    if (pr[0] == 0) {
      const int64_t sp = pr[2];
      if (sp < 0 || sp + len > dst) return -8;  // replay only reads built bytes
      memcpy(lit8 + dst, lit8 + sp, len);
    } else if (pr[0] == 1) {
      memset(lit8 + dst, pr[2] & 0xFF, len);
    } else {
      return -8;
    }
  }
  const int64_t litrows = (lit_len + 127) / 128;
  if ((uint64_t)litrows * 128 > (uint64_t)lit_len)
    memset(lit8 + lit_len, 0, (uint64_t)litrows * 128 - (uint64_t)lit_len);
  return litrows;
}

// Batched hint replay: one call handles blocks i0, i0+stride, ... < i1
// (a worker's stripe), so the decode server's prep stream pays ONE
// FFI/python dispatch per worker per decode instead of one per block
// (~15 us of python glue x 512 blocks measured as a real term in the
// concurrent-pipeline slope). Per block b: payload at src+pos[b], plan
// records plans[4*plan_off[b] ..], destination lit8_base + loff[b]*128
// with capacity RLP rows; rows [litrows, zrows[b]) are zeroed when
// zrows is non-null (the v27 32-row alignment tail / pool staleness).
// Returns 0 or the first failing block's negative error code.
int64_t zxch_v19_lit8_load_batch(
    const uint8_t *src, const uint64_t *pos, const uint64_t *comp,
    const uint8_t *typ, int64_t i0, int64_t i1, int64_t stride,
    uint64_t block_size,
    const uint8_t *dict, uint64_t n_dict, const uint8_t *dict_cl,
    const int32_t *plans, const int64_t *plan_off, const int64_t *litlen,
    uint8_t *lit8_base, const int32_t *loff, int64_t RLP,
    const int32_t *zrows) {
  if (stride <= 0) return -12;
  for (int64_t b = i0; b < i1; b += stride) {
    uint8_t *dst = lit8_base + (int64_t)loff[b] * 128;
    int64_t lr = zxch_v19_lit8_load(
        src + pos[b], comp[b], (int)typ[b], block_size, dict, n_dict,
        dict_cl, plans + 4 * plan_off[b], plan_off[b + 1] - plan_off[b],
        litlen[b], dst, RLP);
    if (lr < 0) return lr;
    if (zrows && zrows[b] > lr)
      memset(dst + lr * 128, 0, (size_t)(zrows[b] - lr) * 128);
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Push-streaming C ABI (reference zxc_pstream.c parity): reentrant,
// caller-driven state machines over the native block codecs, so every
// language binding gets cstream/dstream without the Python layer. Byte-
// identical with codec/pstream.py (which equals the one-shot frame
// bytes): same per-block dispatch as zxch_compress_frame, same wire.
// Dictionaries are rejected — the push path has no dict_id handshake
// (reference zxc_pstream.h:123-137). Sticky errors: once a call fails,
// every later call returns the same code.
// ---------------------------------------------------------------------------

namespace {

struct PsPar { int probes, lazy, suff, sb, ss, cover, min_emit; };
static const PsPar kPsTab[7] = {
    {2, 0, 16, 1, 4, 4, 5},  {2, 0, 24, 1, 4, 4, 5},
    {5, 0, 32, 1, 5, 4, 5},  {8, 0, 64, 1, 0, 2, 5},
    {24, 1, 128, 1, 0, 2, 5}, {64, 1, 0, 1, 0, 1, 5},
    {192, 1, 0, 1, 0, 1, 5}};

struct ZxchCStream {
  int level = 3;
  uint64_t bs = 512 * 1024;
  int checksum = 0;
  int seekable = 0;
  std::vector<uint8_t> acc;      // partial input block
  std::vector<uint8_t> pend;     // encoded bytes awaiting drain
  uint64_t pend_pos = 0;
  std::vector<uint32_t> seek_sizes;
  uint64_t total_in = 0;
  uint32_t ghash = 0;
  bool ended = false;
  int err = 0;
};

// encode one chunk (block header + payload + optional checksum) onto
// s->pend — the zxch_compress_frame per-block dispatch, no dict
int cs_encode_chunk(ZxchCStream *s, const uint8_t *data, uint64_t len) {
  PsPar p = kPsTab[s->level - 1];
  const uint64_t BH = 8;
  uint64_t pcap = len + len / 4 + 4096 + 256;
  size_t base = s->pend.size();
  s->pend.resize(base + BH + pcap + 4);
  uint8_t *payload = s->pend.data() + base + BH;
  int64_t psz;
  int btype;
  if (s->level >= 6) {
    psz = zxch_encode_glo_opt(data, len, 0, s->level, p.probes, nullptr,
                              payload, pcap);
    btype = 1;
  } else if (s->level >= 2) {
    psz = zxch_encode_glo(data, len, 0, p.probes, p.lazy, p.suff, p.sb,
                          p.ss, p.cover, p.min_emit, nullptr, payload,
                          pcap);
    btype = 1;
    uint64_t budget = len > BH ? len - BH : 0;
    if (psz >= 0 && (uint64_t)psz < budget) budget = (uint64_t)psz;
    static thread_local std::vector<uint8_t> hlbuf;
    if (hlbuf.size() < len + 1024) hlbuf.resize(len + 1024);
    int64_t hl = zxch_encode_hufflit(data, len, hlbuf.data(), hlbuf.size(),
                                     budget);
    if (hl >= 0 && (uint64_t)hl <= pcap) {
      memcpy(payload, hlbuf.data(), (size_t)hl);
      psz = hl;
    }
  } else {
    uint64_t max_seq = len / 5 + 8;
    zxch_parse_scratch(max_seq);
    int64_t nseq = zxch_find_parse(data, len, 0, p.probes, p.lazy, p.suff,
                                   p.sb, p.ss, p.cover, p.min_emit, g_mp,
                                   g_ml, g_mo, max_seq);
    uint64_t lit_total = 0, n_ext = 0;
    int64_t ghi_need = nseq >= 0
        ? (int64_t)zxch_ghi_size(g_mp, g_ml, nseq, len, &lit_total, &n_ext)
        : -10;
    uint64_t budget = len > BH ? len - BH : 0;
    if (ghi_need >= 0 && (uint64_t)ghi_need < budget)
      budget = (uint64_t)ghi_need;
    int64_t hl = zxch_encode_hufflit(data, len, payload, pcap, budget);
    if (hl >= 0) {
      psz = hl;
      btype = 1;
    } else if (ghi_need >= 0 && (uint64_t)ghi_need <= pcap) {
      psz = zxch_emit_ghi(data, 0, len, g_mp, g_ml, g_mo, nseq, lit_total,
                          n_ext, payload);
      btype = 2;
    } else {
      psz = -10;
      btype = 2;
    }
  }
  if (psz < 0 || (uint64_t)(BH + psz) >= len) {
    memcpy(payload, data, len);   // RAW fallback (expansion rule)
    psz = (int64_t)len;
    btype = 0;
  }
  uint8_t *bh = s->pend.data() + base;
  memset(bh, 0, BH);
  bh[0] = (uint8_t)btype;
  bh[3] = (uint8_t)(psz & 0xFF);
  bh[4] = (uint8_t)((psz >> 8) & 0xFF);
  bh[5] = (uint8_t)((psz >> 16) & 0xFF);
  bh[6] = (uint8_t)((psz >> 24) & 0xFF);
  bh[7] = zxch_hash8(bh);
  uint64_t chunk = BH + (uint64_t)psz;
  if (s->checksum) {
    uint32_t cs = zxch_rapidhash32(s->pend.data() + base + BH,
                                   (size_t)psz, 0);
    memcpy(s->pend.data() + base + chunk, &cs, 4);
    chunk += 4;
    s->ghash = ((s->ghash << 1) | (s->ghash >> 31)) ^ cs;
  }
  s->seek_sizes.push_back((uint32_t)chunk);
  s->pend.resize(base + chunk);
  return 0;
}

uint64_t ps_drain(std::vector<uint8_t> &pend, uint64_t &pos, uint8_t *dst,
                  uint64_t cap) {
  uint64_t avail = pend.size() - pos;
  uint64_t take = avail < cap ? avail : cap;
  memcpy(dst, pend.data() + pos, take);
  pos += take;
  if (pos == pend.size()) {
    pend.clear();
    pos = 0;
  }
  return take;
}

}  // namespace

extern "C" {

// level 1-7; block_size 0 selects the 512 KiB default. NULL on bad args.
void *zxch_cstream_new(int level, uint64_t block_size, int checksum,
                       int seekable) {
  if (level < 1) level = 1;
  if (level > 7) level = 7;
  if (block_size == 0) block_size = 512 * 1024;
  if (block_size & (block_size - 1)) return nullptr;
  int code = 0;
  while ((1ull << code) < block_size) code++;
  if (code < 12 || code > 21) return nullptr;
  ZxchCStream *s = new ZxchCStream();
  s->level = level;
  s->bs = block_size;
  s->checksum = checksum ? 1 : 0;
  s->seekable = seekable ? 1 : 0;
  // file header goes out first (headers.py:20 layout)
  s->pend.resize(16, 0);
  s->pend[0] = 0xF5; s->pend[1] = 0x2E; s->pend[2] = 0xB0; s->pend[3] = 0x9C;
  s->pend[4] = 7;
  s->pend[5] = (uint8_t)code;
  s->pend[6] = s->checksum ? 0x80 : 0;
  uint16_t h16 = zxch_hash16(s->pend.data());
  s->pend[14] = (uint8_t)(h16 & 0xFF);
  s->pend[15] = (uint8_t)(h16 >> 8);
  return s;
}

// Push up to n bytes and drain up to cap produced bytes. *consumed gets
// the input bytes taken (always all of them — accumulation is
// unbounded only per block). Returns produced bytes or a negative ZXC
// error (sticky).
int64_t zxch_cstream_compress(void *h, const uint8_t *src, uint64_t n,
                              uint8_t *dst, uint64_t cap,
                              uint64_t *consumed) {
  ZxchCStream *s = (ZxchCStream *)h;
  if (consumed) *consumed = 0;
  if (s->err) return s->err;
  if (s->ended) { s->err = -6; return s->err; }   // compress after end
  uint64_t done = 0;
  while (done < n) {
    uint64_t room = s->bs - s->acc.size();
    uint64_t take = n - done < room ? n - done : room;
    s->acc.insert(s->acc.end(), src + done, src + done + take);
    done += take;
    if (s->acc.size() == s->bs) {
      int rc = cs_encode_chunk(s, s->acc.data(), s->bs);
      if (rc) { s->err = rc; return rc; }
      s->acc.clear();
    }
  }
  s->total_in += done;
  if (consumed) *consumed = done;
  return (int64_t)ps_drain(s->pend, s->pend_pos, dst, cap);
}

// Flush the final partial block, EOF, optional seek table and footer;
// call until zxch_cstream_finished. Returns produced bytes or error.
int64_t zxch_cstream_end(void *h, uint8_t *dst, uint64_t cap) {
  ZxchCStream *s = (ZxchCStream *)h;
  if (s->err) return s->err;
  if (!s->ended) {
    s->ended = true;
    if (!s->acc.empty()) {
      int rc = cs_encode_chunk(s, s->acc.data(), s->acc.size());
      if (rc) { s->err = rc; return rc; }
      s->acc.clear();
    }
    size_t base = s->pend.size();
    s->pend.resize(base + 8, 0);
    uint8_t *eof = s->pend.data() + base;
    eof[0] = 0xFF;  // BLOCK_EOF
    eof[7] = zxch_hash8(eof);
    if (s->seekable && !s->seek_sizes.empty()) {
      uint64_t n = s->seek_sizes.size();
      size_t sb = s->pend.size();
      s->pend.resize(sb + 8 + 4 * n, 0);
      uint8_t *sh = s->pend.data() + sb;
      uint64_t payload = 4 * n;   // u32 sizes only (headers.py:138)
      sh[0] = 0xFE;  // BLOCK_SEK
      sh[3] = (uint8_t)(payload & 0xFF);
      sh[4] = (uint8_t)((payload >> 8) & 0xFF);
      sh[5] = (uint8_t)((payload >> 16) & 0xFF);
      sh[6] = (uint8_t)((payload >> 24) & 0xFF);
      sh[7] = zxch_hash8(sh);
      memcpy(sh + 8, s->seek_sizes.data(), 4 * n);
    }
    size_t fb = s->pend.size();
    s->pend.resize(fb + 12);
    memcpy(s->pend.data() + fb, &s->total_in, 8);
    uint32_t gh = s->checksum ? s->ghash : 0;
    memcpy(s->pend.data() + fb + 8, &gh, 4);
  }
  return (int64_t)ps_drain(s->pend, s->pend_pos, dst, cap);
}

int zxch_cstream_finished(void *h) {
  ZxchCStream *s = (ZxchCStream *)h;
  return s->ended && s->pend.empty() && !s->err;
}

uint64_t zxch_cstream_in_size(void *h) {
  return ((ZxchCStream *)h)->bs;
}

uint64_t zxch_cstream_out_size(void *h) {
  ZxchCStream *s = (ZxchCStream *)h;
  return 8 + s->bs + s->bs / 4 + 4096 + 4;
}

void zxch_cstream_free(void *h) { delete (ZxchCStream *)h; }

}  // extern "C"

// -- decompressor -----------------------------------------------------------

namespace {

struct ZxchDStream {
  int verify = 0;
  std::vector<uint8_t> buf;    // undigested input
  std::vector<uint8_t> out;    // decoded bytes awaiting drain
  uint64_t out_pos = 0;
  int state = 0;               // 0 hdr, 1 block-hdr, 2 payload, 3 after-eof, 4 done
  uint64_t bs = 0;
  int has_ck = 0;
  int btype = 0;
  uint64_t comp = 0;
  uint64_t produced = 0;
  uint32_t ghash = 0;
  int err = 0;
};

// one state transition if enough input; 1 = progressed, 0 = need bytes,
// <0 = error
int ds_step(ZxchDStream *s) {
  std::vector<uint8_t> &b = s->buf;
  if (s->state == 0) {
    if (b.size() < 16) return 0;
    uint64_t bs;
    int ck;
    uint32_t did;
    int rc = zxch_frame_info(b.data(), 16 + 12, &bs, &ck, &did);
    // frame_info wants header+footer present; validate the header alone
    if (rc == -3) {
      uint8_t tmp[16];
      memcpy(tmp, b.data(), 16);
      uint32_t magic;
      memcpy(&magic, tmp, 4);
      if (magic != 0x9CB02EF5u) return -4;
      if (tmp[4] != 7) return -5;
      uint8_t code = tmp[5];
      uint16_t stored;
      memcpy(&stored, tmp + 14, 2);
      tmp[14] = tmp[15] = 0;
      if (stored != zxch_hash16(tmp) || (tmp[6] & 0x0F) != 0) return -6;
      if (code < 12 || code > 21) return -14;
      bs = 1ull << code;
      ck = (tmp[6] & 0x80) != 0;
      did = 0;
      if (tmp[6] & 0x40) memcpy(&did, tmp + 7, 4);
    } else if (rc) {
      return rc;
    }
    if (did != 0) return -15;  // DICT_REQUIRED: push path has no dicts
    s->bs = bs;
    s->has_ck = ck;
    b.erase(b.begin(), b.begin() + 16);
    s->state = 1;
    return 1;
  }
  if (s->state == 1) {
    if (b.size() < 8) return 0;
    if (zxch_hash8(b.data()) != b[7]) return -6;
    s->btype = b[0];
    uint32_t csz;
    memcpy(&csz, b.data() + 3, 4);
    s->comp = csz;
    b.erase(b.begin(), b.begin() + 8);
    if (s->btype == 0xFF) {            // EOF
      if (s->comp != 0) return -6;
      s->state = 3;
      return 1;
    }
    if (s->btype > 2) return -13;      // data blocks: RAW/GLO/GHI
    if (s->comp > 8 + s->bs + s->bs / 4 + 4096 + 4) return -8;
    s->state = 2;
    return 1;
  }
  if (s->state == 2) {
    uint64_t tail = s->has_ck ? 4 : 0;
    uint64_t need = s->comp + tail;
    if (b.size() < need) return 0;
    uint32_t stored = 0;
    if (tail) {
      memcpy(&stored, b.data() + s->comp, 4);
      if (s->verify) {
        if (zxch_rapidhash32(b.data(), (size_t)s->comp, 0) != stored)
          return -7;  // BAD_CHECKSUM
        s->ghash = ((s->ghash << 1) | (s->ghash >> 31)) ^ stored;
      }
    }
    size_t base = s->out.size();
    s->out.resize(base + s->bs + 64);
    int64_t n = zxch_decode_block(s->btype, b.data(), s->comp,
                                  s->out.data() + base, s->bs, nullptr, 0,
                                  nullptr);
    if (n < 0) return (int)n;
    s->out.resize(base + (uint64_t)n);
    s->produced += (uint64_t)n;
    b.erase(b.begin(), b.begin() + need);
    s->state = 1;
    return 1;
  }
  if (s->state == 3) {
    if (b.size() >= 8 && zxch_hash8(b.data()) == b[7] && b[0] == 0xFE) {
      uint32_t csz;                     // optional SEK block: skip it
      memcpy(&csz, b.data() + 3, 4);
      if (b.size() < 8 + (uint64_t)csz) return 0;
      b.erase(b.begin(), b.begin() + 8 + csz);
      return 1;
    }
    if (b.size() < 12) return 0;
    if (b.size() != 12) {
      if (b.size() < 8) return 0;
      return -8;                        // unexpected bytes after EOF
    }
    uint64_t size;
    uint32_t gh;
    memcpy(&size, b.data(), 8);
    memcpy(&gh, b.data() + 8, 4);
    if (size != s->produced) return -8;
    if (s->verify && s->has_ck && gh != s->ghash) return -7;
    b.clear();
    s->state = 4;
    return 1;
  }
  return 0;
}

}  // namespace

extern "C" {

void *zxch_dstream_new(int verify) {
  ZxchDStream *s = new ZxchDStream();
  s->verify = verify ? 1 : 0;
  return s;
}

// Push up to n bytes, drain up to cap decoded bytes. Returns produced
// bytes or a negative ZXC error (sticky). *consumed gets input taken
// (all of it, or none after an error / past the footer).
int64_t zxch_dstream_decompress(void *h, const uint8_t *src, uint64_t n,
                                uint8_t *dst, uint64_t cap,
                                uint64_t *consumed) {
  ZxchDStream *s = (ZxchDStream *)h;
  if (consumed) *consumed = 0;
  if (s->err) return s->err;
  if (s->state == 4 && n) { s->err = -8; return s->err; }
  if (n) s->buf.insert(s->buf.end(), src, src + n);
  if (consumed) *consumed = n;
  int rc;
  while (s->state != 4 && (rc = ds_step(s)) != 0) {
    if (rc < 0) { s->err = rc; return rc; }
  }
  return (int64_t)ps_drain(s->out, s->out_pos, dst, cap);
}

// 1 when the footer was consumed and every decoded byte was drained.
int zxch_dstream_finished(void *h) {
  ZxchDStream *s = (ZxchDStream *)h;
  return s->state == 4 && s->out.empty() && !s->err;
}

uint64_t zxch_dstream_out_size(void *h) {
  ZxchDStream *s = (ZxchDStream *)h;
  return (s->bs ? s->bs : 512 * 1024) + 64;
}

void zxch_dstream_free(void *h) { delete (ZxchDStream *)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Reusable-context C ABI (zxc_create_cctx/dctx + sticky options parity,
// zxc_dispatch.c:1257-1560): a context holds sticky encode/decode
// options and an attached dictionary — the dict id and the unpacked
// shared-table lengths are computed ONCE at attach (the reference's
// tree-at-attach, zxc_common.c:500), so per-frame calls skip that work.
// ---------------------------------------------------------------------------

namespace {

// handle tags: every context starts with a magic so the shared entry
// points (set/attach/compress/free) accept heap AND static handles
constexpr uint32_t CCTX_MAGIC = 0x43585443u;   // "CTXC"
constexpr uint32_t DCTX_MAGIC = 0x43585444u;   // "DTXC"
constexpr uint32_t CCTX_SMAGIC = 0x53585443u;  // "CTXS"
constexpr uint32_t DCTX_SMAGIC = 0x53585444u;  // "DTXS"

struct ZxchCctx {
  uint32_t magic = CCTX_MAGIC;
  int level = 3;
  uint64_t bs = 512 * 1024;
  int checksum = 0;
  int seekable = 0;
  std::vector<uint8_t> dict;
  std::vector<uint8_t> cl256;      // unpacked code lengths (256) or empty
  uint32_t dict_id = 0;
};

struct ZxchDctx {
  uint32_t magic = DCTX_MAGIC;
  int verify = 0;
  std::vector<uint8_t> dict;
  std::vector<uint8_t> cl256;
};

// Static (caller-workspace) contexts: the reference carves its whole
// cctx from one caller allocation for kernel/embedded use
// (zxc_init_static_cctx, zxc_dispatch.c:1885-2010; layout
// zxc_common.c:164). Here the CONTEXT state (options + dict + unpacked
// table) is carved from the caller's buffer and the context itself never
// heap-allocates; per-THREAD codec scratch remains process-wide
// thread_local (grown once, reused) — documented difference from the
// reference's fully-workspace model, see include/zxc_host.h.
struct ZxchCctxS {
  uint32_t magic;
  int level, checksum, seekable;
  uint64_t bs;
  uint64_t dict_cap, dict_len;
  uint32_t dict_id;
  int has_cl;
  // trailing: uint8_t cl256[256]; uint8_t dict[dict_cap]
  uint8_t *cl() { return (uint8_t *)(this + 1); }
  uint8_t *dictp() { return cl() + 256; }
};

struct ZxchDctxS {
  uint32_t magic;
  int verify;
  uint64_t dict_cap, dict_len;
  int has_cl;
  uint8_t *cl() { return (uint8_t *)(this + 1); }
  uint8_t *dictp() { return cl() + 256; }
};

int ctx_attach(std::vector<uint8_t> &dict, std::vector<uint8_t> &cl256,
               const uint8_t *d, uint64_t n, const uint8_t *packed128) {
  if (n > (1ull << 20)) return -17;
  dict.assign(d, d + n);
  cl256.clear();
  if (packed128) {
    cl256.resize(256);
    for (int i = 0; i < 128; i++) {
      cl256[2 * i] = (uint8_t)(packed128[i] & 0x0F);
      cl256[2 * i + 1] = (uint8_t)(packed128[i] >> 4);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void *zxch_cctx_new(void) { return new ZxchCctx(); }

// Workspace size for a static cctx/dctx able to hold a dictionary of up
// to max_dict bytes (reference zxc_estimate_cctx_size parity).
uint64_t zxch_cctx_static_size(uint64_t max_dict) {
  return sizeof(ZxchCctxS) + 256 + max_dict + 64;
}

uint64_t zxch_dctx_static_size(uint64_t max_dict) {
  return sizeof(ZxchDctxS) + 256 + max_dict + 64;
}

// Initialize a cctx inside the caller's workspace (no heap for context
// state; per-thread codec scratch stays thread_local — see header).
// Returns the handle (== ws) or NULL when ws is too small / misaligned
// parameters are invalid. The handle works with every zxch_cctx_* entry
// point; zxch_cctx_free is a no-op for it.
void *zxch_cctx_init_static(void *ws, uint64_t ws_size, int level,
                            uint64_t block_size, int checksum,
                            int seekable, uint64_t max_dict) {
  if (!ws || ws_size < zxch_cctx_static_size(max_dict)) return nullptr;
  if (((uintptr_t)ws) & 7) return nullptr;
  if (level < 1) level = 1;
  if (level > 7) level = 7;
  if (block_size == 0) block_size = 512 * 1024;
  if (block_size & (block_size - 1)) return nullptr;
  int code = 0;
  while ((1ull << code) < block_size) code++;
  if (code < 12 || code > 21) return nullptr;
  ZxchCctxS *c = (ZxchCctxS *)ws;
  c->magic = CCTX_SMAGIC;
  c->level = level;
  c->bs = block_size;
  c->checksum = checksum ? 1 : 0;
  c->seekable = seekable ? 1 : 0;
  c->dict_cap = max_dict;
  c->dict_len = 0;
  c->dict_id = 0;
  c->has_cl = 0;
  return ws;
}

void *zxch_dctx_init_static(void *ws, uint64_t ws_size, int verify,
                            uint64_t max_dict) {
  if (!ws || ws_size < zxch_dctx_static_size(max_dict)) return nullptr;
  if (((uintptr_t)ws) & 7) return nullptr;
  ZxchDctxS *d = (ZxchDctxS *)ws;
  d->magic = DCTX_SMAGIC;
  d->verify = verify ? 1 : 0;
  d->dict_cap = max_dict;
  d->dict_len = 0;
  d->has_cl = 0;
  return ws;
}

// Sticky options; 0 on success, negative ZXC error on bad parameters.
int zxch_cctx_set(void *h, int level, uint64_t block_size, int checksum,
                  int seekable) {
  if (level < 1) level = 1;
  if (level > 7) level = 7;
  if (block_size == 0) block_size = 512 * 1024;
  if (block_size & (block_size - 1)) return -14;
  int code = 0;
  while ((1ull << code) < block_size) code++;
  if (code < 12 || code > 21) return -14;
  if (*(uint32_t *)h == CCTX_SMAGIC) {
    ZxchCctxS *c = (ZxchCctxS *)h;
    c->level = level;
    c->bs = block_size;
    c->checksum = checksum ? 1 : 0;
    c->seekable = seekable ? 1 : 0;
    return 0;
  }
  ZxchCctx *c = (ZxchCctx *)h;
  c->level = level;
  c->bs = block_size;
  c->checksum = checksum ? 1 : 0;
  c->seekable = seekable ? 1 : 0;
  return 0;
}

// Attach (copy) a dictionary; packed128 = the .zxd 128-byte shared
// table (NULL for content-only). The id is computed here, once.
int zxch_cctx_attach_dict(void *h, const uint8_t *dict, uint64_t n,
                          const uint8_t *packed128) {
  if (*(uint32_t *)h == CCTX_SMAGIC) {
    ZxchCctxS *c = (ZxchCctxS *)h;
    if (!dict || !n) {
      c->dict_len = 0;
      c->dict_id = 0;
      c->has_cl = 0;
      return 0;
    }
    if (n > c->dict_cap || n > (1ull << 20)) return -17;
    memcpy(c->dictp(), dict, n);
    c->dict_len = n;
    c->has_cl = packed128 != nullptr;
    if (packed128)
      for (int i = 0; i < 128; i++) {
        c->cl()[2 * i] = (uint8_t)(packed128[i] & 0x0F);
        c->cl()[2 * i + 1] = (uint8_t)(packed128[i] >> 4);
      }
    c->dict_id = zxch_dict_id(dict, n, packed128);
    return 0;
  }
  ZxchCctx *c = (ZxchCctx *)h;
  if (!dict || !n) {
    c->dict.clear();
    c->cl256.clear();
    c->dict_id = 0;
    return 0;
  }
  int rc = ctx_attach(c->dict, c->cl256, dict, n, packed128);
  if (rc) return rc;
  c->dict_id = zxch_dict_id(dict, n, packed128);
  return 0;
}

// One-shot frame encode under the context's sticky options.
int64_t zxch_cctx_compress(void *h, const uint8_t *src, uint64_t n,
                           uint8_t *dst, uint64_t cap) {
  static const PsPar tab[7] = {
      {2, 0, 16, 1, 4, 4, 5},  {2, 0, 24, 1, 4, 4, 5},
      {5, 0, 32, 1, 5, 4, 5},  {8, 0, 64, 1, 0, 2, 5},
      {24, 1, 128, 1, 0, 2, 5}, {64, 1, 0, 1, 0, 1, 5},
      {192, 1, 0, 1, 0, 1, 5}};
  int level, checksum, seekable;
  uint64_t bs;
  const uint8_t *dp = nullptr, *clp = nullptr;
  uint64_t dn = 0;
  uint32_t did = 0;
  if (*(uint32_t *)h == CCTX_SMAGIC) {
    ZxchCctxS *c = (ZxchCctxS *)h;
    level = c->level; checksum = c->checksum; seekable = c->seekable;
    bs = c->bs;
    if (c->dict_len) { dp = c->dictp(); dn = c->dict_len; did = c->dict_id; }
    if (c->has_cl) clp = c->cl();
  } else {
    ZxchCctx *c = (ZxchCctx *)h;
    level = c->level; checksum = c->checksum; seekable = c->seekable;
    bs = c->bs;
    if (!c->dict.empty()) { dp = c->dict.data(); dn = c->dict.size();
                            did = c->dict_id; }
    if (!c->cl256.empty()) clp = c->cl256.data();
  }
  PsPar p = tab[level - 1];
  int code = 0;
  while ((1ull << code) < bs) code++;
  return zxch_compress_frame(
      src, n, level, p.probes, p.lazy, p.suff, p.sb, p.ss, p.cover,
      p.min_emit, bs, code, checksum, seekable,
      dp, dn, clp, did, dst, cap);
}

void zxch_cctx_free(void *h) {
  if (h && *(uint32_t *)h == CCTX_MAGIC) delete (ZxchCctx *)h;
  // static handles live in caller memory: free is a no-op
}

void *zxch_dctx_new(int verify) {
  ZxchDctx *d = new ZxchDctx();
  d->verify = verify ? 1 : 0;
  return d;
}

int zxch_dctx_attach_dict(void *h, const uint8_t *dict, uint64_t n,
                          const uint8_t *packed128) {
  if (*(uint32_t *)h == DCTX_SMAGIC) {
    ZxchDctxS *d = (ZxchDctxS *)h;
    if (!dict || !n) {
      d->dict_len = 0;
      d->has_cl = 0;
      return 0;
    }
    if (n > d->dict_cap || n > (1ull << 20)) return -17;
    memcpy(d->dictp(), dict, n);
    d->dict_len = n;
    d->has_cl = packed128 != nullptr;
    if (packed128)
      for (int i = 0; i < 128; i++) {
        d->cl()[2 * i] = (uint8_t)(packed128[i] & 0x0F);
        d->cl()[2 * i + 1] = (uint8_t)(packed128[i] >> 4);
      }
    return 0;
  }
  ZxchDctx *d = (ZxchDctx *)h;
  if (!dict || !n) {
    d->dict.clear();
    d->cl256.clear();
    return 0;
  }
  return ctx_attach(d->dict, d->cl256, dict, n, packed128);
}

// One-shot frame decode under the context's sticky options.
int64_t zxch_dctx_decompress(void *h, const uint8_t *src, uint64_t n,
                             uint8_t *dst, uint64_t cap) {
  if (*(uint32_t *)h == DCTX_SMAGIC) {
    ZxchDctxS *d = (ZxchDctxS *)h;
    return zxch_simple_decompress(
        src, n, dst, cap, d->dict_len ? d->dictp() : nullptr,
        d->dict_len, d->has_cl ? d->cl() : nullptr, d->verify);
  }
  ZxchDctx *d = (ZxchDctx *)h;
  return zxch_simple_decompress(
      src, n, dst, cap, d->dict.empty() ? nullptr : d->dict.data(),
      d->dict.size(), d->cl256.empty() ? nullptr : d->cl256.data(),
      d->verify);
}

void zxch_dctx_free(void *h) {
  if (h && *(uint32_t *)h == DCTX_MAGIC) delete (ZxchDctx *)h;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Dictionary trainer (reference: zxc_train_dict zxc_dict.c:337-495,
// zxc_train_dict_huf :529-622; algorithm mirror of codec/dict_train.py):
// sampled 5-gram frequency table -> greedy coverage-scored 64-byte segment
// selection -> reverse placement so the hottest bytes sit closest to the
// window; the shared literal table is trained on the REAL post-LZ literal
// histogram of the samples run through the level-6 parse with the trained
// dictionary attached. Exposed through the C ABI so every binding can
// train dictionaries (the reference's bindings all reach zxc_dict_train).
// Samples arrive flattened: `flat` = all sample bytes back to back,
// `sizes[i]` their lengths.
// ---------------------------------------------------------------------------

namespace {

// trainer-internal 5-byte gram hash folded to 20 bits (dict_train.py
// _gram_hash: xorshift64*-style mix; independent of the wire format)
inline uint32_t train_gram_hash(const uint8_t *p) {
  uint64_t v = (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16)
             | ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32);
  v *= 0x9E3779B97F4A7C15ull;
  v ^= v >> 29;
  v *= 0xBF58476D1CE4E5B9ull;
  v ^= v >> 32;
  return (uint32_t)(v >> 44);  // top 20 of the 64-bit mix
}

}  // namespace

extern "C" {

// Select dictionary content from samples. Returns content length (<=
// min(target_size, 65535)) or a negative ZXC error code.
int64_t zxch_train_dict(const uint8_t *flat, const uint64_t *sizes,
                        int n_samples, uint64_t target_size,
                        uint8_t *out, uint64_t cap) {
  const int KGRAM = 5, SEGMENT = 64, BITS = 20;
  if (!flat || !sizes || !out || n_samples <= 0 || target_size == 0)
    return -12;  // NULL_INPUT
  if (target_size > 65535) target_size = 65535;

  // 1. global gram frequency table
  std::vector<int64_t> table(1u << BITS, 0);
  std::vector<uint64_t> off((size_t)n_samples);
  uint64_t cum = 0;
  bool any = false;
  for (int i = 0; i < n_samples; i++) {
    off[(size_t)i] = cum;
    cum += sizes[i];
    if (sizes[i] >= (uint64_t)KGRAM) any = true;
  }
  if (!any) return -12;
  for (int i = 0; i < n_samples; i++) {
    if (sizes[i] < (uint64_t)KGRAM) continue;
    const uint8_t *a = flat + off[(size_t)i];
    uint64_t nh = sizes[i] - (KGRAM - 1);
    for (uint64_t p = 0; p < nh; p++) table[train_gram_hash(a + p)]++;
  }

  // 2. score 64-byte segments: sum of gram frequencies, each distinct
  // gram counted once per segment (coverage, not raw repetition)
  struct Seg { const uint8_t *data; uint32_t gram_off, n_grams;
               int64_t score; };
  std::vector<Seg> segs;
  std::vector<uint32_t> gram_pool;
  uint32_t tmp[SEGMENT];
  for (int i = 0; i < n_samples; i++) {
    if (sizes[i] < (uint64_t)KGRAM) continue;
    const uint8_t *a = flat + off[(size_t)i];
    uint64_t nh = sizes[i] - (KGRAM - 1);
    uint64_t n_seg = sizes[i] / SEGMENT;
    for (uint64_t k = 0; k < n_seg; k++) {
      uint64_t lo = k * SEGMENT;
      uint64_t hi = lo + SEGMENT < nh ? lo + SEGMENT : nh;
      if (hi <= lo) continue;
      uint32_t m = 0;
      for (uint64_t p = lo; p < hi; p++) tmp[m++] = train_gram_hash(a + p);
      std::sort(tmp, tmp + m);
      uint32_t u = (uint32_t)(std::unique(tmp, tmp + m) - tmp);
      int64_t score = 0;
      for (uint32_t q = 0; q < u; q++) score += table[tmp[q]];
      segs.push_back({a + lo, (uint32_t)gram_pool.size(), u, score});
      gram_pool.insert(gram_pool.end(), tmp, tmp + u);
    }
  }
  if (segs.empty()) return -12;

  // 3. greedy selection with coverage discount, walked highest-score
  // first (stable ascending sort iterated in reverse: deterministic tie
  // order); exact-duplicate segments skipped
  std::vector<uint32_t> order(segs.size());
  for (size_t i = 0; i < segs.size(); i++) order[i] = (uint32_t)i;
  std::stable_sort(order.begin(), order.end(), [&](uint32_t x, uint32_t y) {
    return segs[x].score < segs[y].score;
  });
  std::vector<bool> covered(1u << BITS, false);
  std::vector<uint64_t> seen;  // rapidhash64 of the 64 raw bytes
  std::vector<const uint8_t *> chosen;
  uint64_t total = 0;
  for (size_t oi = order.size(); oi-- > 0;) {
    if (total >= target_size) break;
    const Seg &s = segs[order[oi]];
    uint32_t fresh = 0;
    for (uint32_t q = 0; q < s.n_grams; q++)
      if (!covered[gram_pool[s.gram_off + q]]) fresh++;
    if ((uint64_t)fresh * 4 < s.n_grams) continue;  // mostly redundant
    uint64_t sig = zxch_rapidhash64(s.data, SEGMENT, 0x5E67);
    bool dup = false;
    for (uint64_t v : seen)
      if (v == sig) { dup = true; break; }
    if (dup && seen.size() < (1u << 16)) {
      // hash said duplicate: confirm byte-wise against every chosen
      // segment (collisions must not drop content)
      bool really = false;
      for (const uint8_t *c : chosen)
        if (!memcmp(c, s.data, SEGMENT)) { really = true; break; }
      if (really) continue;
    } else if (dup) {
      continue;
    }
    seen.push_back(sig);
    for (uint32_t q = 0; q < s.n_grams; q++)
      covered[gram_pool[s.gram_off + q]] = true;
    chosen.push_back(s.data);
    total += SEGMENT;
  }
  if (chosen.empty()) chosen.push_back(segs[order.back()].data);

  // 4. reverse placement (hottest last), tail-trimmed to target
  uint64_t full_len = (uint64_t)chosen.size() * SEGMENT;
  uint64_t out_len = full_len < target_size ? full_len : target_size;
  if (out_len > cap) return -2;  // DST_TOO_SMALL
  uint64_t skip = full_len - out_len;  // bytes dropped from the front
  uint64_t w = 0;
  for (size_t ci = chosen.size(); ci-- > 0;) {
    const uint8_t *seg = chosen[ci];
    uint64_t lo = 0, n = SEGMENT;
    if (skip) {
      uint64_t cut = skip < n ? skip : n;
      lo += cut; n -= cut; skip -= cut;
    }
    if (n) { memcpy(out + w, seg + lo, n); w += n; }
  }
  return (int64_t)w;
}

// Shared literal table: level-6 parse of every sample block with the
// dictionary window attached, literal histogram (+1 smoothing so decode
// never hits a hole), 8-bit-capped package-merge lengths, nibble-packed
// into out_table[128]. Returns 0 or a negative error.
int64_t zxch_train_dict_huf(const uint8_t *flat, const uint64_t *sizes,
                            int n_samples, const uint8_t *content,
                            uint64_t content_len, uint8_t *out_table) {
  if (!flat || !sizes || !out_table || n_samples <= 0) return -12;
  if (content_len > 65535) return -17;  // DICT_TOO_LARGE
  const uint64_t BS = 512 * 1024;  // BLOCK_SIZE_DEFAULT
  const int L6_PROBES = 64;
  uint64_t freq[256];
  for (int s = 0; s < 256; s++) freq[s] = 1;  // smoothing
  std::vector<uint8_t> full(content_len + BS);
  if (content_len) memcpy(full.data(), content, content_len);
  uint64_t cum = 0;
  for (int i = 0; i < n_samples; i++) {
    const uint8_t *a = flat + cum;
    cum += sizes[i];
    for (uint64_t pos = 0; pos < sizes[i]; pos += BS) {
      uint64_t len = sizes[i] - pos < BS ? sizes[i] - pos : BS;
      memcpy(full.data() + content_len, a + pos, len);
      uint64_t n = content_len + len;
      const uint8_t *blk = full.data() + content_len;
      // level-6 first-candidate parse (mirror of zxch_encode_glo_opt's
      // pass 1 / _build_sequences level>=6)
      std::vector<int32_t> lens(len), offs(len);
      zxch_find_matches(full.data(), n, content_len, L6_PROBES,
                        lens.data(), offs.data());
      uint64_t max_seq = len / 5 + 8;
      std::vector<int32_t> mp(max_seq), ml(max_seq), mo(max_seq);
      uint16_t cost[256];
      int64_t g = zxch_lazy_parse(lens.data(), offs.data(), len, 1, 5,
                                  mp.data(), ml.data(), mo.data(), max_seq);
      if (g < 0) return -10;
      {
        uint64_t f1[256];
        memset(f1, 0, sizeof(f1));
        int64_t cursor = 0;
        for (int64_t q = 0; q < g; q++) {
          for (int64_t t = cursor; t < mp[(size_t)q]; t++) f1[blk[t]]++;
          cursor = mp[(size_t)q] + ml[(size_t)q];
        }
        for (int64_t t = cursor; t < (int64_t)len; t++) f1[blk[t]]++;
        uint8_t cl1[256];
        if (zxch_build_code_lengths(f1, 8, cl1) > 0) {
          for (int s2 = 0; s2 < 256; s2++)
            cost[s2] = cl1[s2] ? cl1[s2] : (uint16_t)10;
        } else {
          for (int s2 = 0; s2 < 256; s2++) cost[s2] = 8;
        }
      }
      int64_t ns = zxch_optimal_parse(lens.data(), offs.data(), len, blk,
                                      cost, 8, 0, nullptr, mp.data(),
                                      ml.data(), mo.data(), max_seq);
      if (ns < 0) return -10;
      int64_t cursor = 0;
      for (int64_t q = 0; q < ns; q++) {
        for (int64_t t = cursor; t < mp[(size_t)q]; t++) freq[blk[t]]++;
        cursor = mp[(size_t)q] + ml[(size_t)q];
      }
      for (int64_t t = cursor; t < (int64_t)len; t++) freq[blk[t]]++;
    }
  }
  uint8_t cl[256];
  if (zxch_build_code_lengths(freq, 8, cl) <= 0) return -10;
  for (int s = 0; s < 256; s += 2)
    out_table[s / 2] = (uint8_t)((cl[s] & 0x0F) | (cl[s + 1] << 4));
  return 0;
}

// One-shot trainer emitting a complete .zxd blob (16-byte header +
// content + 128-byte shared table; dictionary.py Dictionary.save /
// FORMAT.md section 12). Returns the blob size or a negative error.
int64_t zxch_dict_train(const uint8_t *flat, const uint64_t *sizes,
                        int n_samples, uint64_t target_size,
                        uint8_t *out, uint64_t cap) {
  uint8_t content[65536];
  int64_t cl_len = zxch_train_dict(flat, sizes, n_samples, target_size,
                                   content, sizeof(content));
  if (cl_len < 0) return cl_len;
  uint8_t table[128];
  int64_t rc = zxch_train_dict_huf(flat, sizes, n_samples, content,
                                   (uint64_t)cl_len, table);
  if (rc < 0) return rc;
  uint64_t need = 16 + (uint64_t)cl_len + 128;
  if (cap < need) return -2;
  uint32_t id = zxch_dict_id(content, (uint64_t)cl_len, table);
  uint8_t hdr[16];
  memset(hdr, 0, 16);
  uint32_t magic = 0x9CB0D1C7u;
  memcpy(hdr, &magic, 4);
  hdr[4] = 1;                      // DICT_FORMAT_VERSION
  hdr[5] = 0;                      // CHECKSUM_RAPIDHASH
  uint16_t csz = (uint16_t)cl_len;
  memcpy(hdr + 6, &csz, 2);
  memcpy(hdr + 8, &id, 4);
  uint16_t h16 = zxch_hash16(hdr);  // bytes 12..15 still zero
  memcpy(hdr + 14, &h16, 2);
  memcpy(out, hdr, 16);
  memcpy(out + 16, content, (size_t)cl_len);
  memcpy(out + 16 + cl_len, table, 128);
  return (int64_t)need;
}

}  // extern "C"

// ===========================================================================
// The port's own entries. Everything above this banner is the JAX
// package's runtime/zxc_host.cpp verbatim; what follows exists in this
// copy alone.
// ===========================================================================

#include <chrono>

// ---------------------------------------------------------------------------
// Block emission from given sequences (the device encoder's host half):
// block header, payload and checksum of one dictionary-free block in one
// call, byte-identical with block_encode.encode_chunk_plain on the same
// sequences. Levels 2-7 run their own GLO emitter rather than glo_emit,
// for two reasons: its stages are timed apart (the sequence streams, the
// literal auction), and its entropy candidates follow the Python auction
// where glo_emit differs from it (a section of one symbol value is priced
// as a one-bit Huffman code). The all-literal candidate is
// zxch_encode_hufflit without its sampled pre-gate, which can drop a
// candidate that wins.
// ---------------------------------------------------------------------------
namespace {

struct EmitScratch {
  std::vector<int32_t> mp, ml, mo;
  std::vector<uint8_t> lit, rle, huf, tok, tokh, off, ext, pay, alt;
};
thread_local EmitScratch g_emit;

template <class T>
T *grow(std::vector<T> &v, uint64_t n) {
  if (v.size() < n) v.resize(n);
  return v.data();
}

struct StageClock {
  std::chrono::steady_clock::time_point t = std::chrono::steady_clock::now();
  // seconds since the last call (or the clock's start)
  double lap() {
    auto now = std::chrono::steady_clock::now();
    double s = std::chrono::duration<double>(now - t).count();
    t = now;
    return s;
  }
};

inline uint8_t *put_varint(uint8_t *w, int64_t v) {
  if (v < 0x80) {
    *w++ = (uint8_t)v;
  } else if (v < 0x4000) {
    *w++ = (uint8_t)(0x80 | (v & 0x3F));
    *w++ = (uint8_t)((v >> 6) & 0xFF);
  } else {
    *w++ = (uint8_t)(0xC0 | (v & 0x1F));
    *w++ = (uint8_t)((v >> 5) & 0xFF);
    *w++ = (uint8_t)((v >> 13) & 0xFF);
  }
  return w;
}

inline int varint_size(int64_t v) {
  return v < 0x80 ? 1 : (v < 0x4000 ? 2 : 3);
}

inline void pack_lengths(const uint8_t *cl, uint8_t *w) {
  for (int b = 0; b < 128; b++)
    w[b] = (uint8_t)((cl[2 * b] & 0x0F) | (cl[2 * b + 1] << 4));
}

// Size of the Huffman section of sym[0..n) under the code lengths `cl`,
// its inline lengths table included, or -1 where the code is refused
int64_t huffman_size(const uint8_t *sym, uint64_t n, const uint64_t *freq,
                     const uint8_t *cl) {
  int64_t sz = zxch_pivco_size_f(sym, n, cl, freq);
  return sz < 0 ? -1 : 128 + sz;
}

// Writes that section (`size` bytes, as huffman_size gave it) to `out`;
// false where the encoder disagrees with the size
bool huffman_write(const uint8_t *sym, uint64_t n, const uint64_t *freq,
                   const uint8_t *cl, int64_t size, uint8_t *out,
                   uint64_t cap) {
  pack_lengths(cl, out);
  return zxch_pivco_encode_f(sym, n, cl, freq, out + 128, cap - 128)
         == size - 128;
}

// The GLO payload of a parse (block_encode._glo_payload without a
// dictionary): the premiums and code caps of `level`, the token section's
// Huffman candidate at level 7. Adds the stages' seconds to st[1]
// (streams) and st[2] (literal auction).
int64_t emit_glo(const uint8_t *data, uint64_t P, const int32_t *mp,
                 const int32_t *ml, const int32_t *mo, int64_t nseq,
                 int level, uint8_t *out, uint64_t cap, double *st) {
  EmitScratch &S = g_emit;
  StageClock clk;
  const int prem_rle = level >= 6 ? 1 : 8;
  const int prem_huf = level >= 6 ? 4 : 8;
  const int max_len = level >= 7 ? 11 : 8;

  // the streams: literals gathered (32-byte chunks while the block has
  // them; the buffer's slack takes the overshoot), tokens, offsets and
  // extras in sequence order
  uint64_t lit_total = P, n_ext = 0;
  int64_t max_off = 1;
  for (int64_t i = 0, cursor = 0; i < nseq; i++) {
    int64_t llv = mp[i] - cursor, mlb = ml[i] - 5;
    cursor = mp[i] + ml[i];
    lit_total -= (uint64_t)ml[i];
    if (llv >= 15) n_ext += varint_size(llv - 15);
    if (mlb >= 15) n_ext += varint_size(mlb - 15);
    if (mo[i] > max_off) max_off = mo[i];
  }
  const bool use8 = nseq == 0 || max_off <= 256;
  const uint64_t off_bytes = (use8 ? 1 : 2) * (uint64_t)nseq;
  uint8_t *lit = grow(S.lit, lit_total + 32);
  uint8_t *tok = grow(S.tok, (uint64_t)nseq + 1);
  uint8_t *offw = grow(S.off, off_bytes + 1);
  uint8_t *ext = grow(S.ext, n_ext + 1);
  {
    const uint8_t *end = data + P;
    uint8_t *lw = lit, *ew = ext;
    int64_t cursor = 0;
    for (int64_t i = 0; i < nseq; i++) {
      int64_t llv = mp[i] - cursor, mlb = ml[i] - 5;
      const uint8_t *s = data + cursor;
      if (s + llv + 32 <= end) {
        for (int64_t k = 0; k < llv; k += 32) memcpy(lw + k, s + k, 32);
      } else {
        memcpy(lw, s, (size_t)llv);
      }
      lw += llv;
      cursor = mp[i] + ml[i];
      tok[i] = (uint8_t)(((llv < 15 ? llv : 15) << 4) | (mlb < 15 ? mlb : 15));
      uint32_t ob = (uint32_t)(mo[i] - 1);
      if (use8) {
        offw[i] = (uint8_t)ob;
      } else {
        offw[2 * i] = (uint8_t)(ob & 0xFF);
        offw[2 * i + 1] = (uint8_t)(ob >> 8);
      }
      if (llv >= 15) ew = put_varint(ew, llv - 15);
      if (mlb >= 15) ew = put_varint(ew, mlb - 15);
    }
    memcpy(lw, data + cursor, (size_t)((int64_t)P - cursor));
  }
  st[1] += clk.lap();

  // the literal auction, priced J = size + (n * premium) >> 8: RAW, RLE,
  // then from 139 literals Huffman with its inline table
  int enc_lit = 0;
  const uint8_t *lit_sec = lit;
  uint64_t lit_len = lit_total;
  int64_t best_j = (int64_t)lit_total;
  if (lit_total > 0) {
    uint8_t *rle = grow(S.rle, 2 * lit_total + 8);
    int64_t rn = ghi_rle_encode(lit, lit_total, rle, 2 * lit_total + 8);
    int64_t j = rn + (int64_t)((lit_total * (uint64_t)prem_rle) >> 8);
    if (rn >= 0 && j < best_j) {
      enc_lit = 1, lit_sec = rle, lit_len = (uint64_t)rn, best_j = j;
    }
    if (lit_total >= 139) {
      uint64_t freq[256];
      uint8_t cl[256];
      zxch_hist4(lit, lit_total, freq);
      const int64_t tax = (int64_t)((lit_total * (uint64_t)prem_huf) >> 8);
      if (zxch_build_code_lengths(freq, max_len, cl) >= 1) {
        uint64_t bits = 0;
        for (int s = 0; s < 256; s++) bits += freq[s] * cl[s];
        // sound skip: per-node byte rounding only adds to bits / 8
        if (128 + (int64_t)(bits >> 3) + tax < best_j) {
          uint64_t hcap = 2 * lit_total + 4096 + 128;
          uint8_t *huf = grow(S.huf, hcap);
          int64_t hn = huffman_size(lit, lit_total, freq, cl);
          if (hn >= 0 && hn + tax < best_j &&
              huffman_write(lit, lit_total, freq, cl, hn, huf, hcap)) {
            enc_lit = 2, lit_sec = huf, lit_len = (uint64_t)hn;
            best_j = hn + tax;
          }
        }
      }
    }
  }
  st[2] += clk.lap();

  // the token section's Huffman candidate (level 7)
  int enc_tok = 0;
  const uint8_t *tok_sec = tok;
  uint64_t tok_len = (uint64_t)nseq;
  if (level >= 7 && nseq >= 139) {
    uint64_t tfreq[256];
    uint8_t tcl[256];
    zxch_hist4(tok, (uint64_t)nseq, tfreq);
    int64_t tn = zxch_build_code_lengths(tfreq, max_len, tcl) >= 1
        ? huffman_size(tok, (uint64_t)nseq, tfreq, tcl) : -1;
    if (tn >= 0 && tn + (int64_t)(((uint64_t)nseq * prem_huf) >> 8) < nseq) {
      uint64_t hcap = 2 * (uint64_t)nseq + 4096 + 128;
      uint8_t *tokh = grow(S.tokh, hcap);
      if (huffman_write(tok, (uint64_t)nseq, tfreq, tcl, tn, tokh, hcap)) {
        enc_tok = 2, tok_sec = tokh, tok_len = (uint64_t)tn;
      }
    }
  }
  clk.lap();

  uint64_t need = 16 + 32 + lit_len + tok_len + off_bytes + n_ext;
  if (need > cap) return -10;
  uint8_t *w = out;
  uint32_t u = (uint32_t)nseq;
  memcpy(w, &u, 4);
  u = (uint32_t)lit_total;
  memcpy(w + 4, &u, 4);
  w[8] = (uint8_t)enc_lit;
  w[9] = (uint8_t)enc_tok;
  w[10] = 0;
  w[11] = use8 ? 1 : 0;
  memset(w + 12, 0, 4);
  uint64_t d = lit_len | ((uint64_t)lit_total << 32);
  memcpy(w + 16, &d, 8);
  d = tok_len | ((uint64_t)nseq << 32);
  memcpy(w + 24, &d, 8);
  d = off_bytes | (off_bytes << 32);
  memcpy(w + 32, &d, 8);
  d = n_ext | (n_ext << 32);
  memcpy(w + 40, &d, 8);
  w += 48;
  memcpy(w, lit_sec, lit_len);
  w += lit_len;
  memcpy(w, tok_sec, tok_len);
  w += tok_len;
  memcpy(w, offw, off_bytes);
  w += off_bytes;
  memcpy(w, ext, n_ext);
  st[1] += clk.lap();
  return (int64_t)need;
}

// block_encode.encode_block_hufflit: the sequence-free GLO payload with
// Huffman literals, or -1 unless strictly smaller than `budget`
int64_t emit_hufflit(const uint8_t *data, uint64_t P, uint8_t *out,
                     uint64_t cap, uint64_t budget) {
  const uint64_t FIXED = 16 + 32 + 128;
  if (FIXED + (P + 7) / 8 >= budget) return -1;
  uint64_t freq[256];
  uint8_t cl[256];
  zxch_hist4(data, P, freq);
  if (zxch_build_code_lengths(freq, 8, cl) < 2) return -1;
  uint64_t bits = 0;
  for (int s = 0; s < 256; s++) bits += freq[s] * cl[s];
  if (FIXED + (bits + 7) / 8 >= budget) return -1;
  int64_t pay = zxch_pivco_size_f(data, P, cl, freq);
  if (pay < 0 || FIXED + (uint64_t)pay >= budget) return -1;
  uint64_t need = FIXED + (uint64_t)pay;
  if (need > cap) return -10;
  pack_lengths(cl, out + 48);
  if (zxch_pivco_encode_f(data, P, cl, freq, out + FIXED, cap - FIXED) != pay)
    return -10;
  uint32_t u = 0;
  memcpy(out, &u, 4);
  u = (uint32_t)P;
  memcpy(out + 4, &u, 4);
  out[8] = 2;   // enc_lit HUFFMAN
  out[9] = 0;
  out[10] = 0;
  out[11] = 1;  // 8-bit offsets (none)
  memset(out + 12, 0, 4);
  uint64_t d = (128 + (uint64_t)pay) | ((uint64_t)P << 32);
  memcpy(out + 16, &d, 8);
  memset(out + 24, 0, 24);
  return (int64_t)need;
}

// first q >= from where data[q] != data[q - off], or n (LZ semantics: the
// copy reads its own output)
uint64_t extend_match(const uint8_t *data, uint64_t n, uint64_t from,
                      uint64_t off) {
  uint64_t q = from;
  while (q + 8 <= n) {
    uint64_t a, b;
    memcpy(&a, data + q, 8);
    memcpy(&b, data + q - off, 8);
    if (a != b) return q + (__builtin_ctzll(a ^ b) >> 3);
    q += 8;
  }
  while (q < n && data[q] == data[q - off]) q++;
  return q;
}

}  // namespace

extern "C" {

// One dictionary-free block from given sequences (pos, len, off: block
// coordinates, ascending, len >= 5, 1 <= off <= pos, off <= 64 KiB):
// block header, payload and, with `checksum`, the payload's rapidhash32,
// written to out (cap >= n + 12). Sequences of length >= cap_len (0: none)
// are the LCP matcher's capped lengths: each is extended forward against
// the plaintext and the sequences it swallows are dropped
// (ops.encode._extend_capped_host). Level 1 emits GHI against the
// all-literal Huffman candidate, levels 2-5 GLO against it, levels 6-7
// GLO alone (levels outside 1-7 clamp); RAW where the block would expand.
// stage_s[0..4) receives the seconds of the cap extension (with the
// sequences' checks), the streams, the literal auction and the
// all-literal candidate. Returns the bytes written, or a negative error
// code: -2 (out too small), -8 (a sequence out of order or out of the
// block), -9 (an offset out of range), -14 (a block over 2 MiB).
int64_t zxch_emit_block(const uint8_t *data, uint64_t n, int level,
                        int checksum, const int64_t *pos,
                        const int64_t *len, const int64_t *off, uint64_t nseq,
                        int64_t cap_len, uint8_t *out, uint64_t cap,
                        double *stage_s) {
  const uint64_t BH = 8;
  EmitScratch &S = g_emit;
  StageClock clk;
  for (int k = 0; k < 4; k++) stage_s[k] = 0;
  if (n > (1u << 21)) return -14;
  if (cap < n + BH + 4) return -2;
  level = level < 1 ? 1 : (level > 7 ? 7 : level);

  int32_t *mp = grow(S.mp, nseq + 1);
  int32_t *ml = grow(S.ml, nseq + 1);
  int32_t *mo = grow(S.mo, nseq + 1);
  int64_t m = 0, prev_end = 0, cursor = 0;
  for (uint64_t i = 0; i < nseq; i++) {
    int64_t p = pos[i], l = len[i], o = off[i];
    if (p < prev_end || l < 5 || l > (int64_t)n - p) return -8;
    if (o < 1 || o > p || o > 65536) return -9;
    prev_end = p + l;
    if (p < cursor) continue;  // swallowed by an extended match
    if (cap_len > 0 && l >= cap_len)
      l = (int64_t)extend_match(data, n, (uint64_t)(p + l), (uint64_t)o) - p;
    mp[m] = (int32_t)p;
    ml[m] = (int32_t)l;
    mo[m] = (int32_t)o;
    m++;
    cursor = p + l;
  }
  stage_s[0] = clk.lap();

  // candidates are emitted after the block header's room; a payload that
  // does not fit before the checksum's room is RAW anyway
  uint8_t *pay = out + BH;
  const uint64_t pcap = cap - BH - 4;
  const uint64_t raw_budget = n > BH ? n - BH : 0;
  int64_t psz = -1;
  int btype = 1;
  if (level <= 1) {
    uint64_t lit_total, n_ext;
    uint64_t need = zxch_ghi_size(mp, ml, m, n, &lit_total, &n_ext);
    uint64_t budget = need < raw_budget ? need : raw_budget;
    stage_s[1] += clk.lap();
    uint8_t *alt = grow(S.alt, n + 1024);
    int64_t hl = emit_hufflit(data, n, alt, n + 1024, budget);
    stage_s[3] = clk.lap();
    if (hl >= 0) {
      memcpy(pay, alt, (size_t)hl);
      psz = hl;
    } else if (need <= pcap) {
      psz = zxch_emit_ghi(data, 0, n, mp, ml, mo, m, lit_total, n_ext, pay);
      btype = 2;
      stage_s[1] += clk.lap();
    }
  } else {
    uint64_t gcap = 2 * n + 6 * (uint64_t)m + 4096;
    uint8_t *glo = grow(S.pay, gcap);
    int64_t g = emit_glo(data, n, mp, ml, mo, m, level, glo, gcap, stage_s);
    const uint8_t *win = g >= 0 && (uint64_t)g <= pcap ? glo : nullptr;
    psz = win ? g : -1;
    if (level <= 5) {
      uint64_t budget = g >= 0 && (uint64_t)g < raw_budget ? (uint64_t)g
                                                           : raw_budget;
      uint8_t *alt = grow(S.alt, n + 1024);
      clk.lap();
      int64_t hl = emit_hufflit(data, n, alt, n + 1024, budget);
      stage_s[3] = clk.lap();
      if (hl >= 0) win = alt, psz = hl;
    }
    if (win) memcpy(pay, win, (size_t)psz);
  }
  if (psz < 0 || BH + (uint64_t)psz >= n) {
    memcpy(pay, data, n);
    psz = (int64_t)n;
    btype = 0;
  }
  memset(out, 0, BH);
  out[0] = (uint8_t)btype;
  uint32_t u = (uint32_t)psz;
  memcpy(out + 3, &u, 4);
  out[7] = zxch_hash8(out);
  uint64_t w = BH + (uint64_t)psz;
  if (checksum) {
    u = zxch_rapidhash32(pay, (size_t)psz, 0);
    memcpy(out + w, &u, 4);
    w += 4;
  }
  return (int64_t)w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Level 7 from per-position candidates (the device encoder's host half at
// the archival level): the block's best (length, offset) at every position,
// as the device matcher measured them, through zxch_encode_glo_opt's
// level-7 pipeline from its lazy first pass on, then the block header, the
// payload and the checksum, byte-identical with the Python pipeline of
// block_encode on the same candidates (_first_pass_costs, the DP passes,
// _token_costs, the _glo_payload auction). zxch_opt_group runs a dispatch
// group's blocks on threads of its own, so that its caller crosses into
// native code once a group.
// ---------------------------------------------------------------------------
namespace {

struct OptScratch {
  std::vector<int32_t> lens, offs, mp[4], ml[4], mo[4];
  std::vector<uint8_t> pay[2];
};
thread_local OptScratch g_opt;

// Lengths at the LCP cap and over made exact against the plaintext, in one
// backward sweep: a capped position whose next position is capped with the
// same offset is one longer than it; the last position of such a run is
// measured byte by byte. Returns the positions that end past the cap.
int64_t extend_capped(const uint8_t *data, uint64_t n, int32_t *lens,
                      const int32_t *offs, int32_t cap_len) {
  int64_t past = 0;
  for (int64_t p = (int64_t)n - 1; p >= 0; p--) {
    int32_t l = lens[p];
    if (l < cap_len) continue;
    if (p + 1 < (int64_t)n && lens[p + 1] >= cap_len && offs[p + 1] == offs[p])
      lens[p] = lens[p + 1] + 1;
    else
      lens[p] = (int32_t)(extend_match(data, n, (uint64_t)(p + l),
                                       (uint64_t)offs[p]) - p);
    past += lens[p] > cap_len;
  }
  return past;
}

// One block of zxch_opt_group from its packed candidates, as that entry
// documents it.
int64_t opt_block(const uint8_t *data, uint64_t n, int checksum,
                  const int32_t *packed, int32_t cap_len, uint8_t *out,
                  uint64_t cap, double *stage_s, int64_t *counts) {
  const uint64_t BH = 8;
  const int maxlen = 11, tok_bits = 5, level = 7;
  OptScratch &S = g_opt;
  StageClock clk;
  for (int k = 0; k < 6; k++) stage_s[k] = 0;
  counts[0] = counts[1] = 0;
  if (n > (1u << 21)) return -14;
  if (cap < n + BH + 4) return -2;
  int32_t *lens = grow(S.lens, n + 1), *offs = grow(S.offs, n + 1);
  for (uint64_t p = 0; p < n; p++) {
    uint32_t c = (uint32_t)packed[p];
    int32_t l = (int32_t)(c >> 16), o = (int32_t)(c & 0xFFFF) + 1;
    if (l >= 5) {
      if ((uint64_t)l > n - p) return -8;
      if ((uint64_t)o > p) return -9;
    }
    lens[p] = l;
    offs[p] = o;
  }
  if (cap_len > 0) counts[1] = extend_capped(data, n, lens, offs, cap_len);
  stage_s[0] = clk.lap();

  const uint64_t max_seq = n / 5 + 8;
  int32_t *mp[4], *ml[4], *mo[4];
  for (int c = 0; c < 4; c++) {
    mp[c] = grow(S.mp[c], max_seq);
    ml[c] = grow(S.ml[c], max_seq);
    mo[c] = grow(S.mo[c], max_seq);
  }

  // the literal prices: the lazy first pass's literal histogram
  uint16_t cost[256];
  {
    int64_t g = zxch_lazy_parse(lens, offs, n, 1, 5, mp[0], ml[0], mo[0],
                                max_seq);
    if (g < 0) return -10;
    uint64_t freq[256];
    memset(freq, 0, sizeof(freq));
    int64_t cursor = 0;
    for (int64_t i = 0; i < g; i++) {
      for (int64_t q = cursor; q < mp[0][i]; q++) freq[data[q]]++;
      cursor = mp[0][i] + ml[0][i];
    }
    for (int64_t q = cursor; q < (int64_t)n; q++) freq[data[q]]++;
    uint8_t cl[256];
    bool flat = zxch_build_code_lengths(freq, maxlen, cl) <= 0;
    if (!flat) {
      // the regime check: literals that the auction will ship RAW
      // priced at 8 bits
      uint64_t tot = 0, hb = 0;
      for (int s = 0; s < 256; s++) tot += freq[s], hb += freq[s] * cl[s];
      flat = hb + 128 * 8 >= tot * 8;
    }
    for (int s = 0; s < 256; s++)
      cost[s] = flat ? 8 : (cl[s] ? cl[s] : (uint16_t)(maxlen + 2));
  }
  stage_s[4] = clk.lap();

  // the parses: pass 1, the re-priced pass 2, the 8-bit-offset pass
  int64_t np[4];
  int n_cands = 0;
  np[0] = zxch_optimal_parse(lens, offs, n, data, cost, tok_bits, 0, nullptr,
                             mp[0], ml[0], mo[0], max_seq);
  if (np[0] < 0) return -10;
  n_cands = 1;
  if (np[0] >= 64) {
    uint64_t tfreq[256];
    memset(tfreq, 0, sizeof(tfreq));
    double pll[16] = {0};
    int64_t cursor = 0;
    for (int64_t i = 0; i < np[0]; i++) {
      int64_t llv = mp[0][i] - cursor, mlb = ml[0][i] - 5;
      cursor = mp[0][i] + ml[0][i];
      int nl = llv < 15 ? (int)llv : 15;
      int nm = mlb < 15 ? (int)mlb : 15;
      tfreq[(nl << 4) | nm]++;
      pll[nl] += 1.0;
    }
    uint8_t tcl[256];
    if (zxch_build_code_lengths(tfreq, 8, tcl) > 0) {
      double tot = 0;
      for (int l = 0; l < 16; l++) tot += pll[l];
      if (tot < 1.0) tot = 1.0;
      uint16_t tok16[16];
      for (int m = 0; m < 16; m++) {
        double e = 0;
        for (int l = 0; l < 16; l++)
          e += (pll[l] / tot) * (tcl[(l << 4) | m] ? tcl[(l << 4) | m] : 10.0);
        tok16[m] = (uint16_t)nearbyint(e);
      }
      np[1] = zxch_optimal_parse(lens, offs, n, data, cost, tok_bits, 0,
                                 tok16, mp[1], ml[1], mo[1], max_seq);
      if (np[1] >= 0 &&
          (np[1] != np[0] || memcmp(mp[1], mp[0], np[0] * 4) ||
           memcmp(ml[1], ml[0], np[0] * 4) || memcmp(mo[1], mo[0], np[0] * 4)))
        n_cands = 2;
    }
  }
  bool any16 = false;
  for (int c = 0; c < n_cands && !any16; c++)
    for (int64_t i = 0; i < np[c]; i++)
      if (mo[c][i] > 256) { any16 = true; break; }
  if (any16) {
    np[n_cands] = zxch_optimal_parse(lens, offs, n, data, cost, tok_bits, 1,
                                     nullptr, mp[n_cands], ml[n_cands],
                                     mo[n_cands], max_seq);
    if (np[n_cands] >= 0) n_cands++;
  }
  stage_s[5] = clk.lap();

  // the auction: each parse emitted, the smallest payload kept
  const uint64_t gcap = 2 * n + 6 * max_seq + 4096;
  uint8_t *best = grow(S.pay[0], gcap), *alt = grow(S.pay[1], gcap);
  int64_t best_n = -1;
  for (int c = 0; c < n_cands; c++) {
    int64_t g = emit_glo(data, n, mp[c], ml[c], mo[c], np[c], level, alt,
                         gcap, stage_s);
    if (g >= 0 && (best_n < 0 || g < best_n)) {
      std::swap(best, alt);
      best_n = g;
    }
  }
  counts[0] = n_cands;
  clk.lap();

  uint8_t *pay = out + BH;
  int btype = 1;
  int64_t psz = best_n;
  if (psz < 0 || BH + (uint64_t)psz >= n) {
    memcpy(pay, data, n);
    psz = (int64_t)n;
    btype = 0;
  } else {
    memcpy(pay, best, (size_t)psz);
  }
  memset(out, 0, BH);
  out[0] = (uint8_t)btype;
  uint32_t u = (uint32_t)psz;
  memcpy(out + 3, &u, 4);
  out[7] = zxch_hash8(out);
  uint64_t w = BH + (uint64_t)psz;
  if (checksum) {
    u = zxch_rapidhash32(pay, (size_t)psz, 0);
    memcpy(out + w, &u, 4);
    w += 4;
  }
  stage_s[1] += clk.lap();
  return (int64_t)w;
}

}  // namespace

extern "C" {

// The dictionary-free level-7 blocks of a dispatch group from their
// per-position candidates, on `threads` threads of this call. Block j is
// data[j*block_size, min((j+1)*block_size, n)); its candidates are
// packed[j*block_size...], one int32 a position, len << 16 | (off - 1):
// len < 5 is no match, else 1 <= off <= min(p, 65536) and len <= n - p.
// Lengths of cap_len and over (0: none) are first made exact
// (extend_capped). Then, as zxch_encode_glo_opt at level 7: the lazy first
// pass and its literal histogram price literals (flat 8 bits where Huffman
// would lose to RAW), DP pass 1 with 5-bit tokens and 11-bit codes, from
// 64 sequences the DP re-priced with pass 1's token tree, the 8-bit-offset
// DP where a parse has an offset over 256; each parse is emitted
// (emit_glo) and the smallest payload wins, the first on ties; RAW where
// the block would expand. Block j's header, payload and, with `checksum`,
// the payload's rapidhash32 go to out + j*out_stride (out_stride >=
// block_size + 12), its size to out_len[j]; stage_s[6j..6j+6) receives
// the seconds of the candidates' check and cap extension, the streams and
// the literal auctions (summed over the parses), the all-literal candidate
// (none at level 7: 0), the first pass with the cost table, and the DP
// passes; counts[2j..2j+2) the parses emitted and the positions extended
// past the cap. Returns 0, or the error of the first block that failed:
// -2 (out_stride too small), -8 (a length past the block), -9 (an offset
// out of range), -10 (an internal buffer too small), -14 (a block over 2
// MiB).
int64_t zxch_opt_group(const uint8_t *data, uint64_t n, uint64_t block_size,
                       int checksum, const int32_t *packed, int32_t cap_len,
                       uint8_t *out, uint64_t out_stride, int64_t *out_len,
                       double *stage_s, int64_t *counts, int threads) {
  if (block_size == 0) return -2;
  const uint64_t nb = (n + block_size - 1) / block_size;
  std::atomic<uint64_t> next{0};
  auto work = [&]() {
    for (uint64_t j; (j = next.fetch_add(1)) < nb;) {
      uint64_t s = j * block_size, len = std::min(block_size, n - s);
      out_len[j] = opt_block(data + s, len, checksum, packed + s, cap_len,
                             out + j * out_stride, out_stride,
                             stage_s + 6 * j, counts + 2 * j);
    }
  };
  uint64_t nt = std::min<uint64_t>(threads < 1 ? 1 : threads, nb);
  std::vector<std::thread> pool;
  for (uint64_t t = 1; t < nt; t++) pool.emplace_back(work);
  work();
  for (auto &th : pool) th.join();
  for (uint64_t j = 0; j < nb; j++)
    if (out_len[j] < 0) return out_len[j];
  return 0;
}

}  // extern "C"
