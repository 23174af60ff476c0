// Shared device code of the two affinity kernels (affinity_valid.cu and
// bulk_decide.cu): one kernel template, `cells<kBulk, kWords>`, that computes
// the Listing-1 validity of every (row, worker) cell in a single launch and,
// for bulk_decide, the float32 strategy score and the per-row first-minimum
// winner too.
//
// The TPU kernels count affinity violations as two 0/1 float32 matmuls over
// the tag axis.  A cell is valid only if that count is 0, so here the masks
// are packed 32 tags to a 32-bit word and a cell needs no count at all:
//
//   empty[w, k]   bit b set iff occ[w, 32k + b] == 0          (worker side)
//   pos[r, k]     bit b set iff aff[r, 32k + b] == +1         (row side)
//   neg[r, k]     bit b set iff aff[r, 32k + b] == -1
//   violated      = OR_k (pos & empty) | (neg & ~empty)       (two LOP3s)
//
// Bits past T are 0 in pos and neg, so they never violate.  "violated != 0"
// is exactly "the reference's violation count != 0".  Tensor cores do not
// serve: there is no multiply-add left, and the two bit operations a word
// are under the integer rate at every shape (the source notes of the two
// kernels say what bounds each).
//
// Layout of a launch.  A block owns a tile of kTileWorkers = 128 consecutive
// workers and up to kBlockRows = 512 rows (grid.y covers more rows).  Lane l
// of every warp owns the tile's workers 4l .. 4l + 3, so each [R, W] access
// of a thread is 4 consecutive cells: 4 bytes of wmask and valid, 16 bytes
// of warm and score.  Warp v of the 16 takes the rows v, v + 16, ... of the
// block.  The block first packs the tile's empty words into shared memory,
// reading occ once, coalesced (512 contiguous bytes a warp instruction where
// T is a multiple of 32, a 16-byte row a thread where T <= 32).
//
// The fast path (T <= 512, T a multiple of 4, W a multiple of 4, aligned
// arrays: every shape the scheduler produces): each thread holds its 4
// workers' empty words in registers, and each warp runs its rows through a
// ring of kStages row slots in shared memory, filled by cp.async: a row's
// aff bytes, 4 bytes of wmask and 16 of warm a lane, and the row's scalars.
// So kStages - 1 rows of a warp are in flight while it decides one, and no
// register holds them (2 slots: the pass is bound by instruction issue, and
// 4 or 8 slots timed no faster, tools/affinity_variants.py).  For the row it decides, the warp packs the staged
// aff bytes into (pos, neg) words (16 tags a lane, two lanes a word), tests
// its cells with two LOP3s a word, and writes valid (and score).
//
// The general path (any other shape, misaligned views): the same tile,
// packed in chunks of kWords words; each row's words made by two ballots a
// word; the rows' cells written after the last chunk, a byte or a word at a
// time.
//
// bulk_decide folds each row's keys min(order_bits(score) << 32 | w) over
// the warp (a 32-bit min of the score bits, then the first lane and worker
// that hold it) and into keys[1 + r] with a 64-bit red.min; see
// bulk_decide.cu for the winner pass.  Blocks take their rows in a rotated order
// (blockIdx.x), so the blocks of a row reach its key at different times.
//
// The float terms are single float32 operations in the reference's order
// (ref.py / the Pallas body), rounded to nearest (the __f*_rn intrinsics; the
// build passes --fmad=false), so no term can move off float32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace affinity {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;           // 512 threads a block
constexpr int kWorkersPerThread = 4;
constexpr int kTileWorkers = 32 * kWorkersPerThread;  // 128 workers a block
constexpr int kRowsPerWarp = 32;                // bits of a viol word
constexpr int kBlockRows = kWarps * kRowsPerWarp;     // 512 rows a block
constexpr int kFastWords = 16;  // the fast path's longest tag axis, in words
constexpr int kStages = 2;      // row slots of a warp's ring (fast path)

// STRATEGY_CODES (bulk_np.py): 0 best_first, 1 least_loaded, 2 warmest,
// anything else min_cost — the reference's where-chain order.
constexpr float kWarmestBase = 4194304.0f;       // 2**22 (WARMEST_BASE_F32)
constexpr float kWarmestClamp = 4194303.0f;      // 2**22 - 1
constexpr float kMinCostClamp = 16777200.0f;     // 2**24 - 16 (MIN_COST_LOAD_CLAMP)
constexpr uint32_t kInfKeyHi = 0xFF800000u;      // order_bits(+inf)
constexpr uint64_t kNoKey = ~0ull;               // above every real key

__device__ __forceinline__ uint32_t order_bits(float s) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The float32 score of a valid cell, as bulk_ref.py computes it.
__device__ __forceinline__ float cell_score(int32_t strat, int32_t warm,
                                            float loadf) {
  const int32_t rank = warm < 0 ? 0 : (warm > 2 ? 2 : warm);
  const float rankf = (float)rank;
  if (strat == 0) return __fsub_rn(2.0f, rankf);
  if (strat == 1) return __fadd_rn(loadf, __fmul_rn(0.0f, rankf));
  if (strat == 2)
    return __fadd_rn(__fmul_rn(__fsub_rn(2.0f, rankf), kWarmestBase),
                     fminf(loadf, kWarmestClamp));
  const float life = rank >= 2 ? 0.0f : (rank >= 1 ? 2.0f : 10.0f);
  return __fadd_rn(life, fminf(loadf, kMinCostClamp));
}

// One bit per byte of `x` that equals `v` (bytes in address order): the
// exact zero-byte test of x ^ v (no carry crosses a byte), then the four
// high bits gathered by one multiply.
__device__ __forceinline__ uint32_t byte_bits(uint32_t x, uint32_t v) {
  const uint32_t y = x ^ v;
  const uint32_t z = ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu);
  return (((z >> 7) & 0x01010101u) * 0x10204080u) >> 28;
}

// Bit q of the low byte moved to bit 4q.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  b &= 0xffu;
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// atomicMin with no result wanted: a reduction the warp does not wait for.
__device__ __forceinline__ void red_min(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.min.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

struct CellArgs {
  const int8_t* aff;        // [R, T]
  const float* f_mem;       // [R]
  const float* cap_pct;     // [R]
  const int32_t* max_conc;  // [R]
  const int32_t* strat;     // [R]     (bulk only)
  const int32_t* occ;       // [W, T]
  const float* mem_used;    // [W]
  const float* max_mem;     // [W]
  const int32_t* n_funcs;   // [W]
  const uint8_t* wmask;     // [R, W]
  const int32_t* warm;      // [R, W]  (bulk only)
  uint8_t* valid;           // [R, W]
  float* score;             // [R, W]  (bulk only)
  int32_t* winner;          // [R]     (bulk only)
  unsigned long long* keys; // [1 + R]: ticket, then one key per row (bulk)
  int64_t R, W, T, NW;
  int occ_path;  // 0: 512-byte warp loads (T % 32 == 0); 1: a row a
                 // thread (T <= 32); 2: a ballot per word (other T)
  bool fast;     // the fast path's conditions hold (see the note above)
  bool aff16;    // aff rows 16-byte aligned (T % 16 == 0): 16-byte copies
};

// The tile's empty words k0 .. k0 + nwc - 1 into e_s[kk][wl].
template <int kWords>
__device__ __forceinline__ void pack_empty_chunk(
    const CellArgs& a, uint32_t (*e_s)[kTileWorkers], int64_t w0, int64_t k0,
    int nwc, int warp, int lane) {
  const int64_t T = a.T, W = a.W;
  const int n_words = kTileWorkers * nwc;  // (worker, word) pairs
  if (a.occ_path == 0) {
    // lane l loads 16 bytes of word g = 4 it + l / 8: a warp instruction
    // reads 4 words, each one aligned 128-byte line
    constexpr int kU = 4;
    const int n_it = n_words / 4;
    for (int it0 = warp; it0 < n_it; it0 += kWarps * kU) {
      int4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int it = it0 + u * kWarps;
        const int g = 4 * it + (lane >> 3);
        const int64_t w = w0 + g / nwc;
        v[u] = make_int4(1, 1, 1, 1);
        if (it < n_it && w < W)
          v[u] = __ldg(reinterpret_cast<const int4*>(
                           a.occ + w * T + (k0 + g % nwc) * 32) +
                       (lane & 7));
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int it = it0 + u * kWarps;
        const uint32_t b0 = __ballot_sync(0xffffffffu, v[u].x == 0);
        const uint32_t b1 = __ballot_sync(0xffffffffu, v[u].y == 0);
        const uint32_t b2 = __ballot_sync(0xffffffffu, v[u].z == 0);
        const uint32_t b3 = __ballot_sync(0xffffffffu, v[u].w == 0);
        if (it < n_it && (lane & 7) == 0) {
          const int h = lane >> 3, s = 8 * h, g = 4 * it + h;
          e_s[g % nwc][g / nwc] = spread4(b0 >> s) | (spread4(b1 >> s) << 1) |
                                  (spread4(b2 >> s) << 2) |
                                  (spread4(b3 >> s) << 3);
        }
      }
    }
  } else if (a.occ_path == 1) {
    // T <= 32: one word a worker; thread wl reads worker wl's row
    const int wl = warp * 32 + lane;
    if (wl < kTileWorkers) {
      const int64_t w = w0 + wl;
      uint32_t word = 0;
      if (w < W) {
        const int32_t* row = a.occ + w * T;
        if ((T & 3) == 0 && (reinterpret_cast<uintptr_t>(a.occ) & 15) == 0) {
          for (int t = 0; t < T; t += 4) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(row + t));
            word |= ((uint32_t)(x.x == 0) | ((uint32_t)(x.y == 0) << 1) |
                     ((uint32_t)(x.z == 0) << 2) |
                     ((uint32_t)(x.w == 0) << 3))
                    << t;
          }
        } else {
          for (int t = 0; t < T; ++t) word |= (uint32_t)(row[t] == 0) << t;
        }
      }
      e_s[0][wl] = word;
    }
  } else {
    // any other T: lanes over a word's 32 tags, one ballot a word
    for (int g = warp; g < n_words; g += kWarps) {
      const int wl = g / nwc, kk = g % nwc;
      const int64_t w = w0 + wl, t = (k0 + kk) * 32 + lane;
      const bool e = w < W && t < T && a.occ[w * T + t] == 0;
      const uint32_t word = __ballot_sync(0xffffffffu, e);
      if (lane == 0) e_s[kk][wl] = word;
    }
  }
}

// What a row's cells read besides the tag test, for a thread's 4 workers.
struct RowIn {
  uint32_t wm;      // byte j: wmask of worker wq + j
  int32_t warm[4];  // (bulk only)
  float f_mem, cap;  // cap = cap_pct * 0.01, the reference's first product
  int32_t conc, strat;
};

template <bool kBulk>
__device__ __forceinline__ RowIn load_row(const CellArgs& a, int64_t r,
                                          int64_t wq) {
  RowIn in{};
  in.f_mem = a.f_mem[r];
  in.cap = __fmul_rn(a.cap_pct[r], 0.01f);
  in.conc = a.max_conc[r];
  const int64_t c = r * a.W + wq;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (wq + j < a.W) {
      in.wm |= (uint32_t)a.wmask[c + j] << (8 * j);
      if constexpr (kBulk) in.warm[j] = a.warm[c + j];
    }
  if constexpr (kBulk) in.strat = a.strat[r];
  return in;
}

// A thread's 4 workers' empty words of the chunk, from shared memory.
template <int kWords>
__device__ __forceinline__ void words_to_registers(
    const uint32_t (*e_s)[kTileWorkers], int nwc, int lane,
    uint32_t (&e)[kWorkersPerThread][kWords]) {
#pragma unroll
  for (int kk = 0; kk < kWords; ++kk) {
    const uint4 x = kk < nwc ? *reinterpret_cast<const uint4*>(
                                   &e_s[kk][kWorkersPerThread * lane])
                             : make_uint4(0u, 0u, 0u, 0u);
    e[0][kk] = x.x; e[1][kk] = x.y; e[2][kk] = x.z; e[3][kk] = x.w;
  }
}

// Which of a thread's 4 workers row r violates over the words k0 ..
// k0 + nwc - 1 (bit j: worker wq + j), from the workers' empty words e.
// Lane l reads tag 32k + l of each word: coalesced bytes, issued together;
// two ballots then give every lane the row's pos and neg word.
template <int kWords>
__device__ __forceinline__ uint32_t row_violations(
    const CellArgs& a, int64_t r, int64_t k0, int nwc,
    const uint32_t (&e)[kWorkersPerThread][kWords], int lane) {
  int8_t b[kWords];
#pragma unroll
  for (int kk = 0; kk < kWords; ++kk) {
    const int64_t t = (k0 + kk) * 32 + lane;
    b[kk] = kk < nwc && t < a.T ? a.aff[r * a.T + t] : 0;
  }
  uint32_t acc[kWorkersPerThread] = {0, 0, 0, 0};
#pragma unroll
  for (int kk = 0; kk < kWords; ++kk) {
    const uint32_t p = __ballot_sync(0xffffffffu, b[kk] == 1);
    const uint32_t n = __ballot_sync(0xffffffffu, b[kk] == -1);
#pragma unroll
    for (int j = 0; j < kWorkersPerThread; ++j)
      acc[j] |= (p & e[j][kk]) | (n & ~e[j][kk]);
  }
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kWorkersPerThread; ++j) m |= (uint32_t)(acc[j] != 0) << j;
  return m;
}

// A thread's 4 workers' own state.
struct Workers {
  float mem[4], maxm[4], loadf[4];
  int32_t nfn[4];
};

template <bool kVec>
__device__ __forceinline__ Workers load_workers(const CellArgs& a,
                                                int64_t wq) {
  Workers v{};
  if (kVec) {
    if (wq >= a.W) return v;
    const float4 m = *reinterpret_cast<const float4*>(a.mem_used + wq);
    const float4 x = *reinterpret_cast<const float4*>(a.max_mem + wq);
    const int4 n = *reinterpret_cast<const int4*>(a.n_funcs + wq);
    v.mem[0] = m.x; v.mem[1] = m.y; v.mem[2] = m.z; v.mem[3] = m.w;
    v.maxm[0] = x.x; v.maxm[1] = x.y; v.maxm[2] = x.z; v.maxm[3] = x.w;
    v.nfn[0] = n.x; v.nfn[1] = n.y; v.nfn[2] = n.z; v.nfn[3] = n.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = wq + j < a.W;
      v.mem[j] = in ? a.mem_used[wq + j] : 0.0f;
      v.maxm[j] = in ? a.max_mem[wq + j] : 0.0f;
      v.nfn[j] = in ? a.n_funcs[wq + j] : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v.loadf[j] = __int2float_rn(v.nfn[j]);
  return v;
}

// Row r's cells of a thread's 4 workers, given which of them the row
// violates (bit j of `viol`): valid out, and for bulk_decide score out and
// the row's key folded into keys[1 + r].  Called by whole warps.
template <bool kBulk, bool kVec>
__device__ __forceinline__ void finish_row(const CellArgs& a, const RowIn& in,
                                           const Workers& v, int64_t r,
                                           int64_t wq, uint32_t viol,
                                           int lane) {
  const int64_t c = r * a.W + wq;
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok_aff = ((viol >> j) & 1u) == 0;
    const bool ok_fit = __fadd_rn(v.mem[j], in.f_mem) <= v.maxm[j];
    const bool ok_cap = v.mem[j] < __fmul_rn(in.cap, v.maxm[j]);
    const bool ok_conc = v.nfn[j] < in.conc;
    ok[j] = ok_aff && ok_fit && ok_cap && ok_conc &&
            ((in.wm >> (8 * j)) & 0xffu) != 0;
  }
  if (kVec) {
    if (wq < a.W)
      *reinterpret_cast<uint32_t*>(a.valid + c) =
          (uint32_t)ok[0] | ((uint32_t)ok[1] << 8) |
          ((uint32_t)ok[2] << 16) | ((uint32_t)ok[3] << 24);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (wq + j < a.W) a.valid[c + j] = ok[j] ? 1 : 0;
  }
  if constexpr (kBulk) {
    float s[4];
    uint32_t best = ~0u;  // above order_bits of every score, +inf included
    int first = 0;        // my first worker with the lowest score
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = ok[j] ? cell_score(in.strat, in.warm[j], v.loadf[j]) : INFINITY;
      const uint32_t o = order_bits(s[j]);
      if (wq + j < a.W && o < best) {
        best = o;
        first = j;
      }
    }
    if (kVec) {
      if (wq < a.W)
        *reinterpret_cast<float4*>(a.score + c) =
            make_float4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (wq + j < a.W) a.score[c + j] = s[j];
    }
    // the row's key over the warp, min(order_bits << 32 | w): the lowest
    // score, then its lowest lane (lanes own increasing workers), then
    // that lane's first worker with it
    const uint32_t low = __reduce_min_sync(0xffffffffu, best);
    const int at = __ffs(__ballot_sync(0xffffffffu, best == low)) - 1;
    const int64_t w = __shfl_sync(0xffffffffu, wq + first, at);
    if (lane == 0)
      red_min(a.keys + 1 + r, ((uint64_t)low << 32) | (uint64_t)w);
  }
}

// Dynamic shared memory of cells<kBulk, kWords>: the tile's empty words,
// then per warp its row's (pos, neg) words and its ring of kStages row
// slots (aff bytes, wmask, warm, the row's 4 scalars).
template <bool kBulk, int kWords>
struct Smem {
  static constexpr int kAff = 32 * kWords;  // T <= 32 kWords bytes
  static constexpr int kWm = kAff;
  static constexpr int kWarm = kWm + 4 * 32;
  static constexpr int kScal = kWarm + (kBulk ? 16 * 32 : 0);
  static constexpr int kSlot = kScal + 16;
  static constexpr int kPn = (kWords * 8 + 15) / 16 * 16;
  static constexpr int kTile = kWords * kTileWorkers * 4;
  static constexpr int kWarp = kPn + kStages * kSlot;
  static constexpr int kBytes = kTile + kWarps * kWarp;
};

// A warp's ring of row slots (fast path): its n rows r, r + kWarps, ...,
// walked from a rotated start (row t of the walk is my row (t + blockIdx.x)
// mod n; `next` steps through it without a division).  issue(t) copies row
// t's inputs into slot t mod kStages with cp.async, one commit group a row
// (empty past the end, so every thread counts its groups alike).
template <bool kBulk, int kWords>
struct RowRing {
  using S = Smem<kBulk, kWords>;
  const CellArgs& a;
  unsigned char* slots;
  int64_t r, wq;
  int n, lane, first, next;

  __device__ RowRing(const CellArgs& a_, unsigned char* slots_, int64_t r_,
                     int n_, int64_t wq_, int lane_)
      : a(a_), slots(slots_), r(r_), wq(wq_), n(n_), lane(lane_),
        first(n_ > 0 ? (int)(blockIdx.x % n_) : 0), next(first) {}

  __device__ int row_after(int i) const { return i + 1 == n ? 0 : i + 1; }

  __device__ void issue(int t) {
    if (t < n) {
      const int64_t ri = r + (int64_t)kWarps * next;
      next = row_after(next);
      unsigned char* st = slots + (t % kStages) * S::kSlot;
      if (a.aff16) {
        if (16 * lane < a.T)
          cp_async16(st + 16 * lane, a.aff + ri * a.T + 16 * lane);
      } else {
        for (int t0 = 4 * lane; t0 < a.T; t0 += 128)
          cp_async4(st + t0, a.aff + ri * a.T + t0);
      }
      if (wq < a.W) {
        const int64_t c = ri * a.W + wq;
        cp_async4(st + S::kWm + 4 * lane, a.wmask + c);
        if constexpr (kBulk) cp_async16(st + S::kWarm + 16 * lane, a.warm + c);
      }
      if (lane < 4) {
        const void* src = lane == 0   ? (const void*)(a.f_mem + ri)
                          : lane == 1 ? (const void*)(a.cap_pct + ri)
                          : lane == 2 ? (const void*)(a.max_conc + ri)
                          : kBulk     ? (const void*)(a.strat + ri)
                                      : (const void*)(a.max_conc + ri);
        cp_async4(st + S::kScal + 4 * lane, src);
      }
    }
    cp_async_commit();
  }

  // the first kStages - 1 rows, issued before the tile is packed
  __device__ void prologue() {
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }
};

// The fast path over a warp's rows, with the tile's empty words of its 4
// workers in e: row t + kStages - 1 is copied into the ring while row t is
// decided (the ring's prologue already issued).
template <bool kBulk, int kWords>
__device__ __forceinline__ void fast_rows(
    const CellArgs& a, RowRing<kBulk, kWords>& ring, uint2* pn,
    const uint32_t (&e)[kWorkersPerThread][kWords], const Workers& v,
    int lane) {
  using S = Smem<kBulk, kWords>;
  const int n = ring.n;
  int decided = ring.first;
  for (int t = 0; t < n; ++t) {
    ring.issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();  // row t's group has landed
    __syncwarp();
    const unsigned char* st = ring.slots + (t % kStages) * S::kSlot;
    // (pos, neg) words: lane l packs tags 16l .. 16l + 15, lane 2k joins
    // the halves of word k
    {
      const int t0 = 16 * lane;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t0 < a.T) x = *reinterpret_cast<const uint4*>(st + t0);
      uint32_t p16 = byte_bits(x.x, 0x01010101u) |
                     (byte_bits(x.y, 0x01010101u) << 4) |
                     (byte_bits(x.z, 0x01010101u) << 8) |
                     (byte_bits(x.w, 0x01010101u) << 12);
      uint32_t n16 = byte_bits(x.x, 0xffffffffu) |
                     (byte_bits(x.y, 0xffffffffu) << 4) |
                     (byte_bits(x.z, 0xffffffffu) << 8) |
                     (byte_bits(x.w, 0xffffffffu) << 12);
      const int64_t tags = a.T - t0;  // this lane's bytes that are tags
      if (tags < 16) {
        const uint32_t m = tags > 0 ? (1u << tags) - 1u : 0u;
        p16 &= m;
        n16 &= m;
      }
      const uint32_t mine = p16 | (n16 << 16);
      const uint32_t hi = __shfl_down_sync(0xffffffffu, mine, 1);
      if ((lane & 1) == 0 && lane / 2 < kWords)
        pn[lane / 2] = make_uint2((mine & 0xffffu) | (hi << 16),
                                  (mine >> 16) | (hi & 0xffff0000u));
    }
    __syncwarp();
    uint32_t acc[kWorkersPerThread] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < kWords; kk += 2) {
      uint32_t p0, n0, p1 = 0, n1 = 0;
      if constexpr (kWords >= 2) {
        const uint4 q = *reinterpret_cast<const uint4*>(pn + kk);
        p0 = q.x; n0 = q.y; p1 = q.z; n1 = q.w;
      } else {
        const uint2 q = pn[kk];
        p0 = q.x; n0 = q.y;
      }
#pragma unroll
      for (int j = 0; j < kWorkersPerThread; ++j) {
        acc[j] |= (p0 & e[j][kk]) | (n0 & ~e[j][kk]);
        if constexpr (kWords >= 2)
          acc[j] |= (p1 & e[j][kk + 1]) | (n1 & ~e[j][kk + 1]);
      }
    }
    uint32_t viol = 0;
#pragma unroll
    for (int j = 0; j < kWorkersPerThread; ++j)
      viol |= (uint32_t)(acc[j] != 0) << j;
    RowIn in{};
    in.wm = *reinterpret_cast<const uint32_t*>(st + S::kWm + 4 * lane);
    if constexpr (kBulk) {
      const int4 w = *reinterpret_cast<const int4*>(st + S::kWarm + 16 * lane);
      in.warm[0] = w.x; in.warm[1] = w.y; in.warm[2] = w.z; in.warm[3] = w.w;
    }
    const uint4 sc = *reinterpret_cast<const uint4*>(st + S::kScal);
    in.f_mem = __uint_as_float(sc.x);
    in.cap = __fmul_rn(__uint_as_float(sc.y), 0.01f);
    in.conc = (int32_t)sc.z;
    in.strat = (int32_t)sc.w;
    finish_row<kBulk, true>(a, in, v, ring.r + (int64_t)kWarps * decided,
                            ring.wq, viol, lane);
    decided = ring.row_after(decided);
    __syncwarp();  // the slot is refilled by the next issue
  }
  cp_async_wait<0>();
}

template <bool kBulk, int kWords>
__global__ void __launch_bounds__(kThreads, 1) cells(const CellArgs a) {
  using S = Smem<kBulk, kWords>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;
  uint32_t (*e_s)[kTileWorkers] =
      reinterpret_cast<uint32_t (*)[kTileWorkers]>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t NW = a.NW;
  const int64_t w0 = blockIdx.x * (int64_t)kTileWorkers;
  const int64_t wq = w0 + kWorkersPerThread * lane;  // first of my 4
  const int64_t r0 = blockIdx.y * (int64_t)kBlockRows;
  const int nrows = (int)(a.R - r0 < kBlockRows ? a.R - r0 : kBlockRows);
  const int my_rows = warp < nrows ? (nrows - warp + kWarps - 1) / kWarps : 0;
  uint32_t e[kWorkersPerThread][kWords];

  if (a.fast) {
    unsigned char* mine = smem + S::kTile + warp * S::kWarp;
    RowRing<kBulk, kWords> ring(a, mine + S::kPn, r0 + warp, my_rows, wq,
                                lane);
    ring.prologue();
    pack_empty_chunk<kWords>(a, e_s, w0, 0, (int)NW, warp, lane);
    const Workers v = load_workers<true>(a, wq);
    __syncthreads();
    words_to_registers<kWords>(e_s, (int)NW, lane, e);
    fast_rows<kBulk, kWords>(a, ring, reinterpret_cast<uint2*>(mine), e, v,
                             lane);
  } else {
    // chunks of kWords words: bit i of viol[j] says whether my row i
    // violates worker j; then one pass of the rows' cells
    uint32_t viol[kWorkersPerThread] = {0, 0, 0, 0};
    for (int64_t k0 = 0; k0 < NW; k0 += kWords) {
      const int nwc = (int)(NW - k0 < kWords ? NW - k0 : kWords);
      if (k0 > 0) __syncthreads();  // the last chunk's words are read
      pack_empty_chunk<kWords>(a, e_s, w0, k0, nwc, warp, lane);
      __syncthreads();
      words_to_registers<kWords>(e_s, nwc, lane, e);
      for (int i = 0; i < my_rows; ++i) {
        const uint32_t m = row_violations<kWords>(
            a, r0 + warp + (int64_t)kWarps * i, k0, nwc, e, lane);
#pragma unroll
        for (int j = 0; j < kWorkersPerThread; ++j)
          viol[j] |= ((m >> j) & 1u) << i;
      }
    }
    const Workers v = load_workers<false>(a, wq);
    for (int i = 0; i < my_rows; ++i) {
      const int64_t r = r0 + warp + (int64_t)kWarps * i;
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < kWorkersPerThread; ++j)
        m |= ((viol[j] >> i) & 1u) << j;
      finish_row<kBulk, false>(a, load_row<kBulk>(a, r, wq), v, r, wq, m,
                               lane);
    }
  }

  if constexpr (kBulk) {
    // the last block to finish turns every row's key into its winner and
    // leaves the keys and the ticket reset for the next launch
    __threadfence();  // my key reductions before the block's ticket
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long n = (unsigned long long)gridDim.x * gridDim.y;
      last_s = atomicAdd(a.keys, 1ull) == n - 1;
    }
    __syncthreads();
    if (last_s) {
      __threadfence();
      for (int64_t r = threadIdx.x; r < a.R; r += kThreads) {
        const uint64_t key = atomicExch(a.keys + 1 + r, kNoKey);
        a.winner[r] = (uint32_t)(key >> 32) >= kInfKeyHi
                          ? -1
                          : (int32_t)(key & 0xffffffffu);
      }
      if (threadIdx.x == 0) atomicExch(a.keys, 0ull);
    }
  }
}

// Fills the fields of `a` that say which paths the inputs allow.
inline void choose_paths(CellArgs& a) {
  auto al = [](const void* p, uintptr_t n) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) % n) == 0;
  };
  a.NW = (a.T + 31) / 32;
  a.occ_path = (a.T % 32 == 0 && al(a.occ, 16)) ? 0 : (a.T <= 32 ? 1 : 2);
  a.fast = a.NW <= kFastWords && a.T % 4 == 0 && al(a.aff, 4) &&
           a.W % 4 == 0 && al(a.mem_used, 16) && al(a.max_mem, 16) &&
           al(a.n_funcs, 16) && al(a.warm, 16) && al(a.score, 16) &&
           al(a.wmask, 4) && al(a.valid, 4);
  a.aff16 = a.T % 16 == 0 && al(a.aff, 16);
}

template <bool kBulk, int kWords>
inline int launch(const CellArgs& a, dim3 grid, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after this attribute, set
  // once for the kernel (the process's one device)
  static const cudaError_t attr = cudaFuncSetAttribute(
      cells<kBulk, kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<kBulk, kWords>::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  cells<kBulk, kWords>
      <<<grid, kThreads, Smem<kBulk, kWords>::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch of cells<kBulk, kWords> for the inputs' word count: kWords is
// the part of the tag axis held in registers (1, 2, 4, 8 or 16 words; a
// longer axis goes in chunks of 16 on the general path).
template <bool kBulk>
inline int launch_cells(const CellArgs& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.W + kTileWorkers - 1) / kTileWorkers),
                  (unsigned)((a.R + kBlockRows - 1) / kBlockRows));
  if (a.NW <= 1) return launch<kBulk, 1>(a, grid, stream);
  if (a.NW <= 2) return launch<kBulk, 2>(a, grid, stream);
  if (a.NW <= 4) return launch<kBulk, 4>(a, grid, stream);
  if (a.NW <= 8) return launch<kBulk, 8>(a, grid, stream);
  return launch<kBulk, 16>(a, grid, stream);
}

}  // namespace affinity
