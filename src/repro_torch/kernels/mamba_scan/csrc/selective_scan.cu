// selective_scan: the mamba-1 selective scan (the prefill's hot loop) on
// Hopper, with the hidden state kept in registers for the whole sequence.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ;  y_t = h_t . C_t
//   (per channel d and state n; h_0 = 0)
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan/kernel.py
// (_scan_kernel, entry selective_scan_kernel), which walks a sequential
// (B, D/bd, S/chunk) grid and carries h [bd, N] in VMEM scratch from one
// sequence chunk to the next, so the O(S D N) state never reaches device
// memory: only dt, x, B, C and A are read and only y is written.
//
// What bounds it on this card.  At the serving shape (B, S, D, N) =
// (1, 4096, 8192, 16), dt float32 and x / B / C bf16, the function reads
// ~201 MB and writes 134 MB of float32 y: ~0.10 ms at 3.35 TB/s.  Its
// 537 M exponentials take ~0.14 ms at the 16 a clock of an SM's MUFU unit
// (1.75-1.98 GHz), and the ~5 instructions per (t, d, n) of the step about
// as long in issue slots, so the step loop, not the bytes, is the limit.
// B D N / K threads (1024 warps at the serving shape, ~2 per scheduler)
// leave its latencies to instruction-level parallelism.  PERF.md has the
// measured breakdown.
//
// What the design does:
//   * no grid axis carries the state: blocks run in no order, so each block
//     owns a tile of kCh = 32 channels of one batch row and loops over the
//     whole sequence itself, h in registers from the first step to the last;
//   * K = min(N, kMaxStatesPerThread) consecutive states of one channel per
//     thread, L = N / K lanes per channel, a warp's lanes running over
//     32 / L channels first (so the 8 lanes of a quarter warp share one
//     address of B and C, and read 8 neighbouring channels' dt): each step's
//     dt and dt x come in one 8-byte shared load for K states, B_t and C_t
//     in float4 / float2 loads, and the sum over n is K - 1 register adds
//     plus the lanes' share of a reduce-scatter;
//   * the reduce-scatter: the step loop runs groups of kU = 8 steps, each
//     lane keeps its 8 partial sums, and log2 L rounds of shuffles, each
//     trading half of the remaining sums with the partner lane, leave lane j
//     of a channel holding the full y of steps j 8/L ... (j + 1) 8/L - 1:
//     8 - 8/L shuffles per 8 steps where an all-reduce spends 8 log2 L, and
//     8/L shared stores of y where it spends 8.  A group's reduce-scatter
//     runs beside the next group's steps, whose arithmetic hides its
//     latency;
//   * exp(dt A) = exp2(dt A'), A' = A log2(e) formed once per thread: one
//     FMUL and one MUFU.EX2 (ex2.approx.ftz) per state and step.  Its error
//     (about 2 ulp) keeps every check within 1e-4; expf measured 1.5x
//     the kernel's time (PERF.md);
//   * staging in chunks of kT = 64 steps, double-buffered: the next chunk's
//     dt, x, B and C tiles are in flight with cp.async (16 bytes a copy,
//     zero-filled past S and D) while the current chunk's steps run.  They
//     land in shared memory in their own type (bf16 stays bf16) and are
//     widened once per element, not once per lane that reads them, by a
//     cooperative pass after they arrive: dt and x into (dt, dt x) float2
//     pairs, B and C into float32 rows interleaved per lane (its K B values,
//     then its K C values);
//   * y goes through shared memory (rows padded to 36 floats, so the
//     reduce-scatter's stores do not collide on a bank) and out a chunk at a
//     time in full rows along D, with float4 streaming stores;
//   * dt, x, B and C may each be float32 or bfloat16 (a runtime flag per
//     tensor, read only by the staging and widening passes); A is float32;
//     y is float32;
//   * N is a template parameter (1, 2, 4, 8, 16, 32); anything else is
//     refused by the entry point;
//   * ragged S and D are masked in the kernel, nothing is padded.  Rows of
//     dt / x and spans of B / C that are not 16-byte aligned (D not a
//     multiple of 8, or S N not one at B > 1, or an offset pointer) are
//     staged by plain loads instead of cp.async, through the same pipeline.
//
// The second entry, selective_scan_fused_launch, replaces no TPU kernel: it
// folds the mamba block's elementwise chain around the scan (models/ssm.py's
// plain path: softplus of dt_proj + dt_b, -exp(a_log), the D skip, the
// silu(z) gate and the cast to the model's type), which the JAX package
// leaves to XLA to fuse and eager PyTorch runs as ~15 float32 kernels moving
// ~80 bytes per channel and token, into the same recurrence, tiling and
// reduce-scatter (the kernel's kFused instance).  It reads dt_proj, x and z
// (and B, C) once and writes the output once in the model's type: 8 bytes
// per channel and token in bf16 against the first entry's 10, ~0.067 ms of
// bytes at the serving shape.  Its new work is mostly MUFU work (with the
// accurate forms' FMA refinements): softplus (an ex2 and a lg2) per (t, d)
// in the widening pass, a = -expf(a_log) once per thread, and silu(z) (an
// ex2 and a rcp) per (t, d) in the flush, where the
// lane that holds a channel's full y applies (y + d_skip x) silu(z) with x
// and z read from the chunk's raw stage; ~4 MUFU operations per (t, d)
// against the step's N = 16 exp2, so its MUFU floor is ~0.16 ms at the
// serving shape.  softplus and SiLU keep PyTorch's accurate log1pf, expf
// and division, so every rounding point is the plain path's.  The widening
// pass runs between barriers, so softplus's latency is not hidden behind
// the steps: the entry measured 0.453 ms, 0.365 without softplus and 0.372
// without the gate, against the first entry's 0.265 (PERF.md).
// z is staged by cp.async with dt and x, from rows of its own stride (the
// second half of in_proj's output, read in place); B and C are staged as
// rows of their own stride (read in place from x_proj's output) where that
// stride and N keep 16-byte pieces, else the wrapper passes contiguous
// copies and they go as spans.  The raw z tile adds 8 KB per stage (99 KB a
// block at N = 16, still two blocks an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kCh = 32;                 // channels per block
constexpr int kT = 64;                  // time steps per staged chunk
constexpr int kU = 8;                   // steps per unrolled group
constexpr int kStages = 2;              // raw chunks in flight or staged
constexpr int kMaxStatesPerThread = 4;  // K = min(N, this)
constexpr int kYStride = kCh + 4;       // padded row of the y tile
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kT % kU == 0, "a chunk holds whole groups");

template <int N, bool kFused = false>
struct Shape {
  static constexpr int K = N < kMaxStatesPerThread ? N : kMaxStatesPerThread;
  static constexpr int L = N / K;  // lanes per channel
  static constexpr int kThreads = kCh * L;
  // a warp holds kWarpCh channels; lane j of a channel sits j kWarpCh
  // lanes from lane 0 (a warp's lanes run over the channels first)
  static constexpr int kWarpCh = 32 / L;
  static_assert(kU % L == 0, "a group's steps split evenly over the lanes");
  // shared memory, in bytes: kStages raw stages of dt, x (kT x kCh) and B, C
  // (kT x N), and z (kT x kCh) in the fused entry, each sized for float32;
  // the widened (dt, dt x) pairs and B / C rows of the current chunk; the
  // y tile
  static constexpr int kRawDx = kT * kCh * 4;
  static constexpr int kRawBc = kT * N * 4;
  static constexpr int kRawZ = 2 * kRawDx + 2 * kRawBc;  // z's offset
  static constexpr int kStage = kRawZ + (kFused ? kRawDx : 0);
  static constexpr int kSmem = kStages * kStage + kT * kCh * 8 +
                               kT * 2 * N * 4 + kT * kYStride * 4;
};

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(v);
  else return v;
}

// Two consecutive elements of a float32 or bf16 array, widened.
template <typename T>
__device__ __forceinline__ float2 load2(const void* p, int i) {
  if constexpr (sizeof(T) == 2)
    return __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(p)[i / 2]);
  else
    return reinterpret_cast<const float2*>(p)[i / 2];
}

// torch's softplus at beta 1 and threshold 20: v above it, else
// log1p(exp(v)), in float32 with the accurate log1pf and expf as PyTorch's
// own kernel computes it (the MUFU forms __logf(1 + __expf(v)) are 7-8%
// faster but lose e^v's low bits in the 1 + and raise the float32 error
// 64-530x: tools/scan_variants.py's fused_fast_* variants, PERF.md)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// SiLU in float32, v / (1 + exp(-v)) with expf and an IEEE division, as
// PyTorch computes it
__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// (dt, dt x) pairs [kT][kCh] from the raw dt and x tiles, two channels a
// thread at a time; every load of a thread is issued before its stores.
// With kSoftplus (the fused entry) the raw tile holds dt_proj, and dt is
// softplus(dt_proj + bias), bias the thread's two channels' dt_b (a thread
// widens the same two channels of every row)
template <int kThreads, typename TD, typename TX, bool kSoftplus>
__device__ __forceinline__ void widen_dx_as(float2* dst, const void* dt,
                                            const void* x, float2 bias,
                                            int tid) {
  constexpr int kIters = kT * kCh / 2 / kThreads;
  static_assert(kIters * 2 * kThreads == kT * kCh, "whole pairs");
  static_assert(2 * kThreads % kCh == 0, "a thread's channels stay fixed");
#pragma unroll
  for (int r = 0; r < kIters; ++r) {
    const int i = 2 * (tid + r * kThreads);
    float2 d = load2<TD>(dt, i);
    const float2 v = load2<TX>(x, i);
    if constexpr (kSoftplus)
      d = make_float2(softplus(d.x + bias.x), softplus(d.y + bias.y));
    reinterpret_cast<float4*>(dst)[i / 2] =
        make_float4(d.x, d.x * v.x, d.y, d.y * v.y);
  }
}

template <int kThreads, bool kSoftplus>
__device__ __forceinline__ void widen_dx(float2* dst, const void* dt,
                                         const void* x, int dt_bf16,
                                         int x_bf16, float2 bias, int tid) {
  using bf = __nv_bfloat16;
  constexpr bool P = kSoftplus;
  if (dt_bf16 && x_bf16)
    widen_dx_as<kThreads, bf, bf, P>(dst, dt, x, bias, tid);
  else if (dt_bf16)
    widen_dx_as<kThreads, bf, float, P>(dst, dt, x, bias, tid);
  else if (x_bf16)
    widen_dx_as<kThreads, float, bf, P>(dst, dt, x, bias, tid);
  else
    widen_dx_as<kThreads, float, float, P>(dst, dt, x, bias, tid);
}

// B (or C, from dst + K) rows [kT][N] into the interleaved float32 rows
// [kT][L][2K]: lane l's K values of B, then its K values of C.  Two states
// a thread at a time where K is even (both in one lane's block of K)
template <int N, typename T>
__device__ __forceinline__ void widen_bc_as(float* dst, const void* src,
                                            int tid) {
  using Sh = Shape<N>;
  constexpr int K = Sh::K, kPer = K % 2 == 0 ? 2 : 1;
  constexpr int kIters = kT * N / kPer / Sh::kThreads;
  static_assert(kIters * kPer * Sh::kThreads == kT * N, "whole rows");
#pragma unroll
  for (int r = 0; r < kIters; ++r) {
    const int i = kPer * (tid + r * Sh::kThreads);
    const int tt = i / N, n = i % N;
    float* row = dst + tt * 2 * N + (n / K) * 2 * K + n % K;
    if constexpr (kPer == 2) {
      const float2 v = load2<T>(src, i);
      *reinterpret_cast<float2*>(row) = v;
    } else {
      row[0] = to_float(static_cast<const T*>(src)[i]);
    }
  }
}

template <int N>
__device__ __forceinline__ void widen_bc(float* dst, const void* src,
                                         int bf16, int tid) {
  if (bf16) widen_bc_as<N, __nv_bfloat16>(dst, src, tid);
  else widen_bc_as<N, float>(dst, src, tid);
}

// Rows [0, len) of the y tile out to y (from row `row`, channel d0 on), in
// full rows along D: float4 streaming stores when `vec` (D % 8 == 0, so 4
// channels are all inside D or all outside), else one float at a time
template <int kThreads>
__device__ __forceinline__ void write_y(float* y, const float* s_y,
                                        size_t row, int len, int d0, int D,
                                        bool vec, int tid) {
  if (vec) {
    constexpr int kQuads = kCh / 4;
#pragma unroll
    for (int r = 0; r < kT * kQuads / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int tt = i / kQuads, d = 4 * (i % kQuads);
      if (tt < len && d0 + d < D)
        __stcs(reinterpret_cast<float4*>(y + (row + tt) * (size_t)D + d0 + d),
               *reinterpret_cast<const float4*>(s_y + tt * kYStride + d));
    }
  } else {
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (tt < len && d0 + cc < D)
        __stcs(&y[(row + tt) * (size_t)D + d0 + cc], s_y[tt * kYStride + cc]);
    }
  }
}

// The fused entry's rows [0, len) of the tile (the gated outputs, in
// float32) out in x's type: float32 through write_y, or bf16 rounded to
// nearest even, four channels in one 8-byte streaming store when `vec`
template <int kThreads>
__device__ __forceinline__ void write_out(void* y, const float* s_y,
                                          size_t row, int len, int d0, int D,
                                          bool vec, int bf16, int tid) {
  if (!bf16) {
    write_y<kThreads>(static_cast<float*>(y), s_y, row, len, d0, D, vec, tid);
    return;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  if (vec) {
    constexpr int kQuads = kCh / 4;
#pragma unroll
    for (int r = 0; r < kT * kQuads / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int tt = i / kQuads, d = 4 * (i % kQuads);
      if (tt < len && d0 + d < D) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_y + tt * kYStride + d);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        const float2 pk = make_float2(
            __uint_as_float(*reinterpret_cast<const unsigned*>(&lo)),
            __uint_as_float(*reinterpret_cast<const unsigned*>(&hi)));
        __stcs(reinterpret_cast<float2*>(out + (row + tt) * (size_t)D + d0 +
                                         d),
               pk);
      }
    }
  } else {
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (tt < len && d0 + cc < D)
        out[(row + tt) * (size_t)D + d0 + cc] =
            __float2bfloat16_rn(s_y[tt * kYStride + cc]);
    }
  }
}

// One 16-byte asynchronous copy that reads `bytes` (0..16) of `src` and
// zero-fills the rest of `dst`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kStages - 2 groups (the later chunks) are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// The reduce-scatter of `v` [C] over a channel's lanes j, in rounds that
// pair lane j with lane j ^ m for m = M, M/2, ..., 1 (kStride warp lanes
// per step of j): the lane whose bit m is set keeps the upper half and
// sends the lower, its partner the reverse; after the last round lane j
// holds in v[0 .. C / (2 M)) the full sums of entries j C / (2 M) onward.
template <int M, int C, int kStride>
struct ReduceScatter {
  __device__ __forceinline__ static void run(float* v, int j) {
    const bool up = (j & M) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = up ? v[i] : v[i + C / 2];
      const float keep = up ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M * kStride);
    }
    ReduceScatter<M / 2, C / 2, kStride>::run(v, j);
  }
};

template <int C, int kStride>
struct ReduceScatter<0, C, kStride> {
  __device__ __forceinline__ static void run(float*, int) {}
};

// The fused entry's further inputs: the gate z (rows of z_stride elements,
// in x's type), dt's bias dt_b [D] (in dt's type), d_skip [D] (float32),
// and the row stride of B and C (N where they are contiguous spans)
struct Fused {
  const void* z;
  const void* dt_b;
  const float* d_skip;
  int64_t z_stride;
  int64_t bc_stride;
};

// Asynchronous copies of a tile's rows [kT][kCh] of `es`-byte elements
// (dt, x or z; rows `stride` elements apart) into `dst`; D % 8 == 0, so a
// 16-byte piece lies wholly inside the channel range or wholly outside it,
// and then it is zero-filled.
template <int kThreads, int es>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const void* src, size_t row,
                                           int len, int d0, int D,
                                           size_t stride, int tid) {
  constexpr int per_row = kCh * es / 16;
  constexpr int el = 16 / es;
  for (int i = tid; i < kT * per_row; i += kThreads) {
    const int tt = i / per_row, d = d0 + (i % per_row) * el;
    const bool in = tt < len && d < D;
    const unsigned char* p = static_cast<const unsigned char*>(src) +
                             (in ? ((row + tt) * stride + d) * es : 0);
    cp_async16(dst + i * 16, p, in ? 16 : 0);
  }
}

// Asynchronous copies of a chunk's B or C rows, N elements every `stride`
// (read in place from x_proj's output), into the tile [kT][N], the rows past
// the sequence zeroed; only where N es and stride es are multiples of 16
// bytes (the launch checks the stride; other N never come here)
template <int N, int kThreads, int es>
__device__ __forceinline__ void stage_bc_rows(unsigned char* dst,
                                              const void* src, size_t row,
                                              int len, size_t stride,
                                              int tid) {
  if constexpr (N * es % 16 == 0) {
    constexpr int per_row = N * es / 16;
    for (int i = tid; i < kT * per_row; i += kThreads) {
      const int tt = i / per_row;
      const bool in = tt < len;
      const unsigned char* p =
          static_cast<const unsigned char*>(src) +
          (in ? (row + tt) * stride * es + (i % per_row) * 16 : 0);
      cp_async16(dst + i * 16, p, in ? 16 : 0);
    }
  }
}

// Asynchronous copies of a chunk's B or C rows, one contiguous span of
// len * N elements from element `first` on, the rest of the tile zeroed.
template <int N, int kThreads, int es>
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const void* src, size_t first,
                                           int len, int tid) {
  const int span = len * N * es;
  for (int i = tid; i * 16 < kT * N * es; i += kThreads) {
    const int bytes = min(16, max(0, span - i * 16));
    const unsigned char* p = static_cast<const unsigned char*>(src) +
                             (bytes ? first * es + i * 16 : 0);
    cp_async16(dst + i * 16, p, bytes);
  }
}

// Element i of a float32 (es == 4) or bf16 (es == 2) array, copied raw.
__device__ __forceinline__ void copy_elem(unsigned char* dst, int i,
                                          const void* src, size_t g,
                                          bool in, int es) {
  if (es == 2)
    reinterpret_cast<__nv_bfloat16*>(dst)[i] =
        in ? static_cast<const __nv_bfloat16*>(src)[g]
           : __float2bfloat16(0.f);
  else
    reinterpret_cast<float*>(dst)[i] =
        in ? static_cast<const float*>(src)[g] : 0.f;
}

// Stage chunk [t0, t0 + len) of one batch row into a raw stage: dt and x
// tiles [kT][kCh], the B and C rows [kT][N] and, in the fused entry, the z
// tile [kT][kCh] (in x's type), in their own types; every element outside
// the sequence or the channel range is 0.  Aligned inputs (`vec`) go by
// cp.async; the others by plain loads.
template <int N, bool kFused>
__device__ __forceinline__ void stage_chunk(
    unsigned char* st, const void* dt, const void* x, const void* b,
    const void* c, const Fused& fu, size_t row0, int t0, int len, int d0,
    int D, int es_dt, int es_x, int es_b, int es_c, bool vec, int tid) {
  using Sh = Shape<N, kFused>;
  unsigned char* s_dt = st;
  unsigned char* s_x = st + Sh::kRawDx;
  unsigned char* s_b = st + 2 * Sh::kRawDx;
  unsigned char* s_c = s_b + Sh::kRawBc;
  unsigned char* s_z = st + Sh::kRawZ;
  const size_t row = row0 + t0;
  const size_t bcs = kFused ? (size_t)fu.bc_stride : (size_t)N;
  if (vec) {
    constexpr int T = Sh::kThreads;
    if (es_dt == 2) stage_rows<T, 2>(s_dt, dt, row, len, d0, D, D, tid);
    else stage_rows<T, 4>(s_dt, dt, row, len, d0, D, D, tid);
    if (es_x == 2) stage_rows<T, 2>(s_x, x, row, len, d0, D, D, tid);
    else stage_rows<T, 4>(s_x, x, row, len, d0, D, D, tid);
    if constexpr (kFused) {
      if (es_x == 2)
        stage_rows<T, 2>(s_z, fu.z, row, len, d0, D, fu.z_stride, tid);
      else stage_rows<T, 4>(s_z, fu.z, row, len, d0, D, fu.z_stride, tid);
    }
    if (!kFused || bcs == N) {
      if (es_b == 2) stage_span<N, T, 2>(s_b, b, row * N, len, tid);
      else stage_span<N, T, 4>(s_b, b, row * N, len, tid);
      if (es_c == 2) stage_span<N, T, 2>(s_c, c, row * N, len, tid);
      else stage_span<N, T, 4>(s_c, c, row * N, len, tid);
    } else {
      if (es_b == 2) stage_bc_rows<N, T, 2>(s_b, b, row, len, bcs, tid);
      else stage_bc_rows<N, T, 4>(s_b, b, row, len, bcs, tid);
      if (es_c == 2) stage_bc_rows<N, T, 2>(s_c, c, row, len, bcs, tid);
      else stage_bc_rows<N, T, 4>(s_c, c, row, len, bcs, tid);
    }
    return;
  }
  for (int i = tid; i < kT * kCh; i += Sh::kThreads) {
    const int tt = i / kCh, cc = i % kCh;
    const bool in = tt < len && d0 + cc < D;
    const size_t g = (row + tt) * (size_t)D + d0 + cc;
    copy_elem(s_dt, i, dt, g, in, es_dt);
    copy_elem(s_x, i, x, g, in, es_x);
    if constexpr (kFused)
      copy_elem(s_z, i, fu.z, (row + tt) * (size_t)fu.z_stride + d0 + cc, in,
                es_x);
  }
  for (int i = tid; i < kT * N; i += Sh::kThreads) {
    const bool in = i < len * N;
    const size_t g = kFused ? (row + i / N) * bcs + i % N : row * N + i;
    copy_elem(s_b, i, b, g, in, es_b);
    copy_elem(s_c, i, c, g, in, es_c);
  }
}

// kFused: the second entry.  dt holds dt_proj, `a` holds a_log, y is the
// gated output in x's type, and `fu` the further inputs; else `fu` is unused
// and y is float32
template <int N, bool kFused>
__global__ void __launch_bounds__(Shape<N>::kThreads)
    selective_scan_fwd(const void* __restrict__ dt, const void* __restrict__ x,
                       const void* __restrict__ b, const void* __restrict__ c,
                       const float* __restrict__ a, void* __restrict__ y,
                       const Fused fu, int S, int D, int dt_bf16, int x_bf16,
                       int b_bf16, int c_bf16, int vec) {
  using Sh = Shape<N, kFused>;
  constexpr int K = Sh::K, L = Sh::L;
  extern __shared__ __align__(16) unsigned char smem[];
  // after the raw stages: (dt, dt x) [kT][kCh], B / C [kT][L][2K], and
  // the y tile [kT][kYStride]
  float2* s_dx = reinterpret_cast<float2*>(smem + kStages * Sh::kStage);
  float* s_bc = reinterpret_cast<float*>(s_dx + kT * kCh);
  float* s_y = s_bc + kT * 2 * N;

  const int tid = threadIdx.x;
  // this thread's channel in the tile, and its lane in the channel (states
  // j K .. j K + K - 1)
  const int ch = (tid / 32) * Sh::kWarpCh + tid % Sh::kWarpCh;
  const int j = (tid % 32) / Sh::kWarpCh;
  const int d0 = blockIdx.x * kCh;
  const size_t row0 = (size_t)blockIdx.y * (size_t)S;  // (batch, t = 0)
  const int es_dt = dt_bf16 ? 2 : 4, es_x = x_bf16 ? 2 : 4;
  const int es_b = b_bf16 ? 2 : 4, es_c = c_bf16 ? 2 : 4;

  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t ak = (size_t)(d0 + ch) * N + j * K + k;
    if constexpr (kFused)  // a = -exp(a_log), as the plain path forms it
      a2[k] = d0 + ch < D ? -expf(a[ak]) * kLog2e : 0.f;
    else
      a2[k] = d0 + ch < D ? a[ak] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  // the fused entry's per-channel constants: this lane's channel's D skip,
  // and dt_b of the two channels this thread widens (widen_dx)
  float dskip = 0.f;
  float2 dt_bias = make_float2(0.f, 0.f);
  if constexpr (kFused) {
    const int wc = d0 + (2 * tid) % kCh;
    const auto bias = [&](int d) {
      if (d >= D) return 0.f;
      return dt_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(fu.dt_b)[d])
                     : static_cast<const float*>(fu.dt_b)[d];
    };
    dskip = d0 + ch < D ? fu.d_skip[d0 + ch] : 0.f;
    dt_bias = make_float2(bias(wc), bias(wc + 1));
  }

  const int n_chunks = (S + kT - 1) / kT;
  // chunk c is staged in stage c % kStages; one cp.async group is committed
  // per chunk (empty past the last), so waiting until kStages - 2 groups
  // are in flight means chunk ci has landed
#pragma unroll
  for (int cs = 0; cs < kStages - 1; ++cs) {
    if (cs < n_chunks)
      stage_chunk<N, kFused>(smem + cs * Sh::kStage, dt, x, b, c, fu, row0,
                             cs * kT, min(kT, S - cs * kT), d0, D, es_dt,
                             es_x, es_b, es_c, vec, tid);
    cp_async_commit();
  }
  int prev_len = 0;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kT;
    const int len = min(kT, S - t0);
    cp_async_wait_stage();
    __syncthreads();  // chunk ci staged; chunk ci-1's steps are done
    const int cn = ci + kStages - 1;  // into the stage chunk ci-1 left
    if (cn < n_chunks)
      stage_chunk<N, kFused>(smem + (cn % kStages) * Sh::kStage, dt, x, b, c,
                             fu, row0, cn * kT, min(kT, S - cn * kT), d0, D,
                             es_dt, es_x, es_b, es_c, vec, tid);
    cp_async_commit();
    // widen chunk ci: (dt, dt x) pairs and the lanes' B / C rows
    const unsigned char* st = smem + (ci % kStages) * Sh::kStage;
    widen_dx<Sh::kThreads, kFused>(s_dx, st, st + Sh::kRawDx, dt_bf16,
                                   x_bf16, dt_bias, tid);
    widen_bc<N>(s_bc, st + 2 * Sh::kRawDx, b_bf16, tid);
    widen_bc<N>(s_bc + K, st + 2 * Sh::kRawDx + Sh::kRawBc, c_bf16, tid);
    // write chunk ci-1's y
    if (ci > 0) {
      if constexpr (kFused)
        write_out<Sh::kThreads>(y, s_y, row0 + t0 - kT, prev_len, d0, D, vec,
                                x_bf16, tid);
      else
        write_y<Sh::kThreads>(static_cast<float*>(y), s_y, row0 + t0 - kT,
                              prev_len, d0, D, vec, tid);
    }
    __syncthreads();  // chunk ci widened; chunk ci-1's y read out

    // the steps of one group of kU from step g of the chunk: p[s] is this
    // lane's share (its K states) of y at step g + s
    const auto steps = [&](int g, float(&p)[kU]) {
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        const float2 dx = s_dx[(g + s) * kCh + ch];
        const float* bc = s_bc + (g + s) * 2 * N + j * 2 * K;
        float bv[K], cv[K];
        if constexpr (K % 4 == 0) {
#pragma unroll
          for (int k = 0; k < K; k += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bc + k);
            const float4 c4 = *reinterpret_cast<const float4*>(bc + K + k);
            bv[k] = b4.x, bv[k + 1] = b4.y, bv[k + 2] = b4.z,
            bv[k + 3] = b4.w;
            cv[k] = c4.x, cv[k + 1] = c4.y, cv[k + 2] = c4.z,
            cv[k + 3] = c4.w;
          }
        } else if constexpr (K == 2) {
          const float4 bc4 = *reinterpret_cast<const float4*>(bc);
          bv[0] = bc4.x, bv[1] = bc4.y, cv[0] = bc4.z, cv[1] = bc4.w;
        } else {
          const float2 bc2 = *reinterpret_cast<const float2*>(bc);
          bv[0] = bc2.x, cv[0] = bc2.y;
        }
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float abar = exp2_approx(dx.x * a2[k]);
          h[k] = fmaf(abar, h[k], dx.y * bv[k]);
          acc = fmaf(h[k], cv[k], acc);
        }
        p[s] = acc;
      }
    };
    // the fused entry's epilogue on one y of this lane's channel at step tt
    // of the chunk: (y + d_skip x) silu(z), x and z from the chunk's raw
    // stage (it stays until the next chunk's steps)
    const auto gate = [&](float v, int tt) {
      const int i = tt * kCh + ch;
      const unsigned char* sx = st + Sh::kRawDx;
      const unsigned char* sz = st + Sh::kRawZ;
      const float xv =
          x_bf16 ? __bfloat162float(
                       reinterpret_cast<const __nv_bfloat16*>(sx)[i])
                 : reinterpret_cast<const float*>(sx)[i];
      const float zv =
          x_bf16 ? __bfloat162float(
                       reinterpret_cast<const __nv_bfloat16*>(sz)[i])
                 : reinterpret_cast<const float*>(sz)[i];
      // rounded as the plain path rounds it: no FMA contraction
      return __fmul_rn(__fadd_rn(v, __fmul_rn(dskip, xv)), silu(zv));
    };
    // the sums over the channel's lanes of group g's shares, into s_y (in
    // the fused entry, gated)
    const auto flush = [&](float(&p)[kU], int g) {
      ReduceScatter<L / 2, kU, Sh::kWarpCh>::run(p, j);
#pragma unroll
      for (int r = 0; r < kU / L; ++r) {
        const int tt = g + j * (kU / L) + r;
        float v = p[r];
        if constexpr (kFused) v = gate(v, tt);
        s_y[tt * kYStride + ch] = v;
      }
    };
    // group g's sums are flushed while group g + kU's steps run, so the
    // shuffles' latency hides behind the next group's arithmetic
    float prev[kU];
    steps(0, prev);
    int g = kU;
    for (; g < len; g += kU) {
      float p[kU];
      steps(g, p);
      flush(prev, g - kU);
#pragma unroll
      for (int s = 0; s < kU; ++s) prev[s] = p[s];
    }
    flush(prev, g - kU);
    prev_len = len;
  }
  __syncthreads();
  const size_t last = row0 + (size_t)(n_chunks - 1) * kT;
  if constexpr (kFused)
    write_out<Sh::kThreads>(y, s_y, last, prev_len, d0, D, vec, x_bf16, tid);
  else
    write_y<Sh::kThreads>(static_cast<float*>(y), s_y, last, prev_len, d0, D,
                          vec, tid);
}

template <int N, bool kFused>
int launch(const void* dt, const void* x, const void* b, const void* c,
           const float* a, void* y, const Fused& fu, int B, int S, int D,
           int dt_bf16, int x_bf16, int b_bf16, int c_bf16,
           cudaStream_t stream) {
  using Sh = Shape<N, kFused>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_fwd<N, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  // cp.async needs 16-byte aligned rows of dt, x (and z) and spans (or rows)
  // of B and C
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const int es_b = b_bf16 ? 2 : 4;
  const bool spans = !kFused || fu.bc_stride == N;
  const bool bc = spans ? (B == 1 || ((int64_t)S * N) % 8 == 0)
                        : (N * es_b) % 16 == 0 && (fu.bc_stride * es_b) % 16 == 0;
  const int vec = D % 8 == 0 && bc && aligned(dt) && aligned(x) &&
                  aligned(b) && aligned(c) && aligned(y) &&
                  (!kFused || (fu.z_stride % 8 == 0 && aligned(fu.z)));
  const dim3 grid((unsigned)((D + kCh - 1) / kCh), (unsigned)B);
  selective_scan_fwd<N, kFused><<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      dt, x, b, c, a, y, fu, S, D, dt_bf16, x_bf16, b_bf16, c_bf16, vec);
  return (int)cudaGetLastError();
}

// The launch for state size N (1, 2, 4, 8, 16, 32; else
// cudaErrorInvalidValue), after the checks both entries share
template <bool kFused>
int dispatch(const void* dt, const void* x, const void* b, const void* c,
             const float* a, void* y, const Fused& fu, int64_t B, int64_t S,
             int64_t D, int64_t N, int dt_bf16, int x_bf16, int b_bf16,
             int c_bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535 || S > INT32_MAX || D > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int args[] = {(int)B, (int)S, (int)D};
#define SCAN_CASE(n)                                                        \
  case n:                                                                   \
    return launch<n, kFused>(dt, x, b, c, a, y, fu, args[0], args[1],       \
                             args[2], dt_bf16, x_bf16, b_bf16, c_bf16,      \
                             stream);
  switch (N) {
    SCAN_CASE(1)
    SCAN_CASE(2)
    SCAN_CASE(4)
    SCAN_CASE(8)
    SCAN_CASE(16)
    SCAN_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_CASE
}

}  // namespace scan

// Each library holds one entry and its kernel instances: the default build
// the first entry, a build with -DSCAN_FUSED_ENTRY the second.  So no two
// libraries of a process hold the same instances, and the serving path
// builds only the second.
#ifndef SCAN_FUSED_ENTRY

// Plain C entry point (bound with ctypes).  dt, x [B, S, D], b, c [B, S, N],
// a [D, N] (float32) and y [B, S, D] (float32) are device pointers of
// contiguous tensors; each *_bf16 flag says whether that input is bfloat16
// (1) or float32 (0).  Returns cudaGetLastError() after the launch (0 on
// success); an N other than 1, 2, 4, 8, 16, 32, or a batch past the grid's
// y limit, returns cudaErrorInvalidValue.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* b, const void* c,
                                     const float* a, float* y, int64_t B,
                                     int64_t S, int64_t D, int64_t N,
                                     int64_t dt_bf16, int64_t x_bf16,
                                     int64_t b_bf16, int64_t c_bf16,
                                     cudaStream_t stream) {
  const scan::Fused unused{nullptr, nullptr, nullptr, 0, N};
  return scan::dispatch<false>(dt, x, b, c, a, y, unused, B, S, D, N,
                               (int)dt_bf16, (int)x_bf16, (int)b_bf16,
                               (int)c_bf16, stream);
}

#else

// The second entry (bound with ctypes): the mamba block from dt's product to
// the gated output,
//   dt = softplus(dt_proj + dt_b),  a = -exp(a_log),  y = the scan,
//   out = (y + d_skip x) silu(z)  in x's type.
// dt_proj and x [B, S, D] and out [B, S, D] are contiguous; z [B, S, D] is
// rows of z_stride elements; b and c [B, S, N] are rows of bc_stride
// elements (N where contiguous); dt_b [D]; all of these one type, float32
// (bf16 = 0) or bfloat16 (bf16 = 1); a_log [D, N] and d_skip [D] float32.
// Returns as selective_scan_launch does.
extern "C" int selective_scan_fused_launch(
    const void* dt_proj, const void* dt_b, const void* x, const void* z,
    const void* b, const void* c, const float* a_log, const float* d_skip,
    void* out, int64_t B, int64_t S, int64_t D, int64_t N, int64_t z_stride,
    int64_t bc_stride, int64_t bf16, cudaStream_t stream) {
  const scan::Fused fu{z, dt_b, d_skip, z_stride, bc_stride};
  const int t = (int)bf16;
  return scan::dispatch<true>(dt_proj, x, b, c, a_log, out, fu, B, S, D, N,
                              t, t, t, t, stream);
}

#endif  // SCAN_FUSED_ENTRY
