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

template <int N>
struct Shape {
  static constexpr int K = N < kMaxStatesPerThread ? N : kMaxStatesPerThread;
  static constexpr int L = N / K;  // lanes per channel
  static constexpr int kThreads = kCh * L;
  // a warp holds kWarpCh channels; lane j of a channel sits j kWarpCh
  // lanes from lane 0 (a warp's lanes run over the channels first)
  static constexpr int kWarpCh = 32 / L;
  static_assert(kU % L == 0, "a group's steps split evenly over the lanes");
  // shared memory, in bytes: kStages raw stages of dt, x (kT x kCh) and B, C
  // (kT x N), each sized for float32; the widened (dt, dt x) pairs and
  // B / C rows of the current chunk; the y tile
  static constexpr int kRawDx = kT * kCh * 4;
  static constexpr int kRawBc = kT * N * 4;
  static constexpr int kStage = 2 * kRawDx + 2 * kRawBc;
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

// (dt, dt x) pairs [kT][kCh] from the raw dt and x tiles, two channels a
// thread at a time; every load of a thread is issued before its stores
template <int kThreads, typename TD, typename TX>
__device__ __forceinline__ void widen_dx_as(float2* dst, const void* dt,
                                            const void* x, int tid) {
  constexpr int kIters = kT * kCh / 2 / kThreads;
  static_assert(kIters * 2 * kThreads == kT * kCh, "whole pairs");
#pragma unroll
  for (int r = 0; r < kIters; ++r) {
    const int i = 2 * (tid + r * kThreads);
    const float2 d = load2<TD>(dt, i), v = load2<TX>(x, i);
    reinterpret_cast<float4*>(dst)[i / 2] =
        make_float4(d.x, d.x * v.x, d.y, d.y * v.y);
  }
}

template <int kThreads>
__device__ __forceinline__ void widen_dx(float2* dst, const void* dt,
                                         const void* x, int dt_bf16,
                                         int x_bf16, int tid) {
  using bf = __nv_bfloat16;
  if (dt_bf16 && x_bf16) widen_dx_as<kThreads, bf, bf>(dst, dt, x, tid);
  else if (dt_bf16) widen_dx_as<kThreads, bf, float>(dst, dt, x, tid);
  else if (x_bf16) widen_dx_as<kThreads, float, bf>(dst, dt, x, tid);
  else widen_dx_as<kThreads, float, float>(dst, dt, x, tid);
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

// Asynchronous copies of a tile's rows [kT][kCh] of `es`-byte elements
// (dt or x) into `dst`; D % 8 == 0, so a 16-byte piece lies wholly inside
// the channel range or wholly outside it, and then it is zero-filled.
template <int kThreads, int es>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const void* src, size_t row,
                                           int len, int d0, int D, int tid) {
  constexpr int per_row = kCh * es / 16;
  constexpr int el = 16 / es;
  for (int i = tid; i < kT * per_row; i += kThreads) {
    const int tt = i / per_row, d = d0 + (i % per_row) * el;
    const bool in = tt < len && d < D;
    const unsigned char* p = static_cast<const unsigned char*>(src) +
                             (in ? ((row + tt) * (size_t)D + d) * es : 0);
    cp_async16(dst + i * 16, p, in ? 16 : 0);
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
// tiles [kT][kCh] and the B and C spans [kT][N], in their own types; every
// element outside the sequence or the channel range is 0.  Aligned inputs
// (`vec`) go by cp.async; the others by plain loads.
template <int N>
__device__ __forceinline__ void stage_chunk(
    unsigned char* st, const void* dt, const void* x, const void* b,
    const void* c, size_t row0, int t0, int len, int d0, int D, int es_dt,
    int es_x, int es_b, int es_c, bool vec, int tid) {
  using Sh = Shape<N>;
  unsigned char* s_dt = st;
  unsigned char* s_x = st + Sh::kRawDx;
  unsigned char* s_b = st + 2 * Sh::kRawDx;
  unsigned char* s_c = s_b + Sh::kRawBc;
  const size_t row = row0 + t0;
  if (vec) {
    constexpr int T = Sh::kThreads;
    if (es_dt == 2) stage_rows<T, 2>(s_dt, dt, row, len, d0, D, tid);
    else stage_rows<T, 4>(s_dt, dt, row, len, d0, D, tid);
    if (es_x == 2) stage_rows<T, 2>(s_x, x, row, len, d0, D, tid);
    else stage_rows<T, 4>(s_x, x, row, len, d0, D, tid);
    if (es_b == 2) stage_span<N, T, 2>(s_b, b, row * N, len, tid);
    else stage_span<N, T, 4>(s_b, b, row * N, len, tid);
    if (es_c == 2) stage_span<N, T, 2>(s_c, c, row * N, len, tid);
    else stage_span<N, T, 4>(s_c, c, row * N, len, tid);
    return;
  }
  for (int i = tid; i < kT * kCh; i += Sh::kThreads) {
    const int tt = i / kCh, cc = i % kCh;
    const bool in = tt < len && d0 + cc < D;
    const size_t g = (row + tt) * (size_t)D + d0 + cc;
    copy_elem(s_dt, i, dt, g, in, es_dt);
    copy_elem(s_x, i, x, g, in, es_x);
  }
  for (int i = tid; i < kT * N; i += Sh::kThreads) {
    const bool in = i < len * N;
    copy_elem(s_b, i, b, row * N + i, in, es_b);
    copy_elem(s_c, i, c, row * N + i, in, es_c);
  }
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
    selective_scan_fwd(const void* __restrict__ dt, const void* __restrict__ x,
                       const void* __restrict__ b, const void* __restrict__ c,
                       const float* __restrict__ a, float* __restrict__ y,
                       int S, int D, int dt_bf16, int x_bf16, int b_bf16,
                       int c_bf16, int vec) {
  using Sh = Shape<N>;
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
    a2[k] = d0 + ch < D ? a[(size_t)(d0 + ch) * N + j * K + k] * kLog2e : 0.f;
    h[k] = 0.f;
  }

  const int n_chunks = (S + kT - 1) / kT;
  // chunk c is staged in stage c % kStages; one cp.async group is committed
  // per chunk (empty past the last), so waiting until kStages - 2 groups
  // are in flight means chunk ci has landed
#pragma unroll
  for (int cs = 0; cs < kStages - 1; ++cs) {
    if (cs < n_chunks)
      stage_chunk<N>(smem + cs * Sh::kStage, dt, x, b, c, row0, cs * kT,
                     min(kT, S - cs * kT), d0, D, es_dt, es_x, es_b, es_c,
                     vec, tid);
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
      stage_chunk<N>(smem + (cn % kStages) * Sh::kStage, dt, x, b, c, row0,
                     cn * kT, min(kT, S - cn * kT), d0, D, es_dt, es_x,
                     es_b, es_c, vec, tid);
    cp_async_commit();
    // widen chunk ci: (dt, dt x) pairs and the lanes' B / C rows
    const unsigned char* st = smem + (ci % kStages) * Sh::kStage;
    widen_dx<Sh::kThreads>(s_dx, st, st + Sh::kRawDx, dt_bf16, x_bf16, tid);
    widen_bc<N>(s_bc, st + 2 * Sh::kRawDx, b_bf16, tid);
    widen_bc<N>(s_bc + K, st + 2 * Sh::kRawDx + Sh::kRawBc, c_bf16, tid);
    // write chunk ci-1's y
    if (ci > 0)
      write_y<Sh::kThreads>(y, s_y, row0 + t0 - kT, prev_len, d0, D, vec,
                            tid);
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
    // the sums over the channel's lanes of group g's shares, into s_y
    const auto flush = [&](float(&p)[kU], int g) {
      ReduceScatter<L / 2, kU, Sh::kWarpCh>::run(p, j);
#pragma unroll
      for (int r = 0; r < kU / L; ++r)
        s_y[(g + j * (kU / L) + r) * kYStride + ch] = p[r];
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
  write_y<Sh::kThreads>(y, s_y, row0 + (size_t)(n_chunks - 1) * kT, prev_len,
                        d0, D, vec, tid);
}

template <int N>
int launch(const void* dt, const void* x, const void* b, const void* c,
           const float* a, float* y, int B, int S, int D, int dt_bf16,
           int x_bf16, int b_bf16, int c_bf16, cudaStream_t stream) {
  using Sh = Shape<N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_fwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  // cp.async needs 16-byte aligned rows of dt and x and spans of B and C
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const int vec = D % 8 == 0 && (B == 1 || ((int64_t)S * N) % 8 == 0) &&
                  aligned(dt) && aligned(x) && aligned(b) && aligned(c) &&
                  aligned(y);
  const dim3 grid((unsigned)((D + kCh - 1) / kCh), (unsigned)B);
  selective_scan_fwd<N><<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      dt, x, b, c, a, y, S, D, dt_bf16, x_bf16, b_bf16, c_bf16, vec);
  return (int)cudaGetLastError();
}

}  // namespace scan

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
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535 || S > INT32_MAX || D > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int args[] = {(int)B, (int)S, (int)D, (int)dt_bf16, (int)x_bf16,
                      (int)b_bf16, (int)c_bf16};
#define SCAN_CASE(n)                                                        \
  case n:                                                                   \
    return scan::launch<n>(dt, x, b, c, a, y, args[0], args[1], args[2],    \
                           args[3], args[4], args[5], args[6], stream);
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
