// selective_scan: the mamba-1 selective scan (the prefill's hot loop) on
// Hopper, with the hidden state kept on chip for the whole sequence.
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
// What bounds it on this card: bytes, in principle.  At the serving shape
// (B, S, D, N) = (1, 4096, 8192, 16), with dt in float32 and x in bf16, the
// function reads ~201 MB and writes 134 MB of float32 y (~0.10 ms at
// 3.35 TB/s); its ~3.8 GFLOP of float32 arithmetic (537 M exps among them)
// is ~0.06 ms at the 67 TFLOP/s of the CUDA cores.  This first kernel is
// limited by neither: per (t, d, n) it spends a few shared-memory loads, an
// expf and log2(N) shuffles on the sequential chain, so its instruction
// throughput is the limit (about 7.5x the byte bound on an H100).  Making
// it fast is later work.
//
// What the design does:
//   * no grid axis carries the state: blocks run in no order, so each block
//     owns a tile of kCh = 32 channels of one batch row and loops over the
//     whole sequence itself, h in registers from the first step to the last;
//   * one state per thread: a block has kCh * N threads, lane n of a
//     channel's N contiguous lanes holds h[d, n] and A[d, n], so at B = 1,
//     D = 8192, N = 16 the card gets 131,072 threads (256 blocks of 512)
//     where one thread per channel would give 8,192; y_t is a shuffle
//     reduction over the channel's N lanes;
//   * loads are coalesced through shared memory: a chunk of kT time steps
//     of dt and x (the tile's 32 channels, contiguous along D) and of the
//     B and C rows the tile shares are staged, widened to float32, before
//     the chunk's steps run; y is staged and written back a chunk at a time;
//   * dt, x, B and C may each be float32 or bfloat16 (a flag per tensor, the
//     branch uniform across the block); A is float32; y is float32;
//   * N is a template parameter (1, 2, 4, 8, 16, 32); anything else is
//     refused by the entry point;
//   * full-precision expf (no fast-math flags); ragged S and D are masked in
//     the kernel, nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kCh = 32;  // channels per block
constexpr int kT = 64;   // time steps per staged chunk

// Element i of a float32 (bf16 == 0) or bfloat16 (bf16 != 0) array, widened.
__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  if (bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <int N>
__global__ void __launch_bounds__(kCh * N)
    selective_scan_fwd(const void* __restrict__ dt, const void* __restrict__ x,
                       const void* __restrict__ b, const void* __restrict__ c,
                       const float* __restrict__ a, float* __restrict__ y,
                       int S, int D, int dt_bf16, int x_bf16, int b_bf16,
                       int c_bf16) {
  __shared__ float s_dt[kT][kCh];
  __shared__ float s_x[kT][kCh];
  __shared__ float s_y[kT][kCh];
  __shared__ float s_b[kT][N];
  __shared__ float s_c[kT][N];

  constexpr int kThreads = kCh * N;
  const int tid = threadIdx.x;
  const int ch = tid / N;  // this thread's channel in the tile
  const int n = tid % N;   // and its state
  const int d0 = blockIdx.x * kCh;
  const size_t row0 = (size_t)blockIdx.y * (size_t)S;  // (batch, t = 0)
  const float a_dn = (d0 + ch < D) ? a[(size_t)(d0 + ch) * N + n] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int len = min(kT, S - t0);
    // stage the chunk: dt and x for the tile's channels, B and C rows;
    // outside the sequence or the channel range they are 0 (h stays put)
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      const bool in = tt < len && d0 + cc < D;
      const size_t g = (row0 + t0 + tt) * (size_t)D + d0 + cc;
      s_dt[tt][cc] = in ? load(dt, g, dt_bf16) : 0.f;
      s_x[tt][cc] = in ? load(x, g, x_bf16) : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int tt = i / N, nn = i % N;
      const bool in = tt < len;
      const size_t g = (row0 + t0 + tt) * (size_t)N + nn;
      s_b[tt][nn] = in ? load(b, g, b_bf16) : 0.f;
      s_c[tt][nn] = in ? load(c, g, c_bf16) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = s_dt[tt][ch];
      const float abar = expf(dtv * a_dn);
      h = abar * h + (dtv * s_x[tt][ch]) * s_b[tt][n];
      float p = h * s_c[tt][n];
      // y_t = sum over the channel's N lanes (contiguous, N-aligned)
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[tt][ch] = p;
    }
    __syncthreads();
    // write the chunk's y back, coalesced along D; the next chunk's staging
    // touches only the input tiles, and its steps write s_y after the next
    // barrier, when these reads are done
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (tt < len && d0 + cc < D)
        y[(row0 + t0 + tt) * (size_t)D + d0 + cc] = s_y[tt][cc];
    }
  }
}

template <int N>
int launch(const void* dt, const void* x, const void* b, const void* c,
           const float* a, float* y, int B, int S, int D, int dt_bf16,
           int x_bf16, int b_bf16, int c_bf16, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + kCh - 1) / kCh), (unsigned)B);
  selective_scan_fwd<N><<<grid, kCh * N, 0, stream>>>(
      dt, x, b, c, a, y, S, D, dt_bf16, x_bf16, b_bf16, c_bf16);
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
