// causal_conv: the mamba-1 block's depthwise causal conv over the sequence,
// its bias and the SiLU after it, in one pass (the prefill's conv stage).
//
//   xc_t = bf16(silu(float(bf16(sum_i x_{t - kw + 1 + i} w_i + b))))
//   (per channel d; x_t = 0 for t < 0; in float32 models the casts are
//   identities)
//
// Replaces no TPU kernel: the JAX package leaves the conv to XLA, which
// fuses its taps, bias and SiLU on its own.  In eager PyTorch the same chain
// (models/ssm.py's plain path: a zero context, a cat, a float32 accumulator,
// kw taps of widen-multiply-add, the bias, a cast, SiLU in float32, a cast)
// is some twenty kernels that move ~120 bytes per channel and token; this one
// reads x once and writes xc once.
//
// What bounds it on this card.  Bytes: at (B, S, di) = (1, 4096, 8192) in
// bf16 it reads 64 MB of x and writes 64 MB of xc (w and b are 80 KB): about
// 0.04 ms at 3.35 TB/s, 4 B per channel and token.  Its arithmetic (kw
// products and sums, an exp and a division per element) is far below the
// CUDA cores' rate.
//
// What the design does:
//   * x is read in place: the first half of in_proj's output, rows of
//     x_stride elements (2 di in the model), so no copy and no cat; the
//     kw - 1 rows before the sequence's start are read as zeros;
//   * one thread owns 16 bytes of channels (8 bf16 or 4 float32) and loads
//     them with one vector load per row; a block of kThreads threads walks
//     kTokens tokens of one batch row, keeping the kw - 1 previous rows of
//     its channels in registers, and loads kUnroll rows ahead of the
//     arithmetic so that several loads are in flight per thread;
//   * the taps are summed in causal_conv's order from a zero accumulator
//     with __fmul_rn / __fadd_rn (and the library is built with
//     --fmad=false), so nothing is contracted to an FMA and the sum, the
//     bias and the first cast equal the plain version bit for bit; SiLU is
//     v / (1 + expf(-v)) in float32, as PyTorch computes it;
//   * a ragged di (not a multiple of the vector), a row stride off the
//     vector or an unaligned pointer take scalar loads through the same
//     loop, each channel masked;
//   * kw is a template parameter, built for mamba-1's 4; x, w, b and xc
//     share one type, float32 or bf16 (a template parameter).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv {

constexpr int kThreads = 128;  // threads per block
constexpr int kTokens = 32;    // tokens a block walks
constexpr int kUnroll = 4;     // rows loaded ahead of the arithmetic
constexpr int kWidth = 4;      // kw, the one width built

static_assert(kTokens % kUnroll == 0, "a tile holds whole groups of rows");

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ __forceinline__ static float widen(float v) { return v; }
  __device__ __forceinline__ static float narrow(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // round to nearest even, as a cast to torch.bfloat16
  __device__ __forceinline__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};

// 16 bytes of T: one vector load or store
template <typename T>
struct alignas(16) Pack {
  T e[Elem<T>::kVec];
};

// kVec consecutive channels from d of one row, widened; channels at or past
// D (scalar path only) and rows before the sequence read 0
template <typename T, bool kVecLoads>
__device__ __forceinline__ void load_row(float (&out)[Elem<T>::kVec],
                                         const T* row, bool in, int d,
                                         int D) {
  constexpr int V = Elem<T>::kVec;
  if constexpr (kVecLoads) {
    if (in) {
      const Pack<T> p = *reinterpret_cast<const Pack<T>*>(row + d);
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = Elem<T>::widen(p.e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      out[k] = in && d + k < D ? Elem<T>::widen(row[d + k]) : 0.f;
  }
}

template <typename T, bool kVecLoads>
__device__ __forceinline__ void store_row(T* row, const Pack<T>& v, int d,
                                          int D) {
  if constexpr (kVecLoads) {
    *reinterpret_cast<Pack<T>*>(row + d) = v;
  } else {
#pragma unroll
    for (int k = 0; k < Elem<T>::kVec; ++k)
      if (d + k < D) row[d + k] = v.e[k];
  }
}

template <typename T, int KW, bool kVecLoads>
__global__ void __launch_bounds__(kThreads)
    causal_conv_silu_fwd(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ b, T* __restrict__ y, int S,
                         int D, int64_t x_stride) {
  static_assert(KW >= 2, "a conv with history rows");
  constexpr int V = Elem<T>::kVec;
  const int d = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (d >= D) return;
  const int t0 = blockIdx.y * kTokens;
  const int len = min(kTokens, S - t0);
  const int64_t row0 = (int64_t)blockIdx.z * S;  // (batch, t = 0)

  float wv[KW][V], bv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const bool in = d + k < D;
#pragma unroll
    for (int i = 0; i < KW; ++i)
      wv[i][k] = in ? Elem<T>::widen(w[(int64_t)(d + k) * KW + i]) : 0.f;
    bv[k] = in ? Elem<T>::widen(b[d + k]) : 0.f;
  }
  // rows t0 - KW + 1 .. t0 - 1, zeros before the sequence
  float hist[KW - 1][V];
#pragma unroll
  for (int i = 0; i < KW - 1; ++i) {
    const int t = t0 - (KW - 1) + i;
    load_row<T, kVecLoads>(hist[i], x + (row0 + max(t, 0)) * x_stride,
                           t >= 0, d, D);
  }
  for (int g = 0; g < len; g += kUnroll) {
    float cur[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + g + u;
      const bool in = g + u < len;
      load_row<T, kVecLoads>(cur[u], x + (row0 + (in ? t : t0)) * x_stride,
                             in, d, D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g + u >= len) break;
      Pack<T> out;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KW - 1; ++i)
          acc = __fadd_rn(acc, __fmul_rn(hist[i][k], wv[i][k]));
        acc = __fadd_rn(acc, __fmul_rn(cur[u][k], wv[KW - 1][k]));
        acc = __fadd_rn(acc, bv[k]);
        const float v = Elem<T>::widen(Elem<T>::narrow(acc));
        out.e[k] = Elem<T>::narrow(v / (1.f + expf(-v)));
      }
      store_row<T, kVecLoads>(y + (row0 + t0 + g + u) * (int64_t)D, out, d,
                              D);
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int i = 0; i + 1 < KW - 1; ++i) hist[i][k] = hist[i + 1][k];
        hist[KW - 2][k] = cur[u][k];
      }
    }
  }
}

template <typename T, int KW>
int launch(const void* x, const void* w, const void* b, void* y, int B, int S,
           int D, int64_t x_stride, cudaStream_t stream) {
  constexpr int V = Elem<T>::kVec;
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const bool vec = D % V == 0 && x_stride % V == 0 && aligned(x) &&
                   aligned(y);
  const dim3 grid((unsigned)((D + V * kThreads - 1) / (V * kThreads)),
                  (unsigned)((S + kTokens - 1) / kTokens), (unsigned)B);
  const T* xs = static_cast<const T*>(x);
  const T* ws = static_cast<const T*>(w);
  const T* bs = static_cast<const T*>(b);
  T* ys = static_cast<T*>(y);
  if (vec)
    causal_conv_silu_fwd<T, KW, true>
        <<<grid, kThreads, 0, stream>>>(xs, ws, bs, ys, S, D, x_stride);
  else
    causal_conv_silu_fwd<T, KW, false>
        <<<grid, kThreads, 0, stream>>>(xs, ws, bs, ys, S, D, x_stride);
  return (int)cudaGetLastError();
}

}  // namespace conv

// Plain C entry point (bound with ctypes).  x [B, S, D] is a device pointer
// to rows of x_stride elements (row b S + t at x + (b S + t) x_stride);
// w [D, KW], b [D] and y [B, S, D] are contiguous; all four are float32
// (bf16 = 0) or bfloat16 (bf16 = 1).  Returns cudaGetLastError() after the
// launch (0 on success); a KW other than 4, a batch past the grid's z limit
// or a sequence past its y limit returns cudaErrorInvalidValue.
extern "C" int causal_conv_silu_launch(const void* x, const void* w,
                                       const void* b, void* y, int64_t B,
                                       int64_t S, int64_t D, int64_t KW,
                                       int64_t x_stride, int64_t bf16,
                                       cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535 || (S + conv::kTokens - 1) / conv::kTokens > 65535 ||
      D > INT32_MAX || KW != conv::kWidth)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return conv::launch<__nv_bfloat16, conv::kWidth>(x, w, b, y, (int)B,
                                                     (int)S, (int)D, x_stride,
                                                     stream);
  return conv::launch<float, conv::kWidth>(x, w, b, y, (int)B, (int)S, (int)D,
                                           x_stride, stream);
}
