// flash_attention: causal / sliding-window / non-causal GQA attention
// forward on Hopper for float32 inputs, with the online softmax kept on
// chip.  bf16 inputs go to flash_attention_sm90.cu (the tensor cores).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, entry flash_attention_padded), which walks a sequential
// (B, H, q-block, kv-block) grid of 512 x 512 tiles and carries the running
// max, running sum and float32 accumulator in VMEM scratch across the kv
// axis.
//
// What bounds it on this card: operations.  At the serving path's shape
// (B = 1, S = 4096, H = 8, K = 4, hd = 256) the function reads q, k, v and
// writes o once (~100 MB in float32, ~30 us at 3.35 TB/s) but does
// 4 S^2 H hd / 2 useful multiply-adds for a causal layer (~69 GFLOP, ~1 ms
// at the CUDA cores' 67 TFLOP/s float32).  The arithmetic stays float32 on
// the CUDA cores: a TF32 product would not hold the float32 tolerance.
//
// What the design does:
//   * one CTA of 256 threads owns BQ = 64 query rows of one (batch, head);
//     a loop inside the CTA sweeps the kv axis in BK = 64 key tiles, in
//     place of the TPU's sequential grid axis, so m, l and the accumulator
//     stay in registers for the whole sweep and o is written once;
//   * q (pre-scaled by 1/sqrt(hd), as the reference does), the k and v tiles
//     and the probability tile are staged in shared memory (rows padded by
//     4 floats so the 16-byte loads of a quarter-warp hit distinct banks);
//   * GQA: q head h reads kv head h / (H / K);
//   * masks: padding (q < Sq, kv < Skv), causal (kv <= q) and window
//     (kv > q - window), applied per element inside a tile; key tiles that
//     the causal or window mask leaves fully masked for all of a CTA's rows
//     are never loaded (the 29 sliding-window layers of gemma3 visit at most
//     17 of 64 key tiles per query tile at S = 4096);
//   * the masked score is the reference's finite -1e30, so a row that has
//     seen only masked keys carries m = -1e30 and is wiped by
//     alpha = exp(m_prev - m_new) = 0 once a valid key arrives; a row that
//     never sees one ends with o = acc / max(l, 1e-30), never NaN.  Only
//     padding rows, which are not written back, may be such rows: the
//     wrapper refuses a window that leaves a real query row no key
//     (Sq >= Skv + window), where the plain version returns the mean of v;
//   * o = acc / max(l, 1e-30);
//   * ragged Sq and Skv are masked in the kernel; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per kv tile
constexpr int kPad = 4;      // floats of padding per q/k/v row
constexpr int LDP = BK + 16; // row stride of the probability tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int LD = HD + kPad;
  static constexpr size_t floats = (size_t)BQ * LD + 2 * (size_t)BK * LD +
                                   (size_t)BQ * LDP + 2 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// One 16-byte vector of the input type.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* src, float* dst, float scale) {
    float4 v = *reinterpret_cast<const float4*>(src);
    v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    *reinterpret_cast<float4*>(dst) = v;
  }
  __device__ static void store4(float* dst, float4 v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
};

// Stage `rows` rows of HD elements (row r at src + r * stride) into dst
// [rows][HD + kPad] as float32 times `scale`; rows at or past `valid` are
// zero.
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* src, int64_t stride, int rows,
                          int valid, float scale) {
  constexpr int VPR = HD / Vec<T>::N;  // vectors per row
  constexpr int LD = HD + kPad;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * Vec<T>::N;
    float* d = dst + r * LD + c;
    if (r < valid) {
      Vec<T>::load(src + r * stride + c, d, scale);
    } else {
      for (int e = 0; e < Vec<T>::N; ++e) d[e] = 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
          int K, int causal, int window, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int NC = HD / 64;  // float4 column groups per thread in P V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* alpha_s = Ps + BQ * LDP;
  float* l_s = alpha_s + BQ;

  const int tid = threadIdx.x;
  // heaviest causal tiles (the last query rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int q_hi = min(q0 + BQ, Sq) - 1;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)K * HD;
  const T* qb = q + (((int64_t)b * Sq + q0) * H + h) * HD;
  const T* kb = k + ((int64_t)b * Skv * K + kh) * HD;
  const T* vb = v + ((int64_t)b * Skv * K + kh) * HD;

  load_tile<T, HD>(Qs, qb, q_stride, BQ, Sq - q0, scale);

  // the key range any of this CTA's rows can see
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, q_hi + 1);
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_begin = kv_begin / BK;
  const int kt_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : kt_begin;

  // scores / softmax layout: rows tr + 16 i, columns tc + 16 j
  const int tr = tid / 16, tc = tid % 16;
  // P V layout: rows og + 16 i, columns 4 oc + 64 c (float4 each)
  const int og = tid / 16, oc = tid % 16;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, HD>(Ks, kb + (int64_t)k0 * kv_stride, kv_stride, BK,
                     Skv - k0, 1.f);
    load_tile<T, HD>(Vs, vb + (int64_t)k0 * kv_stride, kv_stride, BK,
                     Skv - k0, 1.f);
    __syncthreads();

    // S = (q scale) k^T for a 4 x 4 block of (row, key) pairs
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Ks + (tc + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // masks and the online softmax; a row's 64 keys sit on 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        bool ok = qi < Sq && kj < Skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * LDP + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tc == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[og + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= a; acc[i][c].y *= a; acc[i][c].z *= a; acc[i][c].w *= a;
      }
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (og + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(Vs + (j + jj) * LD +
                                                   4 * oc + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c].x = fmaf(p, vv[c].x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv[c].y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv[c].z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv[c].w, acc[i][c].w);
          }
        }
      }
    }
  }

  // the running sums move from the softmax layout to the P V layout
  __syncthreads();
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[tr + 16 * i] = l[i];
  }
  __syncthreads();
  T* ob = o + (((int64_t)b * Sq + q0) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = og + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 out = acc[i][c];
      out.x *= inv; out.y *= inv; out.z *= inv; out.w *= inv;
      Vec<T>::store4(ob + r * q_stride + 4 * oc + 64 * c, out);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_fwd<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD>::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  const float scale = 1.f / sqrtf((float)HD);
  kern<<<grid, kThreads, Smem<HD>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, K, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int K, int hd, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash

// Plain C entry point (bound with ctypes).  q [B, Sq, H, hd], k / v
// [B, Skv, K, hd] and o [B, Sq, H, hd] are device pointers of contiguous,
// 16-byte aligned float32 tensors.  window <= 0 means no window.  Returns
// cudaGetLastError() after the launch (0 on success); an unsupported hd
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t Sq, int64_t Skv, int64_t H,
                                      int64_t K, int64_t hd, int64_t causal,
                                      int64_t window, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  return flash::dispatch_hd<float>(q, k, v, o, (int)B, (int)Sq, (int)Skv,
                                   (int)H, (int)K, (int)hd, (int)causal,
                                   (int)window, stream);
}
