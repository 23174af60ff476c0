// flash_attention: causal / sliding-window / non-causal GQA attention
// forward on Hopper for float32 inputs, with the online softmax kept on
// chip.  bf16 inputs go to flash_attention_sm90.cu (the tensor cores).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel:27, entry flash_attention_padded:77), which walks a
// sequential (B, H, q-block, kv-block) grid of 512 x 512 tiles and carries
// the running max, running sum and float32 accumulator in VMEM scratch
// across the kv axis.
//
// What bounds it on this card: operations.  The function does 4 hd useful
// flops per admitted (query, key) pair and head (q k^T and p v), in float32
// on the CUDA cores (67 TFLOP/s: 128 FMA lanes on each of the 132 SMs); a
// TF32 product would not hold the float32 tolerance.  At gemma3-4b's
// (B = 1, S = 4096, H = 8, K = 4, hd = 256) a causal layer is 68.7 GFLOP,
// 1.03 ms, against ~100 MB of q, k, v and o (~30 us at 3.35 TB/s).  So the
// FMA lanes have to stay busy, and three things keep them from it: shared
// memory (an SM reads 32 floats a clock from it, against 128 FMAs), the
// copies of k and v into it, and the softmax between the two products.
//
// The design (Tiles<HD> below; kernel.py's F32_TILES repeats it):
//   * every lane owns an 8 x 8 register tile in both products, so each
//     float it reads from shared memory feeds 4 FMAs (8 + 8 floats, 64
//     FMAs a step).  S = q k^T: 8 query rows x 8 keys over 64 of the head
//     dims; P V: the same 8 rows x 8 output columns over the tile's 64
//     keys.  A warp owns R = 2048 / hd query rows in both products, so the
//     probabilities and the rescaling never leave the warp:
//       - hd = 256: R = 8; S's 8 x 64 tile is split over the head dims
//         between 4 lanes (DS = 4), summed by a reduce-scatter of 48
//         shuffles; 8 warps, BQ = 64 rows a CTA, 1 CTA an SM;
//       - hd = 128: R = 16, DS = 2 (32 shuffles); 8 warps, BQ = 128, 1 CTA
//         an SM;
//       - hd = 64: R = 32, DS = 1; 4 warps, BQ = 128, 2 CTAs an SM;
//     so every instance runs 8 warps an SM at up to 255 registers a lane
//     (a lane holds 64 scores, 64 accumulators and 8 + 1 float4 operands);
//   * BK = 64 keys a tile.  Copies under the products by cp.async, into
//     staggered buffers: one k and one v tile of 64 keys beside q
//     (216,064 bytes at hd 256, 172,032 at hd 128, 106,496 at hd 64), so
//     v of tile t lands while S of tile t runs and k of tile t + 1 while
//     P V of tile t runs.  Two CTA barriers a tile: one before P V (k of
//     t consumed, v of t landed), one after it (v of t consumed, k of
//     t + 1 landed).  Rows past Sq or Skv arrive as zeros (cp.async's
//     source size 0), never the next batch's rows;
//   * shared-memory rows are padded (4 floats, 8 at hd 128) so that the
//     rows and dims a warp reads in one instruction fall in distinct banks;
//     a lane's rows are interleaved (rg + RG i) and its keys too (kg + 8 j);
//   * the softmax runs in the exp2 domain: 1 / sqrt(hd) and log2 e are
//     folded into one factor applied to S (q is copied as it is); each lane
//     keeps the running max and sum of the NR = 8 / DS rows it owns after
//     the reduce-scatter, reduced over the 8 lanes that share those rows;
//     the factor alpha reaches the P V lanes by shuffles;
//   * GQA: q head h reads kv head h / (H / K);
//   * masks: padding (q < Sq, kv < Skv), causal (kv <= q) and window
//     (kv > q - window), per element, on the tiles that some row of a warp
//     sees only in part; key tiles that no row of a CTA can see are never
//     loaded, and a warp skips the products of a tile that none of its
//     rows can see;
//   * the masked score is the reference's finite -1e30, so a row that has
//     seen only masked keys carries m = -1e30 and is wiped by
//     alpha = exp2(m_prev - m_new) = 0 once a valid key arrives; a row that
//     never sees one ends with o = acc / max(l, 1e-30), never NaN.  Only
//     padding rows, which are not written back, may be such rows: the
//     wrapper refuses a window that leaves a real query row no key
//     (Sq >= Skv + window), where the plain version returns the mean of v;
//   * launch order: a 1-d grid, the heaviest query tile of every (batch,
//     head) first (under a causal mask the last rows see the most keys),
//     heads of one kv group side by side; a grid that fits one wave
//     (seamless's 256 CTAs at hd 64, 2 an SM) runs every other round of
//     one CTA an SM in the other direction, so each SM's pair sums to
//     about the same work (the SM count is read once per device);
//   * o = acc / max(l, 1e-30); ragged Sq and Skv are masked in the kernel,
//     nothing is padded;
//   * the shared-memory opt-in (cudaFuncSetAttribute) once per instance and
//     device; S's loop unrolled 4 steps at hd 256, 2 elsewhere (S_UNROLL:
//     4 is 2% faster at gemma's shapes and 3% slower at seamless causal).
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int BK = 64;  // keys a tile, every instance
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemPerSm = 233472;  // bytes an SM, 1 KB of it per CTA held

// One instance's tiles: ROWS query rows a CTA, KEYS keys a tile, THREADS
// threads a CTA, CTAS CTAs an SM, PAD floats of padding a q / k / v row,
// S_UNROLL steps of S's loop unrolled.
template <int HD_, int ROWS, int KEYS, int THREADS, int CTAS, int PAD,
          int S_UNROLL>
struct TilesOf {
  static constexpr int HD = HD_;
  static constexpr int BQ = ROWS;
  static constexpr int kThreads = THREADS;
  static constexpr int kCtasPerSm = CTAS;
  static constexpr int kSUnroll = S_UNROLL;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int DS = HD / BK;   // lanes splitting S's head dims
  static constexpr int R = 2048 / HD;  // query rows a warp
  static constexpr int RG = R / 8;     // row groups a warp
  static constexpr int NR = 8 / DS;    // rows a lane owns in the softmax
  static constexpr int LD = HD + PAD;  // row stride of the q, k, v tiles
  // row stride of a warp's key-major P tile ([key][rg][8])
  static constexpr int PS = R == 32 ? R + 4 : R;
  static constexpr int kFloats = (BQ + 2 * BK) * LD + kWarps * BK * PS;
  static constexpr int kSmemBytes = kFloats * 4;
  static_assert(KEYS == BK, "64 keys a tile");
  static_assert(ROWS == R * kWarps, "R = 2048 / hd query rows a warp");
  // S: 8 key groups x DS dim groups x RG row groups; P V: HD / 8 column
  // groups x RG row groups; both one warp
  static_assert(8 * DS * RG == 32 && HD / 8 * RG == 32 && DS * NR == 8,
                "lane layout");
  static_assert(LD % 4 == 0 && PS % 4 == 0, "16-byte rows");
  static_assert(CTAS * (kSmemBytes + 1024) <= kSmemPerSm,
                "shared memory for CTAS CTAs an SM");
  static_assert(CTAS * THREADS <= 256, "255 registers a thread");
  static_assert(16 % S_UNROLL == 0, "S's 16 steps in whole unrolled runs");
};

template <int HD>
struct Tiles;
template <>
struct Tiles<64> : TilesOf<64, 128, 64, 128, 2, 4, 2> {};
template <>
struct Tiles<128> : TilesOf<128, 128, 64, 256, 1, 8, 2> {};
template <>
struct Tiles<256> : TilesOf<256, 64, 64, 256, 1, 4, 4> {};

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying ROWS rows of HD floats (row r at src + r * stride) into
// dst [ROWS][LD] (a shared address); rows at or past `valid` (>= 1) arrive
// as zeros.  A thread copies the same 16 bytes of every STEP-th row, so its
// addresses are one base and one step (nothing per row held in registers:
// per-row addresses held across the key loop spilled).
template <typename T, int ROWS>
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* src,
                                          int64_t stride, int valid) {
  constexpr int VPR = T::HD / 4;             // 16-byte chunks a row
  constexpr int STEP = T::kThreads / VPR;    // rows a pass of the CTA
  static_assert(T::kThreads % VPR == 0 && ROWS % STEP == 0,
                "whole rows a pass");
  const int r0 = (int)threadIdx.x / VPR, c = (int)threadIdx.x % VPR * 4;
  dst += (uint32_t)(r0 * T::LD + c) * 4u;
  const float* row0 = src + c;  // a row that exists: valid >= 1
  src += r0 * stride + c;
  const int64_t step = STEP * stride;
#pragma unroll
  for (int u = 0; u < ROWS / STEP; ++u) {
    const bool ok = r0 + u * STEP < valid;
    cp_async16(dst + (uint32_t)(u * STEP * T::LD * 4), ok ? src : row0,
               ok ? 16 : 0);
    src += step;
  }
}

// s[i][j] = q row (rg + RG i) . k key (kg + 8 j) over the lane's 64 head
// dims (4 dg + 4 DS st, st < 16).  qp, kp: row rg and key kg at dim 4 dg.
template <typename T>
__device__ __forceinline__ void s_product(float (&s)[8][8], const float* qp,
                                          const float* kp) {
#pragma unroll 1
  for (int s0 = 0; s0 < 16; s0 += T::kSUnroll)
#pragma unroll
  for (int st = s0; st < s0 + T::kSUnroll; ++st) {
    const int d = 4 * T::DS * st;
    float4 kf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      kf[j] = *reinterpret_cast<const float4*>(kp + j * 8 * T::LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(qp + i * T::RG * T::LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a.x, kf[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, kf[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, kf[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, kf[j].w, s[i][j]);
      }
    }
  }
}

// Sum the DS lanes' partial scores (lane bits 3 .. 3 + log2 DS - 1 are dg)
// so that s[0 .. NR - 1] end up holding rows dg NR .. dg NR + NR - 1 (in
// units of the lane's 8 rows): halve the rows held at each dg bit, the
// highest first, keeping the half the bit names.
template <int BIT, int DS>
__device__ __forceinline__ void reduce_scatter(float (&s)[8][8], int lane) {
  if constexpr (BIT >= 1) {
    constexpr int half = 8 * BIT / DS;
    const bool hi = lane & (8 * BIT);
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float send = hi ? s[i][j] : s[i + half][j];
        const float keep = hi ? s[i + half][j] : s[i][j];
        s[i][j] = keep + __shfl_xor_sync(kFull, send, 8 * BIT);
      }
    reduce_scatter<BIT / 2, DS>(s, lane);
  }
}

// The online softmax of the lane's NR rows (query index qi0 + RG ii) over
// its 8 keys (kj0 + 8 j): masks (MASK: a tile that some row of the warp
// sees only in part), the running max and sum over the 8 lanes of a row
// (kg, lane bits 0-2), alpha, and p written to the warp's P tile at
// pw[key][ii] (key-major, row stride PS).
template <typename T, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[8][8], float (&m)[T::NR],
                                        float (&l)[T::NR],
                                        float (&alpha)[T::NR], float* pw,
                                        int qi0, int kj0, int Sq, int Skv,
                                        int causal, int window, float c) {
  constexpr int NR = T::NR;
#pragma unroll
  for (int ii = 0; ii < NR; ++ii) {
    const int qi = qi0 + T::RG * ii;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bool ok = true;
      if constexpr (MASK) {
        const int kj = kj0 + 8 * j;
        ok = qi < Sq && kj < Skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
      }
      s[ii][j] = ok ? s[ii][j] * c : kNegInf;
      mx = fmaxf(mx, s[ii][j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_new = fmaxf(m[ii], mx);
    alpha[ii] = exp2f(m[ii] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[ii][j] = exp2f(s[ii][j] - m_new);
      sum += s[ii][j];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    l[ii] = l[ii] * alpha[ii] + sum;
    m[ii] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* row = pw + 8 * j * T::PS;
    if constexpr (NR == 2) {
      *reinterpret_cast<float2*>(row) = make_float2(s[0][j], s[1][j]);
    } else {
#pragma unroll
      for (int ii = 0; ii < NR; ii += 4)
        *reinterpret_cast<float4*>(row + ii) = make_float4(
            s[ii][j], s[ii + 1][j], s[ii + 2][j], s[ii + 3][j]);
    }
  }
}

// A value the S lanes own per row (x[ii] for row dg NR + ii) as the P V
// lanes need it (out[i] for row i of the lane's 8): from the lane with the
// same rg, dg = i / NR and kg = 0.
template <typename T>
__device__ __forceinline__ void to_pv_rows(const float (&x)[T::NR],
                                           float (&out)[8], int rg) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (T::DS == 1)
      out[i] = x[i];
    else
      out[i] = __shfl_sync(kFull, x[i % T::NR],
                           8 * (i / T::NR) + (T::HD / 8) * rg);
  }
}

// acc[i] += sum_j p[row i][j] v[j] over the tile's 64 keys; pp: the warp's
// P tile at [0][rg][0]; vp: the v tile at [0][4 cg].  Columns 4 cg and
// 4 cg + HD / 2.
template <typename T>
__device__ __forceinline__ void pv_product(float4 (&acc)[8][2],
                                           const float* pp, const float* vp) {
#pragma unroll 8
  for (int j = 0; j < BK; ++j) {
    const float4 pa = *reinterpret_cast<const float4*>(pp + j * T::PS);
    const float4 pb = *reinterpret_cast<const float4*>(pp + j * T::PS + 4);
    const float4 va = *reinterpret_cast<const float4*>(vp + j * T::LD);
    const float4 vb =
        *reinterpret_cast<const float4*>(vp + j * T::LD + T::HD / 2);
    const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0].x = fmaf(p[i], va.x, acc[i][0].x);
      acc[i][0].y = fmaf(p[i], va.y, acc[i][0].y);
      acc[i][0].z = fmaf(p[i], va.z, acc[i][0].z);
      acc[i][0].w = fmaf(p[i], va.w, acc[i][0].w);
      acc[i][1].x = fmaf(p[i], vb.x, acc[i][1].x);
      acc[i][1].y = fmaf(p[i], vb.y, acc[i][1].y);
      acc[i][1].z = fmaf(p[i], vb.z, acc[i][1].z);
      acc[i][1].w = fmaf(p[i], vb.w, acc[i][1].w);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(T::kThreads, T::kCtasPerSm)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int H, int K, int causal, int window,
              float scale_log2, int sms) {
  constexpr int BQ = T::BQ, LD = T::LD, R = T::R, RG = T::RG, NR = T::NR;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const uint32_t sQ = (uint32_t)__cvta_generic_to_shared(Qs);
  const uint32_t sK = (uint32_t)__cvta_generic_to_shared(Ks);
  const uint32_t sV = (uint32_t)__cvta_generic_to_shared(Vs);

  // heaviest first: the last query tile of every (batch, head), then the
  // one before it; heads fastest, so the heads of a kv group run together.
  // A grid of one wave (every CTA resident at once) turns every other
  // round of `sms` CTAs around, so that an SM's CTAs pair heavy causal
  // tiles with light ones
  const int nq = (Sq + BQ - 1) / BQ;
  const int hb = gridDim.x / nq;  // H B
  int cta = blockIdx.x;
  if (sms > 0 && (int)gridDim.x <= sms * T::kCtasPerSm) {
    const int round = cta / sms, p = cta % sms;
    const int m = min(sms, (int)gridDim.x - round * sms);
    if (round % 2) cta = round * sms + m - 1 - p;
  }
  const int qt = nq - 1 - cta / hb;
  const int h = cta % hb % H;
  const int b = cta % hb / H;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int q_hi = min(q0 + BQ, Sq) - 1;

  // the key range any of this CTA's rows can see
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, q_hi + 1);
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_begin = kv_begin / BK;
  const int kt_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : kt_begin;

  // S lanes: lane = kg + 8 (dg + DS rg); P V lanes: lane = cg + (HD / 8) rg
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = lane % 8;
  const int dg = lane / 8 % T::DS;
  const int rg = lane / (HD / 8);
  const int cg = lane % (HD / 8);
  const int w0 = warp * R;  // the warp's rows: w0 + rg + RG i
  const int wq_lo = q0 + w0, wq_hi = min(q0 + w0 + R, Sq) - 1;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)K * HD;
  const float* qb = q + (((int64_t)b * Sq + q0) * H + h) * HD;
  const float* kb = k + ((int64_t)b * Skv * K + kh) * HD;
  const float* vb = v + ((int64_t)b * Skv * K + kh) * HD;

  copy_tile<T, BQ>(sQ, qb, q_stride, Sq - q0);
  if (kt_begin < kt_end)
    copy_tile<T, BK>(sK, kb + (int64_t)kt_begin * BK * kv_stride, kv_stride,
                     Skv - kt_begin * BK);
  cp_async_commit();
  if (kt_begin < kt_end)
    copy_tile<T, BK>(sV, vb + (int64_t)kt_begin * BK * kv_stride, kv_stride,
                     Skv - kt_begin * BK);
  cp_async_commit();
  cp_async_wait<1>();  // q and the first k
  __syncthreads();

  float m[NR], l[NR];
#pragma unroll
  for (int ii = 0; ii < NR; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
  }
  float4 acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  float* pw = Ps + warp * BK * T::PS;  // this warp's P tile
  const float* qp = Qs + (w0 + rg) * LD + 4 * dg;
  const float* kp = Ks + kg * LD + 4 * dg;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const bool next = kt + 1 < kt_end;
    // does any row of this warp see any key of this tile, and does every
    // row see every key (no mask; rows past Sq are not written)?
    bool sees = wq_lo <= wq_hi, whole = k0 + BK <= Skv;
    if (causal) {
      sees = sees && k0 <= wq_hi;
      whole = whole && k0 + BK - 1 <= wq_lo;
    }
    if (window > 0) {
      sees = sees && k0 + BK - 1 > wq_lo - window;
      whole = whole && k0 > wq_hi - window;
    }
    if (sees) {
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      s_product<T>(s, qp, kp);
      reduce_scatter<T::DS / 2, T::DS>(s, lane);
      float alpha[NR], a_pv[8];
      float* p_at = pw + kg * T::PS + 8 * rg + NR * dg;
      const int qi0 = q0 + w0 + rg + RG * NR * dg;
      if (whole)
        softmax<T, false>(s, m, l, alpha, p_at, qi0, k0 + kg, Sq, Skv,
                          causal, window, scale_log2);
      else
        softmax<T, true>(s, m, l, alpha, p_at, qi0, k0 + kg, Sq, Skv,
                         causal, window, scale_log2);
      to_pv_rows<T>(alpha, a_pv, rg);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          acc[i][c].x *= a_pv[i];
          acc[i][c].y *= a_pv[i];
          acc[i][c].z *= a_pv[i];
          acc[i][c].w *= a_pv[i];
        }
    }
    cp_async_wait<0>();  // v of this tile
    __syncthreads();     // k of this tile consumed; v and P visible
    if (next)
      copy_tile<T, BK>(sK, kb + (int64_t)(k0 + BK) * kv_stride, kv_stride,
                       Skv - k0 - BK);
    cp_async_commit();
    if (sees) pv_product<T>(acc, pw + 8 * rg, Vs + 4 * cg);
    cp_async_wait<0>();  // k of the next tile
    __syncthreads();     // v and P of this tile consumed; next k visible
    if (next)
      copy_tile<T, BK>(sV, vb + (int64_t)(k0 + BK) * kv_stride, kv_stride,
                       Skv - k0 - BK);
    cp_async_commit();
  }

  float l_pv[8];
  to_pv_rows<T>(l, l_pv, rg);
  float* ob = o + (((int64_t)b * Sq + q0) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = w0 + rg + RG * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l_pv[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float4 out = acc[i][c];
      out.x *= inv;
      out.y *= inv;
      out.z *= inv;
      out.w *= inv;
      *reinterpret_cast<float4*>(ob + r * q_stride + 4 * cg + c * HD / 2) =
          out;
    }
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int H, int K, int causal,
                  int window, cudaStream_t stream) {
  using T = Tiles<HD>;
  auto kern = flash_fwd_f32<HD, T>;
  // the shared-memory opt-in and the SM count, once per device (the first
  // 64 devices)
  static uint64_t ready = 0;
  static int sms_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  int sms = bit ? sms_of[dev] : 0;
  if (!(ready & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (bit) {
      sms_of[dev] = sms;
      ready |= bit;
    }
  }
  const int64_t ctas = (int64_t)((Sq + T::BQ - 1) / T::BQ) * H * B;
  if (ctas >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kern<<<(unsigned)ctas, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K,
      causal, window, scale_log2, sms);
  return (int)cudaGetLastError();
}

template <int HD>
static void tiles(int* out) {
  using T = Tiles<HD>;
  out[0] = T::BQ;
  out[1] = BK;
  out[2] = T::kThreads;
  out[3] = T::kCtasPerSm;
}

}  // namespace flash_f32

// Plain C entry point (bound with ctypes).  q [B, Sq, H, hd], k / v
// [B, Skv, K, hd] and o [B, Sq, H, hd] are device pointers of contiguous,
// 16-byte aligned float32 tensors; hd is 64, 128 or 256; window <= 0 means
// no window.  Returns cudaGetLastError() after the launch (0 on success);
// an unsupported hd or a grid past the card's limits returns
// cudaErrorInvalidValue.  Skv = 0 gives o = 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t Sq, int64_t Skv, int64_t H,
                                      int64_t K, int64_t hd, int64_t causal,
                                      int64_t window, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  const int b = (int)B, sq = (int)Sq, skv = (int)Skv, h = (int)H,
            kk = (int)K, c = (int)causal, w = (int)window;
  switch (hd) {
    case 64:
      return flash_f32::launch<64>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                   stream);
    case 128:
      return flash_f32::launch<128>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                    stream);
    case 256:
      return flash_f32::launch<256>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The compiled tiles of the instance for head dim hd: out[0..3] = query rows
// a CTA, keys a tile, threads a CTA, CTAs an SM.  Returns 0, or
// cudaErrorInvalidValue for an hd with no instance.
extern "C" int flash_attention_f32_tiles(int64_t hd, int* out) {
  switch (hd) {
    case 64:
      flash_f32::tiles<64>(out);
      return 0;
    case 128:
      flash_f32::tiles<128>(out);
      return 0;
    case 256:
      flash_f32::tiles<256>(out);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}
