// flash_attention_bf16: causal / sliding-window / non-causal GQA attention
// forward for bf16 inputs on Hopper's tensor cores (sm_90a: wgmma, TMA,
// mbarriers, setmaxnreg).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel:27, entry flash_attention_padded:77), which walks a
// sequential (B, H, q-block, kv-block) grid of 512 x 512 tiles and carries
// the running max, running sum and float32 accumulator in VMEM scratch
// across the kv axis.  Float32 inputs keep the CUDA-core kernel in
// flash_attention.cu.
//
// What bounds it on this card: operations.  At the serving path's shape
// (B = 1, S = 4096, H = 8, K = 4, hd = 256) the function does 4 hd useful
// flops per admitted (query, key) pair and head: 68.7 GFLOP for a causal
// layer, 30.1 GFLOP under gemma3's window of 1024, against 50 MB of q, k, v
// and o.  At 989 TFLOP/s (dense bf16) and 3.35 TB/s that is 69 us and 30 us
// of products against 15 us of traffic, so only the tensor cores can come
// near the bound: both products are warpgroup MMAs on bf16 operands with
// float32 accumulators, and the copies run on the TMA, beside them.
//
// What the design does:
//   * one CTA of 384 threads owns BQ = 128 query rows of one (batch, head):
//     warpgroup 0 is the producer (setmaxnreg down to 40 registers; one
//     thread issues every TMA load), warpgroups 1 and 2 are consumers, each
//     owning 64 of the rows (setmaxnreg up to 232: at hd = 256 the float32
//     O accumulator alone is 128 registers a thread, S another 32); a loop
//     inside the CTA sweeps the key axis in BK = 64 key tiles, in place of
//     the TPU's sequential grid axis, so m, l and O stay in registers and O
//     is written once;
//   * copies: 4-d TMA maps over the wrapper's contiguous layouts, q
//     [B, Sq, H, hd] as (hd, H, Sq, B) and k / v [B, Skv, K, hd] as
//     (hd, K, Skv, B), so rows past Sq or Skv arrive as zeros (never the
//     next batch's rows); 128-byte swizzle, whose box is 64 bf16 wide, so
//     a tile is hd / 64 slabs of [rows][64]; q is loaded once, k and v
//     through a ring of 2 stages with full (k, v apart) and empty mbarriers;
//     at hd = 256 that is 64 KB of q and 2 x (32 + 32) KB of k and v;
//   * S = Q K^T: wgmma m64n64k16, A = the consumer's 64 q rows and B = the
//     k tile, both K-major in shared memory (hd contiguous); the descriptors
//     step 32 bytes along a slab's row for each k16 and on to the next slab
//     every four;
//   * O += P V: wgmma m64n{hd}k16 with A = P from registers: the S
//     accumulator's (row, column) layout is the A operand's, so P is
//     rounded to bf16 in place with no shuffle (the one deliberate rounding,
//     where the JAX package's attention_chunked rounds p to v's dtype); B =
//     the v tile, MN-major (hd contiguous), read through the descriptor's
//     transpose bit, its hd / 64 slabs one leading-byte stride apart;
//   * the softmax runs in the exp2 domain: the scale 1 / sqrt(hd) and log2 e
//     are folded into one float32 factor applied to S (q is not rounded
//     again), so p = exp2(s c - m); the running sum l is taken from the
//     float32 p, each thread keeping its part of a row until the end;
//   * GQA: q head h reads kv head h / (H / K);
//   * masks: padding (kv < Skv; q rows past Sq are computed on zeros and not
//     written), causal (kv <= q) and window (kv > q - window), with the
//     reference's finite -1e30.  Only tiles that cross the causal diagonal,
//     the window's lower edge or the Skv edge for a consumer's rows take
//     the per-element mask; key tiles that no row of the CTA can see are
//     never loaded, and a tile none of a consumer's 64 rows can see is not
//     computed by that consumer.  A row that has seen only masked keys
//     carries m = -1e30 and is wiped by alpha = 0 once a valid key arrives;
//     the wrapper refuses a window that leaves a real row no key at all;
//   * o = O / max(l, 1e-30), rounded to bf16 once and stored from
//     registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_sm90 {

constexpr int BQ = 128;        // query rows per CTA (two consumers of 64)
constexpr int BK = 64;         // keys per tile
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kStages = 2;
constexpr int kSlab = 64;      // bf16 columns per 128-byte swizzle box
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int kSlabs = HD / kSlab;
  static constexpr uint32_t q_bytes = BQ * HD * 2;
  static constexpr uint32_t kv_bytes = BK * HD * 2;  // one k or v tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * kv_bytes;
  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr uint32_t bytes = bar_off + 8 * 8;
  // the dynamic allocation: room to align the base to 1024 bytes (the
  // 128-byte swizzle's period, which the wgmma descriptors assume)
  static constexpr uint32_t alloc = bytes + 1024;
};

// ---- mbarriers and TMA -------------------------------------------------- //

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------- //

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin an accumulator array's registers around the asynchronous products,
// so that no ordinary access moves across the fence or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both from shared memory,
// both K-major (128-byte swizzle); zero-initialise when scale_d == 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 64] += A[64 x 16] B[16 x 64]: A (bf16 pairs) from registers, B
// from shared memory, MN-major (transposed; 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] B[16 x 128]: A (bf16 pairs) from registers, B
// from shared memory, MN-major (transposed; 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 256] += A[64 x 16] B[16 x 256]: A (bf16 pairs) from registers, B
// from shared memory, MN-major (transposed; 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  if constexpr (HD == 256) wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel --------------------------------------------------------- //

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                    int K, int causal, int window, float scale_log2) {
  using L = Smem<HD>;
  constexpr int NS = L::kSlabs;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::q_off;
  const uint32_t sk = base + L::k_off;
  const uint32_t sv = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t k_full = q_full + 8;   // + 8 * stage
  const uint32_t v_full = q_full + 24;  // + 8 * stage
  const uint32_t empty = q_full + 40;   // + 8 * stage

  // heaviest causal tiles (the last query rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int q_hi = min(q0 + BQ, Sq) - 1;

  // the key range any of this CTA's rows can see
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, q_hi + 1);
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_begin = kv_begin / BK;
  const int kt_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : kt_begin;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: every TMA load, from one thread ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        tma_load_4d(sq + c * BQ * 128, &tm_q, q_full, c * kSlab, h, q0, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i & 1;
        const uint32_t ph = (i >> 1) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);  // the first pass finds it free
        const uint32_t kbuf = sk + st * L::kv_bytes;
        const uint32_t vbuf = sv + st * L::kv_bytes;
        mbar_expect_tx(k_full + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          tma_load_4d(kbuf + c * BK * 128, &tm_k, k_full + 8 * st, c * kSlab,
                      kh, kt * BK, b);
        mbar_expect_tx(v_full + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          tma_load_4d(vbuf + c * BK * 128, &tm_v, v_full + 8 * st, c * kSlab,
                      kh, kt * BK, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qw0 = q0 + 64 * cw;  // this consumer's first row
    const int qw1 = min(qw0 + 63, Sq - 1);
    // this thread's two rows (accumulator layout of wgmma m64nN: row
    // 16 warp + lane / 4 and 8 below it; columns 8 j + 2 (lane % 4) + {0, 1})
    const int r0 = qw0 + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

    // K-major descriptors: SBO = 8 rows of 128 bytes; LBO unused (1)
    const uint32_t q_rows = sq + cw * 64 * 128;
    mbar_wait(q_full, 0);

    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int st = i & 1;
      const uint32_t ph = (i >> 1) & 1;
      const int k0 = kt * BK;
      const bool none = qw0 > qw1 || (causal && k0 > qw1) ||
                        (window > 0 && k0 + BK - 1 <= qw0 - window);
      mbar_wait(k_full + 8 * st, ph);
      if (!none) {
        const uint32_t kbuf = sk + st * L::kv_bytes;
        float s[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t da = smem_desc(q_rows + (kk / 4) * BQ * 128 + off,
                                        16, 1024);
          const uint64_t db = smem_desc(kbuf + (kk / 4) * BK * 128 + off, 16,
                                        1024);
          wgmma_ss_n64(s, da, db, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // scale into the exp2 domain; the per-element mask only on tiles
        // that cross an edge for these 64 rows
        const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw0) ||
                          (window > 0 && k0 <= qw1 - window);
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] *= scale_log2;
        if (edge) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int qi = r0 + 8 * ((x >> 1) & 1);
            const int kj = k0 + 8 * (x >> 2) + c0 + (x & 1);
            bool ok = kj < Skv;
            if (causal) ok = ok && kj <= qi;
            if (window > 0) ok = ok && kj > qi - window;
            if (!ok) s[x] = kNegInf;
          }
        }

        // online softmax: row max over the 4 lanes that share a row
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int r = (x >> 1) & 1;
          mx[r] = fmaxf(mx[r], s[x]);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int r = (x >> 1) & 1;
          s[x] = exp2f(s[x] - m[r]);
          l[r] += s[x];
        }
        // P in bf16, laid out as the A operand of four k16 products
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        }
#pragma unroll
        for (int x = 0; x < HD / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];

        mbar_wait(v_full + 8 * st, ph);
        const uint32_t vbuf = sv + st * L::kv_bytes;
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // MN-major: LBO = the next 64 hd columns (slab), SBO = 8 keys
          const uint64_t db = smem_desc(vbuf + kk * 16 * 128, BK * 128, 1024);
          wgmma_rs<HD>(acc, pa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      } else {
        mbar_wait(v_full + 8 * st, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // o = O / max(l, 1e-30), rounded to bf16 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi > qw1) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = o + (((int64_t)b * Sq + qi) * H + h) * HD + c0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---- host side ---------------------------------------------------------- //

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over a contiguous [n3, n2, n1, hd] bf16 tensor, boxes of 64
// columns x 1 x `rows` x 1, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int n1, int n2,
              int n3, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)hd * n1 * 2,
                                 (cuuint64_t)hd * n1 * n2 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, H, Sq, B, BQ) ||
      !make_map(&tk, k, HD, K, Skv, B, BK) ||
      !make_map(&tv, v, HD, K, Skv, B, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_bf16_sm90<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<HD>::alloc);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kern<<<grid, kThreads, Smem<HD>::alloc, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, K, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90

// Plain C entry point (bound with ctypes).  q [B, Sq, H, hd], k / v
// [B, Skv, K, hd] and o [B, Sq, H, hd] are device pointers of contiguous,
// 16-byte aligned bfloat16 tensors; hd is 64, 128 or 256; window <= 0 means
// no window.  Returns cudaGetLastError() after the launch (0 on success);
// an unsupported hd, or a tensor map that cuTensorMapEncodeTiled refuses,
// returns cudaErrorInvalidValue.  Skv = 0 gives o = 0, as the float32
// kernel does.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int64_t B,
                                           int64_t Sq, int64_t Skv, int64_t H,
                                           int64_t K, int64_t hd,
                                           int64_t causal, int64_t window,
                                           cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (Skv == 0)
    return (int)cudaMemsetAsync(o, 0, (size_t)(B * Sq * H * hd) * 2, stream);
  const int b = (int)B, sq = (int)Sq, skv = (int)Skv, h = (int)H,
            kk = (int)K, c = (int)causal, w = (int)window;
  switch (hd) {
    case 64:
      return flash_sm90::launch<64>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                    stream);
    case 128:
      return flash_sm90::launch<128>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                     stream);
    case 256:
      return flash_sm90::launch<256>(q, k, v, o, b, sq, skv, h, kk, c, w,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
