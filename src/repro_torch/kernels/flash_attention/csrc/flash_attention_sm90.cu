// flash_attention_bf16: causal / sliding-window / non-causal GQA attention
// forward for bf16 inputs on Hopper's tensor cores (sm_90a: wgmma, TMA,
// mbarriers, named barriers, setmaxnreg).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel:27, entry flash_attention_padded:77), which walks a
// sequential (B, H, q-block, kv-block) grid of 512 x 512 tiles and carries
// the running max, running sum and float32 accumulator in VMEM scratch
// across the kv axis.  Float32 inputs keep the CUDA-core kernel in
// flash_attention.cu.
//
// What bounds it on this card.  The function does 4 hd useful flops per
// admitted (query, key) pair and head (q k^T and p v) and one exp2; its
// bytes (q, k, v and o once) take a fifth or less of the products' time at
// the serving shapes.  The products run on the tensor cores at 989 TFLOP/s
// (dense bf16); the exp2s on the SFU (MUFU), 16 a clock on each of the 132
// SMs, 4.18 T/s at 1.98 GHz.  So the MUFU floor over the operations bound
// is 989e12 / (4 hd 4.18e12) = 14.8 / hd:
//   * hd = 64 (qwen3-moe-30b-a3b, seamless-m4t-large-v2): 0.92.  A causal
//     (1, 4096, 32, 4, 64) layer: 68.74 GFLOP, 0.0695 ms, against 268.5 M
//     exp2, 0.0642 ms.  The softmax costs as much as the products, so the
//     kernel is near its bound only when each runs under the other;
//   * hd = 128 (jamba-1.5-large-398b, arctic-480b, internvl2-76b): 0.46.
//     (1, 4096, 64, 8, 128): 0.2780 ms of products, 0.1284 of exp2;
//   * hd = 256 (gemma3-4b): 0.23.  (1, 4096, 8, 4, 256): 0.0695 against
//     0.0161; the products alone bound it.
//
// What else bounds it: each CTA reads its key range's k and v once per BQ
// query rows, and at BQ = 128 that is 128 flops a byte of k and v, from L2
// for the heads of a kv group after the first: 2.2 GB at hd = 128's layer
// above, whose copies alone (no product, no softmax) take 0.24 ms on an
// H100, near the products' 0.28 (PERF.md §6, tools/flash_variants.py).  So
// the products, the exp2s and the copies all have to overlap.
//
// The design (Tiles<HD> below; kernel.py's TILES repeats it):
//   * one CTA owns BQ = 128 query rows of one (batch, head): warpgroup 0 is
//     the producer (setmaxnreg down to 24; one thread issues every TMA
//     load), warpgroups 1 and 2 are consumers, each owning 64 of the rows
//     (setmaxnreg up to 240); a loop inside the CTA sweeps the key axis in
//     BK-key tiles, in place of the TPU's sequential grid axis, so m, l and
//     O stay in registers and O is written once;
//   * hd = 64: BK = 128, 3 stages (112 KB of shared memory), S at n128 64
//     floats a thread, P 32 registers, O 32; hd = 128: BK = 128, 2 stages
//     (160 KB), O 64; hd = 256: BK = 64, 2 stages (192 KB: 64 KB of q,
//     2 x (32 + 32) KB of k and v), S 32, O 128.  Three consumers of 160
//     registers (BQ = 192) run hd = 64 causal within 5% of two, either way
//     from run to run, but leave seamless's 176 CTAs a third of a second
//     wave on 132 SMs (tools/flash_variants.py hd64_bq192);
//   * the softmax runs under the products, in two ways at once.  Within a
//     consumer (step): S_j = Q K_j^T is issued and committed with the P V
//     product of tile j - 1, the wait drains only S_j
//     (wgmma.wait_group 1), so tile j's mask, max and exp2 run while
//     P_{j-1} V_{j-1} is still on the tensor cores; O takes tile j's alpha
//     after that product, before P_j V_j is issued.  Between consumers: they
//     issue their products in turns, a ring of named barriers (ids 1 and
//     2, one a consumer), so one consumer's exp2s run while the other's
//     products are on the tensor cores.  Every consumer takes one turn per
//     key tile of the CTA and one more, computing or not, so the turns
//     balance whatever rows a consumer has.  Each turn is one straight line
//     of code from the issue to the last wait: the masked and unmasked
//     tiles run in loops of their own and the conditional arrivals are
//     predicated, because ptxas serialises the asynchronous products
//     around any branch it cannot prove uniform (its warning C7518);
//   * copies: 4-d TMA maps over the wrapper's contiguous layouts, q
//     [B, Sq, H, hd] as (hd, H, Sq, B) and k / v [B, Skv, K, hd] as
//     (hd, K, Skv, B), so rows past Sq or Skv arrive as zeros (never the
//     next batch's rows); 128-byte swizzle, whose box is 64 bf16 wide, so
//     a tile is hd / 64 slabs of [rows][64]; q is loaded once, k and v
//     through a ring of kStages stages with full and empty mbarriers for
//     each, so a stage's k goes back to the producer as soon as S is
//     computed, before the P V product that still reads its v;
//   * S = Q K^T: wgmma m64n{BK}k16, A = the consumer's 64 q rows and B = the
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
//   * launch order: a 1-d grid, the heaviest query tile of every (batch,
//     head) first (under a causal mask the last rows see the most keys),
//     heads of one kv group side by side;
//   * o = O / max(l, 1e-30), rounded to bf16 once and stored from
//     registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_sm90 {

constexpr int kSlab = 64;      // bf16 columns per 128-byte swizzle box
constexpr float kNegInf = -1e30f;
constexpr int kRegisterFile = 65536;  // 32-bit registers an SM
constexpr int kMaxSmem = 232448;      // dynamic shared memory a CTA

// One instance's tiles: BQ query rows a CTA (64 a consumer warpgroup), BK
// keys a tile, kStages stages of the k / v ring, and the registers of the
// producer and of each consumer after setmaxnreg.
template <int BQ_, int BK_, int STAGES, int CONSUMERS, int PRODUCER_REGS,
          int CONSUMER_REGS>
struct TilesOf {
  static constexpr int BQ = BQ_;
  static constexpr int BK = BK_;
  static constexpr int kStages = STAGES;
  static constexpr int kConsumers = CONSUMERS;
  static constexpr int kThreads = 128 * (CONSUMERS + 1);
  static constexpr int kProducerRegs = PRODUCER_REGS;
  static constexpr int kConsumerRegs = CONSUMER_REGS;
  static_assert(BQ == 64 * CONSUMERS, "64 query rows a consumer");
  static_assert(BK == 64 || BK == 128, "S is m64n64 or m64n128");
  static_assert(STAGES >= 2, "the overlapped loop holds two stages");
  // setmaxnreg moves registers within the CTA's launch allocation: at most
  // 65536 / kThreads a thread, in steps of 8
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                    (CONSUMERS + 1) * (kRegisterFile / kThreads / 8 * 8),
                "the register split exceeds the launch allocation");
};

template <int HD>
struct Tiles;
template <>
struct Tiles<64> : TilesOf<128, 128, 3, 2, 24, 240> {};
template <>
struct Tiles<128> : TilesOf<128, 128, 2, 2, 24, 240> {};
template <>
struct Tiles<256> : TilesOf<128, 64, 2, 2, 24, 240> {};

template <int HD, class T>
struct Smem {
  static constexpr int kSlabs = HD / kSlab;
  static constexpr uint32_t q_bytes = T::BQ * HD * 2;
  static constexpr uint32_t kv_bytes = T::BK * HD * 2;  // one k or v tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + T::kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + T::kStages * kv_bytes;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 4 * T::kStages);
  // the dynamic allocation: room to align the base to 1024 bytes (the
  // 128-byte swizzle's period, which the wgmma descriptors assume)
  static constexpr uint32_t alloc = bytes + 1024;
  static_assert(alloc <= kMaxSmem, "the tiles exceed shared memory");
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

// S[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both from shared memory,
// both K-major (128-byte swizzle); zero-initialise when scale_d == 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, scale_d);
  if constexpr (BK == 128) wgmma_ss_n128(d, da, db, scale_d);
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  if constexpr (HD == 256) wgmma_rs_n256(d, a, db);
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- named barriers: the consumers' turns ------------------------------ //
//
// Between a product's issue and its wait the overlapped consumer has no
// branch: ptxas serialises the asynchronous products around a path it
// cannot prove uniform (warning C7518), so the conditional arrivals below
// are predicated instructions, not branches.

// 256 threads a phase: the 128 of the consumer whose turn it is (bar.sync)
// and the 128 of the one before it in the ring (bar.arrive)
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id, bool pred = true) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p bar.arrive %0, 256;\n}\n" ::"r"(id),
      "r"((int)pred)
      : "memory");
}

// ---- one consumer's work on a key tile ---------------------------------- //

// The ring of k / v stages and its mbarriers, as a consumer sees it.
struct Ring {
  uint32_t k, v;                         // stage 0's k and v tiles
  uint32_t k_full, v_full, k_empty, v_empty;  // + 8 * stage
};

// One arrival a warp on an empty mbarrier (when pred): every lane is past
// its reads.
__device__ __forceinline__ void release(uint32_t bar, int lane,
                                        bool pred = true) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)(pred && lane == 0))
      : "memory");
}

// S = Q K^T for a consumer's 64 rows and one key tile: issued and
// committed, not waited for.
template <int HD, class T>
__device__ __forceinline__ void issue_s(float (&s)[T::BK / 2],
                                        uint32_t q_rows, uint32_t kbuf) {
  fence_regs(s);
  wgmma_fence();
  // K-major descriptors: SBO = 8 rows of 128 bytes; LBO unused (16)
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da =
        smem_desc(q_rows + (kk / 4) * T::BQ * 128 + off, 16, 1024);
    const uint64_t db =
        smem_desc(kbuf + (kk / 4) * T::BK * 128 + off, 16, 1024);
    wgmma_ss<T::BK>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one key tile: issued and committed, not waited for.
template <int HD, class T>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&pa)[T::BK / 16][4],
                                         uint32_t vbuf) {
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    // MN-major: LBO = the next 64 hd columns (slab), SBO = 8 keys
    const uint64_t db = smem_desc(vbuf + kk * 16 * 128, T::BK * 128, 1024);
    wgmma_rs<HD>(acc, pa[kk], db);
  }
  wgmma_commit();
}

// What one consumer needs to walk the CTA's key tiles.
struct Walk {
  int kt_begin, n;  // the CTA's key tiles: kt_begin .. kt_begin + n - 1
  int a, b;         // this consumer's: a .. b - 1 (a == b: none)
  int e1, e2;       // of those, [a, e1) and [e2, b) cross an edge
  int qw0, qw1, r0, c0, lane;
  int Skv, causal, window;
  float scale_log2;
};

// The masks and the online softmax on one tile's S, in place: s becomes p;
// m, l and alpha (the factor O takes before this tile's P V) are updated.
// The per-element mask (padding, causal, window; selects, no branch) only
// where MASK: on a tile that crosses an edge for these rows.
template <class T, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[T::BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int k0, const Walk& w) {
  constexpr int N = T::BK / 2;
  // scale into the exp2 domain
#pragma unroll
  for (int x = 0; x < N; ++x) s[x] *= w.scale_log2;
  if constexpr (MASK) {
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int qi = w.r0 + 8 * ((x >> 1) & 1);
      const int kj = k0 + 8 * (x >> 2) + w.c0 + (x & 1);
      const bool ok = (kj < w.Skv) & (!w.causal | (kj <= qi)) &
                      ((w.window <= 0) | (kj > qi - w.window));
      s[x] = ok ? s[x] : kNegInf;
    }
  }
  // row max over the 4 lanes that share a row
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    mx[r] = fmaxf(mx[r], s[x]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    s[x] = exp2f(s[x] - m[r]);
    l[r] += s[x];
  }
}

// P in bf16, laid out as the A operand of BK / 16 k16 products
template <class T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[T::BK / 16][4],
                                       const float (&s)[T::BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&acc)[HD / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];
}

// The softmax of tile j under the P V product of tile j - 1 (and under the
// other consumers' products, by turns).  Turn i
// (step) issues S of tile kt_begin + i (DO_S) and P V of the tile before it
// (DO_PV), each a straight line from the issue to the last wait; every
// consumer takes n + 1 turns, whether its rows see those tiles or not.
template <int HD, class T, bool DO_S, bool DO_PV, bool MASK>
__device__ __forceinline__ void step(int i, const Walk& w, const Ring& g,
                                     uint32_t q_rows, int cw,
                                     float (&s)[T::BK / 2],
                                     uint32_t (&pa)[T::BK / 16][4],
                                     float (&acc)[HD / 2], float (&m)[2],
                                     float (&l)[2]) {
  constexpr uint32_t kv_bytes = Smem<HD, T>::kv_bytes;
  constexpr int C = T::kConsumers;
  const int st = i % T::kStages, pst = (i + T::kStages - 1) % T::kStages;
  const uint32_t ph = (i / T::kStages) & 1;
  const uint32_t pph = ((i + T::kStages - 1) / T::kStages - 1) & 1;
  // the tiles' copies are waited for outside the turn
  if (i < w.n) mbar_wait(g.k_full + 8 * st, ph);
  if (i > 0) mbar_wait(g.v_full + 8 * pst, pph);
  turn_wait(1 + cw);
  if constexpr (DO_S) issue_s<HD, T>(s, q_rows, g.k + st * kv_bytes);
  if constexpr (DO_PV) issue_pv<HD, T>(acc, pa, g.v + pst * kv_bytes);
  // the last consumer's last turn hands nothing on
  turn_pass(1 + (cw + 1) % C, i < w.n || cw < C - 1);
  if constexpr (DO_S) {
    wgmma_wait<DO_PV ? 1 : 0>();  // S of this tile; P V runs on
    fence_regs(s);
  }
  release(g.k_empty + 8 * st, w.lane, i < w.n);
  float alpha[2];
  if constexpr (DO_S)
    softmax<T, MASK>(s, m, l, alpha, (w.kt_begin + i) * T::BK, w);
  if constexpr (DO_PV) {
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) fence_regs(pa[kk]);
  }
  release(g.v_empty + 8 * pst, w.lane, i > 0);
  if constexpr (DO_S) {
    // O takes this tile's alpha before its P V, outside the turn
    rescale<HD>(acc, alpha);
    pack_p<T>(pa, s);
  }
}

template <int HD, class T>
__device__ __forceinline__ void consumer(const Walk& w, const Ring& g,
                                                 uint32_t q_rows, int cw,
                                                 float (&acc)[HD / 2],
                                                 float (&m)[2],
                                                 float (&l)[2]) {
  float s[T::BK / 2];
  uint32_t pa[T::BK / 16][4];
  // the first turn is consumer 0's
  if (cw == T::kConsumers - 1) turn_pass(1);
  // turns: before a, at a (S only), a + 1 .. b - 1 (S and P V; masked in
  // [a, e1) and [e2, b)), at b (P V only), after b
  const int ia = w.a - w.kt_begin, ib = w.b - w.kt_begin;
  int i = 0;
#define FLASH_STEP(S_, PV_, MASK_)                                          \
  step<HD, T, S_, PV_, MASK_>(i, w, g, q_rows, cw, s, pa, acc, m, l)
  if (ia < ib) {
    for (; i < ia; ++i) FLASH_STEP(false, false, false);
    FLASH_STEP(true, false, true);
    ++i;
    for (; i < min(w.e1 - w.kt_begin, ib); ++i) FLASH_STEP(true, true, true);
    for (; i < min(w.e2 - w.kt_begin, ib); ++i) FLASH_STEP(true, true, false);
    for (; i < ib; ++i) FLASH_STEP(true, true, true);
    FLASH_STEP(false, true, false);
    ++i;
  }
  for (; i <= w.n; ++i) FLASH_STEP(false, false, false);
#undef FLASH_STEP
}

// ---- the kernel --------------------------------------------------------- //

template <int HD, class T>
__global__ void __launch_bounds__(T::kThreads, 1)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                    int K, int causal, int window, float scale_log2) {
  using L = Smem<HD, T>;
  constexpr int NS = L::kSlabs;
  constexpr int BQ = T::BQ, BK = T::BK, S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::q_off;
  const uint32_t q_full = base + L::bar_off;
  const Ring g = {base + L::k_off, base + L::v_off, q_full + 8,
                  q_full + 8 + 8 * S, q_full + 8 + 16 * S,
                  q_full + 8 + 24 * S};

  // heaviest first: the last query tile of every (batch, head), then the
  // one before it; heads fastest, so the heads of a kv group run together
  const int nq = (Sq + BQ - 1) / BQ;
  const int hb = gridDim.x / nq;  // H B
  const int cta = blockIdx.x;
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

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(g.k_full + 8 * s, 1);
      mbar_init(g.v_full + 8 * s, 1);
      // one arrival per consumer warp
      mbar_init(g.k_empty + 8 * s, 4 * T::kConsumers);
      mbar_init(g.v_empty + 8 * s, 4 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: every TMA load, from one thread ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        tma_load_4d(sq + c * BQ * 128, &tm_q, q_full, c * kSlab, h, q0, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % S;
        const uint32_t ph = (i / S) & 1;
        const uint32_t kbuf = g.k + st * L::kv_bytes;
        const uint32_t vbuf = g.v + st * L::kv_bytes;
        mbar_wait(g.k_empty + 8 * st, ph ^ 1);  // the first pass finds it free
        mbar_expect_tx(g.k_full + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          tma_load_4d(kbuf + c * BK * 128, &tm_k, g.k_full + 8 * st,
                      c * kSlab, kh, kt * BK, b);
        mbar_wait(g.v_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(g.v_full + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          tma_load_4d(vbuf + c * BK * 128, &tm_v, g.v_full + 8 * st,
                      c * kSlab, kh, kt * BK, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    Walk w;
    w.kt_begin = kt_begin;
    w.n = kt_end - kt_begin;
    w.lane = t % 32;
    w.qw0 = q0 + 64 * cw;  // this consumer's first row
    w.qw1 = min(w.qw0 + 63, Sq - 1);
    // this thread's two rows (accumulator layout of wgmma m64nN: row
    // 16 warp + lane / 4 and 8 below it; columns 8 j + 2 (lane % 4) + {0, 1})
    w.r0 = w.qw0 + 16 * warp + w.lane / 4;
    w.c0 = 2 * (w.lane % 4);
    w.Skv = Skv;
    w.causal = causal;
    w.window = window;
    w.scale_log2 = scale_log2;
    // the key tiles some row of this consumer can see
    w.a = w.b = kt_begin;
    if (w.qw0 <= w.qw1) {
      int lo = 0, hi = Skv;
      if (causal) hi = min(Skv, w.qw1 + 1);
      if (window > 0) lo = max(0, w.qw0 - window + 1);
      if (hi > lo) {
        w.a = lo / BK;
        w.b = (hi + BK - 1) / BK;
      }
    }
    // tiles that cross an edge for these rows: the window's lower edge
    // (a key at or below qw1 - window) up to e1, the Skv edge or the
    // causal diagonal (a key past qw0) from e2
    w.e1 = window > 0 && w.qw1 - window >= 0 ? (w.qw1 - window) / BK + 1 : 0;
    w.e2 = min(Skv / BK, causal ? (w.qw0 + 1) / BK : Skv / BK);
    w.e1 = min(max(w.e1, w.a), w.b);
    w.e2 = min(max(w.e2, w.e1), w.b);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

    const uint32_t q_rows = sq + cw * 64 * 128;
    mbar_wait(q_full, 0);
    consumer<HD, T>(w, g, q_rows, cw, acc, m, l);

    // o = O / max(l, 1e-30), rounded to bf16 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = w.r0 + 8 * r;
      if (qi > w.qw1) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          o + (((int64_t)b * Sq + qi) * H + h) * HD + w.c0;
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
// library needs no -lcuda.  (The host functions have internal linkage: the
// library exports its C entry points only.)
static EncodeTiled encode_tiled() {
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
static bool make_map(CUtensorMap* map, const void* ptr, int hd, int n1,
                     int n2, int n3, int rows) {
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
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int H, int K, int causal,
                  int window, cudaStream_t stream) {
  using T = Tiles<HD>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, H, Sq, B, T::BQ) ||
      !make_map(&tk, k, HD, K, Skv, B, T::BK) ||
      !make_map(&tv, v, HD, K, Skv, B, T::BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_bf16_sm90<HD, T>;
  // the shared-memory opt-in, once per device (the first 64 devices)
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<HD, T>::alloc);
    if (e != cudaSuccess) return (int)e;
    opted_in |= bit;
  }
  const int64_t ctas = (int64_t)((Sq + T::BQ - 1) / T::BQ) * H * B;
  if (ctas >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kern<<<grid, T::kThreads, Smem<HD, T>::alloc, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, K, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
static void tiles(int* out) {
  using T = Tiles<HD>;
  out[0] = T::BQ;
  out[1] = T::BK;
  out[2] = T::kStages;
  out[3] = T::kConsumers;
}

}  // namespace flash_sm90

// Plain C entry point (bound with ctypes).  q [B, Sq, H, hd], k / v
// [B, Skv, K, hd] and o [B, Sq, H, hd] are device pointers of contiguous,
// 16-byte aligned bfloat16 tensors; hd is 64, 128 or 256; window <= 0 means
// no window.  Returns cudaGetLastError() after the launch (0 on success);
// an unsupported hd, a grid past the card's limits, or a tensor map that
// cuTensorMapEncodeTiled refuses, returns cudaErrorInvalidValue.  Skv = 0
// gives o = 0, as the float32 kernel does.
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

// The compiled tiles of the instance for head dim hd: out[0..3] = query rows
// a CTA, keys a tile, stages of the k / v ring, consumer warpgroups.
// Returns 0, or cudaErrorInvalidValue for an hd with no instance.
extern "C" int flash_attention_bf16_tiles(int64_t hd, int* out) {
  switch (hd) {
    case 64:
      flash_sm90::tiles<64>(out);
      return 0;
    case 128:
      flash_sm90::tiles<128>(out);
      return 0;
    case 256:
      flash_sm90::tiles<256>(out);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}
