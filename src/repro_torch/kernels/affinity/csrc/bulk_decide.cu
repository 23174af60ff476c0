// bulk_decide: the fused wave pass on Hopper — candidate mask, float32
// strategy score and first-minimum winner per row, for R pending block rows
// over W workers.
//
// Replaces the Pallas TPU kernel repro/kernels/affinity/bulk_kernel.py
// (_bulk_decide_kernel, entry bulk_decide_kernel).  That kernel gets its
// argmin from the TPU walking worker tiles one after another: a [BF, 1]
// accumulator carries (min, idx) across the sequential grid axis and a strict
// `<` keeps the earlier tile on a tie.  GPU blocks run in no order, so the
// cross-block argmin is a second pass here:
//
//   pass 1 (bulk_cells)   one thread per worker, kRows rows per block: the
//                         validity and score of each cell, then a block
//                         reduction of the row's 64-bit keys
//                         (order-preserving float bits << 32 | worker index)
//                         into one partial per (row, block);
//   pass 2 (bulk_winner)  one warp per row reduces its partials.
//
// The minimum key is the minimum score at its lowest worker index, which is
// np.argmin's first-minimum rule, and it does not depend on block order, so
// the winner is deterministic.  A row whose minimum is +inf has no valid
// worker and wins -1.
//
// What bounds it on this card: bytes.  Each call reads occ [W, T] i32,
// wmask [R, W] and warm [R, W] i32 and writes valid [R, W] and score
// [R, W] f32; the violation count (2 R W T 0/1 multiply-adds) is far under
// the integer rate.  The design reads occ once into 32-tag bitmask words
// (shared with affinity_valid.cu), keeps every [R, W] read and write
// coalesced across the warp, and makes pass 2 read R x ceil(W / 256)
// partials only.
#include "affinity_common.cuh"

namespace affinity {

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

__device__ __forceinline__ uint64_t warp_min(uint64_t key) {
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other < key ? other : key;
  }
  return key;
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

__global__ void bulk_cells(const uint32_t* __restrict__ pos,
                           const uint32_t* __restrict__ neg,
                           const uint32_t* __restrict__ empty_t,
                           const float* __restrict__ mem_used,
                           const float* __restrict__ max_mem,
                           const int32_t* __restrict__ n_funcs,
                           const float* __restrict__ f_mem,
                           const float* __restrict__ cap_pct,
                           const int32_t* __restrict__ max_conc,
                           const int32_t* __restrict__ strat,
                           const uint8_t* __restrict__ wmask,
                           const int32_t* __restrict__ warm,
                           uint8_t* __restrict__ valid,
                           float* __restrict__ score,
                           uint64_t* __restrict__ partial,
                           int64_t R, int64_t W, int64_t NW) {
  __shared__ uint64_t warp_keys[kThreads / 32];
  const int64_t w = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const bool in = w < W;  // no early return: every thread joins the reductions
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mem = 0.0f, maxm = 0.0f, loadf = 0.0f;
  int32_t nfn = 0;
  if (in) {
    mem = mem_used[w];
    maxm = max_mem[w];
    nfn = n_funcs[w];
    loadf = __int2float_rn(nfn);
  }
  const int64_t r0 = blockIdx.y * (int64_t)kRows;
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i;
    if (r >= R) break;  // uniform across the block
    uint64_t key = kNoKey;
    if (in) {
      const int64_t c = r * W + w;
      const bool ok = cell_valid(pos + r * NW, neg + r * NW, empty_t, W, NW,
                                 w, mem, maxm, nfn, f_mem[r], cap_pct[r],
                                 max_conc[r], wmask[c] != 0);
      const float s = ok ? cell_score(strat[r], warm[c], loadf) : INFINITY;
      valid[c] = ok ? 1 : 0;
      score[c] = s;
      key = ((uint64_t)order_bits(s) << 32) | (uint64_t)w;
    }
    key = warp_min(key);
    if (lane == 0) warp_keys[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = lane < kThreads / 32 ? warp_keys[lane] : kNoKey;
      key = warp_min(key);
      if (lane == 0) partial[r * gridDim.x + blockIdx.x] = key;
    }
    __syncthreads();  // warp_keys is rewritten by the next row
  }
}

__global__ void bulk_winner(const uint64_t* __restrict__ partial,
                            int32_t* __restrict__ winner, int64_t nblk) {
  const int64_t r = blockIdx.x;
  uint64_t key = kNoKey;
  for (int64_t j = threadIdx.x; j < nblk; j += 32) {
    const uint64_t k = partial[r * nblk + j];
    key = k < key ? k : key;
  }
  key = warp_min(key);
  if (threadIdx.x == 0)
    winner[r] = (uint32_t)(key >> 32) >= kInfKeyHi
                    ? -1
                    : (int32_t)(key & 0xffffffffu);
}

}  // namespace affinity

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers of contiguous tensors; `scratch` holds 2 R NW + NW W uint32 words
// followed (8-byte aligned) by R ceil(W / 256) uint64 partials.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int bulk_decide_launch(
    const int8_t* aff, const float* f_mem, const float* cap_pct,
    const int32_t* max_conc, const int32_t* strat, const int32_t* occ,
    const float* mem_used, const float* max_mem, const int32_t* n_funcs,
    const uint8_t* wmask, const int32_t* warm, uint8_t* valid, float* score,
    int32_t* winner, uint32_t* scratch, int64_t R, int64_t W, int64_t T,
    cudaStream_t stream) {
  using namespace affinity;
  if (R <= 0 || W <= 0) return (int)cudaGetLastError();
  const int64_t NW = (T + 31) / 32;
  const int64_t nblk = (W + kThreads - 1) / kThreads;
  uint32_t* pos = scratch;
  uint32_t* neg = pos + R * NW;
  uint32_t* empty_t = neg + R * NW;
  const int64_t words = 2 * R * NW + NW * W;
  uint64_t* partial = reinterpret_cast<uint64_t*>(scratch + words + (words & 1));
  pack_masks(occ, aff, empty_t, pos, neg, R, W, T, NW, stream);
  const dim3 grid((unsigned)nblk, (unsigned)((R + kRows - 1) / kRows));
  bulk_cells<<<grid, kThreads, 0, stream>>>(
      pos, neg, empty_t, mem_used, max_mem, n_funcs, f_mem, cap_pct, max_conc,
      strat, wmask, warm, valid, score, partial, R, W, NW);
  bulk_winner<<<(unsigned)R, 32, 0, stream>>>(partial, winner, nblk);
  return (int)cudaGetLastError();
}
