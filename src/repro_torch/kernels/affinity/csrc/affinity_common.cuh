// Shared device code of the two affinity kernels (affinity_valid.cu and
// bulk_decide.cu): bit-packing of the tag masks and the Listing-1 validity
// of one (row, worker) cell.
//
// The TPU kernels count affinity violations as two 0/1 float32 matmuls over
// the tag axis.  Here the masks are packed 32 tags to a 32-bit word once per
// launch, so a cell's violation count is NW = ceil(T / 32) popcounts:
//
//   empty_t[k, w]  bit b set iff occ[w, 32k + b] == 0         (worker side)
//   pos[r, k]      bit b set iff aff[r, 32k + b] == +1        (row side)
//   neg[r, k]      bit b set iff aff[r, 32k + b] == -1
//   violations     = sum_k popc(pos & empty) + popc(neg & ~empty)
//
// Bits past T are 0 in pos and neg, so they never count.  The count is an
// exact integer, like the TPU's matmul of 0/1 values.  empty_t is stored
// word-major ([NW, W]) so neighbouring threads, which own neighbouring
// workers, read neighbouring words.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace affinity {

constexpr int kThreads = 256;  // workers per block in the cell kernels
constexpr int kRows = 8;       // rows each block walks (grid.y = ceil(R / kRows))

// occ[W, T] int32 -> empty_t[NW, W].  One warp per (worker, word): lane b
// reads occ[w, 32k + b] (one coalesced 128-byte row segment) and
// __ballot_sync packs the 32 tests into the word.  The warp index is the
// same for all 32 lanes, so a warp exits or ballots as a whole.
__global__ void pack_empty(const int32_t* __restrict__ occ,
                           uint32_t* __restrict__ empty_t,
                           int64_t W, int64_t T, int64_t NW) {
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= W * NW) return;
  const int64_t w = warp / NW, k = warp % NW;
  const int64_t t = k * 32 + lane;
  const bool empty = t < T && occ[w * T + t] == 0;
  const uint32_t word = __ballot_sync(0xffffffffu, empty);
  if (lane == 0) empty_t[k * W + w] = word;
}

// aff[R, T] int8 -> pos[R, NW], neg[R, NW]; same warp-per-word layout.
__global__ void pack_aff(const int8_t* __restrict__ aff,
                         uint32_t* __restrict__ pos,
                         uint32_t* __restrict__ neg,
                         int64_t R, int64_t T, int64_t NW) {
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= R * NW) return;
  const int64_t r = warp / NW, k = warp % NW;
  const int64_t t = k * 32 + lane;
  const int8_t a = t < T ? aff[r * T + t] : 0;
  const uint32_t p = __ballot_sync(0xffffffffu, a == 1);
  const uint32_t n = __ballot_sync(0xffffffffu, a == -1);
  if (lane == 0) {
    pos[r * NW + k] = p;
    neg[r * NW + k] = n;
  }
}

// Launches both packers on `stream`; a zero-sized grid is not launched.
inline void pack_masks(const int32_t* occ, const int8_t* aff,
                       uint32_t* empty_t, uint32_t* pos, uint32_t* neg,
                       int64_t R, int64_t W, int64_t T, int64_t NW,
                       cudaStream_t stream) {
  const int64_t occ_warps = W * NW, aff_warps = R * NW;
  const int per_block = kThreads / 32;
  if (occ_warps > 0)
    pack_empty<<<(unsigned)((occ_warps + per_block - 1) / per_block),
                 kThreads, 0, stream>>>(occ, empty_t, W, T, NW);
  if (aff_warps > 0)
    pack_aff<<<(unsigned)((aff_warps + per_block - 1) / per_block), kThreads,
               0, stream>>>(aff, pos, neg, R, T, NW);
}

// Listing-1 validity of one cell, term by term as the reference computes it
// (ref.py / the Pallas body): the float terms are single float32 operations
// in the reference's order, rounded to nearest (the __f*_rn intrinsics, and
// the build passes --fmad=false), so no term can move off float32.
__device__ __forceinline__ bool cell_valid(
    const uint32_t* __restrict__ pos_r, const uint32_t* __restrict__ neg_r,
    const uint32_t* __restrict__ empty_t, int64_t W, int64_t NW, int64_t w,
    float mem_used, float max_mem, int32_t n_funcs, float f_mem,
    float cap_pct, int32_t max_conc, bool wmask) {
  uint32_t violations = 0;
  for (int64_t k = 0; k < NW; ++k) {
    const uint32_t e = empty_t[k * W + w];
    violations += __popc(pos_r[k] & e) + __popc(neg_r[k] & ~e);
  }
  const bool ok_aff = violations == 0;
  const bool ok_fit = __fadd_rn(mem_used, f_mem) <= max_mem;
  const bool ok_cap = mem_used < __fmul_rn(__fmul_rn(cap_pct, 0.01f), max_mem);
  const bool ok_conc = n_funcs < max_conc;
  return ok_aff && ok_fit && ok_cap && ok_conc && wmask;
}

}  // namespace affinity
