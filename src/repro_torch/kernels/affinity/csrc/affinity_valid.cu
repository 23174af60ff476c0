// affinity_valid: the batched Listing-1 valid[F, W] matrix on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/affinity/kernel.py
// (_affinity_kernel, entry affinity_valid_kernel), which tiles F x W in
// 128 x 128 blocks and counts affinity violations as two [BF, T] x [T, BW]
// 0/1 float32 matmuls on the MXU.
//
// What bounds it on this card: bytes.  The function reads occ [W, T] int32
// once and writes valid [F, W] once; the violation count is 2 F W T 0/1
// multiply-adds, far under the card's integer rate at every shape the
// scheduler produces (F is a tag's block count per decision, T a few tags).
//
// What the design does about it:
//   * occ is read exactly once, by a warp-per-word packer (coalesced, one
//     __ballot_sync per 32 tags), into a 32x smaller bitmask; every row then
//     re-reads only the packed words, from L1/L2;
//   * a violation count is ceil(T / 32) popcounts instead of T multiply-adds;
//   * one thread owns one worker and walks kRows rows, so the per-worker
//     vectors are read once per block and every wmask read and valid write
//     is coalesced across the warp;
//   * the ragged edges of F and W are masked in the kernel; nothing is padded
//     to tiles.
#include "affinity_common.cuh"

namespace affinity {

__global__ void valid_cells(const uint32_t* __restrict__ pos,
                            const uint32_t* __restrict__ neg,
                            const uint32_t* __restrict__ empty_t,
                            const float* __restrict__ mem_used,
                            const float* __restrict__ max_mem,
                            const int32_t* __restrict__ n_funcs,
                            const float* __restrict__ f_mem,
                            const float* __restrict__ cap_pct,
                            const int32_t* __restrict__ max_conc,
                            const uint8_t* __restrict__ wmask,
                            uint8_t* __restrict__ valid,
                            int64_t F, int64_t W, int64_t NW) {
  const int64_t w = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (w >= W) return;
  const float mem = mem_used[w], maxm = max_mem[w];
  const int32_t nfn = n_funcs[w];
  const int64_t r0 = blockIdx.y * (int64_t)kRows;
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i;
    if (r >= F) break;
    const bool ok = cell_valid(pos + r * NW, neg + r * NW, empty_t, W, NW, w,
                               mem, maxm, nfn, f_mem[r], cap_pct[r],
                               max_conc[r], wmask[r * W + w] != 0);
    valid[r * W + w] = ok ? 1 : 0;
  }
}

}  // namespace affinity

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers of contiguous tensors; `scratch` holds 2 F NW + NW W uint32
// words.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int affinity_valid_launch(
    const int8_t* aff, const float* f_mem, const float* cap_pct,
    const int32_t* max_conc, const int32_t* occ, const float* mem_used,
    const float* max_mem, const int32_t* n_funcs, const uint8_t* wmask,
    uint8_t* valid, uint32_t* scratch, int64_t F, int64_t W, int64_t T,
    cudaStream_t stream) {
  using namespace affinity;
  if (F <= 0 || W <= 0) return (int)cudaGetLastError();
  const int64_t NW = (T + 31) / 32;
  uint32_t* pos = scratch;
  uint32_t* neg = pos + F * NW;
  uint32_t* empty_t = neg + F * NW;
  pack_masks(occ, aff, empty_t, pos, neg, F, W, T, NW, stream);
  const dim3 grid((unsigned)((W + kThreads - 1) / kThreads),
                  (unsigned)((F + kRows - 1) / kRows));
  valid_cells<<<grid, kThreads, 0, stream>>>(pos, neg, empty_t, mem_used,
                                             max_mem, n_funcs, f_mem, cap_pct,
                                             max_conc, wmask, valid, F, W, NW);
  return (int)cudaGetLastError();
}
