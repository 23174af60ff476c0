// affinity_valid: the batched Listing-1 valid[F, W] matrix on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/affinity/kernel.py
// (_affinity_kernel, entry affinity_valid_kernel), which tiles F x W in
// 128 x 128 blocks and counts affinity violations as two [BF, T] x [T, BW]
// 0/1 float32 matmuls on the MXU.
//
// What bounds it on this card: bytes, and at the decision path's shapes
// (F = 2, T = 4: 0.5 MB) the launch itself.  The function reads occ [W, T]
// int32 and wmask [F, W] once and writes valid [F, W] once.  Tensor cores do
// not serve: a cell needs no violation count, only whether any tag violates,
// which is ceil(T / 32) pairs of bit operations on packed words (two LOP3s a
// word; affinity_common.cuh), far under the card's integer rate.
//
// What the design does about it: one launch and no scratch (the kernel
// template `cells<false, kWords>` of affinity_common.cuh): occ packed to
// 32-tag words in shared memory by the block that uses them, each thread 4
// workers with 4-byte wmask and valid accesses, each warp's rows streamed
// through a cp.async ring, the ragged F and W edges masked in the kernel;
// nothing is padded to tiles.
#include "affinity_common.cuh"

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers of contiguous tensors.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int affinity_valid_launch(
    const int8_t* aff, const float* f_mem, const float* cap_pct,
    const int32_t* max_conc, const int32_t* occ, const float* mem_used,
    const float* max_mem, const int32_t* n_funcs, const uint8_t* wmask,
    uint8_t* valid, int64_t F, int64_t W, int64_t T, cudaStream_t stream) {
  using namespace affinity;
  if (F <= 0 || W <= 0) return (int)cudaGetLastError();
  CellArgs a{};
  a.aff = aff;
  a.f_mem = f_mem;
  a.cap_pct = cap_pct;
  a.max_conc = max_conc;
  a.occ = occ;
  a.mem_used = mem_used;
  a.max_mem = max_mem;
  a.n_funcs = n_funcs;
  a.wmask = wmask;
  a.valid = valid;
  a.R = F;
  a.W = W;
  a.T = T;
  choose_paths(a);
  return launch_cells<false>(a, stream);
}
