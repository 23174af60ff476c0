// bulk_decide: the fused wave pass on Hopper — candidate mask, float32
// strategy score and first-minimum winner per row, for R pending block rows
// over W workers, in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/affinity/bulk_kernel.py
// (_bulk_decide_kernel, entry bulk_decide_kernel).  That kernel gets its
// argmin from the TPU walking worker tiles one after another: a [BF, 1]
// accumulator carries (min, idx) across the sequential grid axis and a strict
// `<` keeps the earlier tile on a tie.  GPU blocks run in no order, so here
// each warp folds its row's 64-bit keys (order-preserving float bits << 32 |
// worker index) into one per-row key in device memory with a 64-bit
// red.min (an atomicMin nobody waits for).  The minimum key is the minimum
// score at its lowest worker index, np.argmin's first-minimum rule, and a
// minimum does not depend on the order of the reductions, so the winner is
// the same in every run.  The last block to finish (every thread's
// __threadfence, then an atomic ticket) turns each key into the row's winner
// (-1 where the minimum is +inf: no valid worker) and resets the keys and
// the ticket with atomicExch, so the next launch on the stream finds them
// ready and no memset is needed.  The wrapper keeps one
// key buffer per stream (bulk_kernel.py), so launches on two streams never
// share one.
//
// What bounds it on this card: bytes.  Each call reads occ [W, T] i32,
// wmask [R, W] and warm [R, W] i32 and writes valid [R, W] and score
// [R, W] f32.  Tensor cores do not serve: a cell's affinity test is
// ceil(T / 32) pairs of bit operations on packed words, no multiply-add (the
// note in affinity_common.cuh), under the integer rate at every shape.  The
// design (the kernel template `cells<true, kWords>` of affinity_common.cuh):
// occ read once, packed in shared memory by the block of its worker tile;
// each block covers up to 512 rows, one warp a row at a time, so the tile's
// words are reused from registers by every row; each warp's rows streamed
// through a ring of shared-memory slots by cp.async, several rows in flight
// and no register holding them; 4 workers a thread, so wmask moves in
// 4-byte and warm and score in 16-byte accesses; no second kernel and no
// scratch allocated per call.
#include "affinity_common.cuh"

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers of contiguous tensors; `keys` holds 1 + R unsigned 64-bit words,
// the ticket (0) and one key per row (all ones) as the previous launch on
// this stream left them, and as this launch leaves them.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bulk_decide_launch(
    const int8_t* aff, const float* f_mem, const float* cap_pct,
    const int32_t* max_conc, const int32_t* strat, const int32_t* occ,
    const float* mem_used, const float* max_mem, const int32_t* n_funcs,
    const uint8_t* wmask, const int32_t* warm, uint8_t* valid, float* score,
    int32_t* winner, unsigned long long* keys, int64_t R, int64_t W,
    int64_t T, cudaStream_t stream) {
  using namespace affinity;
  if (R <= 0 || W <= 0) return (int)cudaGetLastError();
  CellArgs a{};
  a.aff = aff;
  a.f_mem = f_mem;
  a.cap_pct = cap_pct;
  a.max_conc = max_conc;
  a.strat = strat;
  a.occ = occ;
  a.mem_used = mem_used;
  a.max_mem = max_mem;
  a.n_funcs = n_funcs;
  a.wmask = wmask;
  a.warm = warm;
  a.valid = valid;
  a.score = score;
  a.winner = winner;
  a.keys = keys;
  a.R = R;
  a.W = W;
  a.T = T;
  choose_paths(a);
  return launch_cells<true>(a, stream);
}
