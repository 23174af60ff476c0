"""CUDA kernel for the fused bulk decide pass (``csrc/bulk_decide.cu``).

The Hopper counterpart of the reference's Pallas kernel
(``repro/kernels/affinity/bulk_kernel.py::_bulk_decide_kernel``): the
candidate mask, the float32 strategy score (the encoding of :mod:`.bulk_ref`)
and the per-row first-minimum winner in one launch.  The Pallas kernel
carries its argmin across the TPU's sequential worker-tile axis; GPU blocks
run in no order, so the kernel folds each row's ``(score, index)`` keys into
one 64-bit key per row with ``atomicMin`` and its last block turns the keys
into winners — lowest index on a tie, ``-1`` for a row with no valid worker,
independent of block order — and leaves them reset for the next launch.
The keys live in a buffer kept per (device, stream) (:class:`RowKeys`), so
no call allocates scratch and calls on two streams never share keys.

:func:`bulk_decide_kernel` takes CUDA tensors only; the public wrapper
(:func:`repro_torch.kernels.affinity.bulk_ops.bulk_decide`) routes CPU
tensors to the plain version in :mod:`.bulk_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from .kernel import check_inputs, check_tensor

_P, _N = ctypes.c_void_p, ctypes.c_int64

KERNEL = CudaKernel(
    "bulk_decide", "affinity/csrc/bulk_decide.cu",
    entry="bulk_decide_launch",
    # aff f_mem cap conc strat occ mem maxm nfn wmask warm valid score
    # winner keys, R W T, stream
    argtypes=[_P] * 15 + [_N] * 3 + [_P],
    headers=("affinity/csrc/affinity_common.cuh",))


class RowKeys:
    """The kernel's ticket and per-row keys: one int64 buffer per (device,
    stream), ``[ticket = 0, key = -1 (all ones) per row]``.  It is made on
    the stream's first call, on that stream, and grown (to a power of two,
    at least 64 words) when a call has more rows; every launch leaves it as
    it found it, so it is never written from the host again."""

    def __init__(self):
        self.buffers = {}

    def get(self, R: int, device: torch.device, stream: int) -> torch.Tensor:
        key = (device, stream)
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < 1 + R:
            buf = torch.full((max(64, 1 << R.bit_length()),), -1,
                             dtype=torch.int64, device=device)
            buf[0] = 0
            self.buffers[key] = buf
        return buf


ROW_KEYS = RowKeys()


def bulk_decide_kernel(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                       cap_pct, max_conc, strat, warm):
    """Launch the fused pass on the current stream: ``(valid[R, W] bool,
    score[R, W] f32, winner[R] i32)``.

    Shapes and dtypes as :func:`.kernel.affinity_valid_kernel`, plus
    strat[R] i32 and warm[R,W] i32, all contiguous on one CUDA device."""
    check_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                 cap_pct, max_conc)
    W, T = occ.shape
    R = aff.shape[0]
    check_tensor("strat", strat, torch.int32, (R,))
    check_tensor("warm", warm, torch.int32, (R, W))
    if strat.device != occ.device or warm.device != occ.device:
        raise ValueError("strat and warm must lie on the inputs' device")
    dev = occ.device
    valid = torch.empty((R, W), dtype=torch.bool, device=dev)
    score = torch.empty((R, W), dtype=torch.float32, device=dev)
    if R == 0 or W == 0:
        return valid, score, torch.full((R,), -1, dtype=torch.int32,
                                        device=dev)
    winner = torch.empty((R,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys = ROW_KEYS.get(R, dev, stream)
    rc = KERNEL.fn()(
        aff.data_ptr(), f_mem.data_ptr(), cap_pct.data_ptr(),
        max_conc.data_ptr(), strat.data_ptr(), occ.data_ptr(),
        mem_used.data_ptr(), max_mem.data_ptr(), n_funcs.data_ptr(),
        wmask.data_ptr(), warm.data_ptr(), valid.data_ptr(),
        score.data_ptr(), winner.data_ptr(), keys.data_ptr(), R, W, T,
        stream)
    if rc != 0:
        raise RuntimeError(f"bulk_decide launch failed: CUDA error {rc}")
    KERNEL.launches += 1
    return valid, score, winner
