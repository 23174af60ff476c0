"""CUDA kernel for the batched ``valid()`` matrix (``csrc/affinity_valid.cu``).

The Hopper counterpart of the reference's Pallas kernel
(``repro/kernels/affinity/kernel.py::_affinity_kernel``): the same
``valid[F, W]`` for F pending block rows over W workers in one launch, with
the affinity test made on 32-tag bitmask words instead of 0/1 float32
matmuls, and the ragged F/W edges masked in the kernel instead of padded to
128-wide tiles.  The source's header note says what bounds it.

:func:`affinity_valid_kernel` takes CUDA tensors only; the public wrapper
(:func:`repro_torch.kernels.affinity.ops.affinity_valid`) routes CPU
tensors to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel

_P, _N = ctypes.c_void_p, ctypes.c_int64
# rows a block covers (kBlockRows in csrc/affinity_common.cuh) and the most
# rows the launch grid covers (65535 blocks on grid.y)
BLOCK_ROWS = 512
MAX_ROWS = 65535 * BLOCK_ROWS

KERNEL = CudaKernel(
    "affinity_valid", "affinity/csrc/affinity_valid.cu",
    entry="affinity_valid_launch",
    # aff f_mem cap conc occ mem maxm nfn wmask valid, F W T, stream
    argtypes=[_P] * 10 + [_N] * 3 + [_P],
    headers=("affinity/csrc/affinity_common.cuh",))


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape) -> None:
    """Refuse what the C entry point cannot take: a host tensor, another
    dtype or shape, a strided view."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct,
                 max_conc) -> None:
    """Device, dtype, shape and contiguity checks shared with the bulk
    kernel: everything the C entry point takes on trust."""
    W, T = occ.shape
    F = aff.shape[0]
    for name, t, dtype, shape in (
            ("occ", occ, torch.int32, (W, T)),
            ("aff", aff, torch.int8, (F, T)),
            ("wmask", wmask, torch.bool, (F, W)),
            ("mem_used", mem_used, torch.float32, (W,)),
            ("max_mem", max_mem, torch.float32, (W,)),
            ("n_funcs", n_funcs, torch.int32, (W,)),
            ("f_mem", f_mem, torch.float32, (F,)),
            ("cap_pct", cap_pct, torch.float32, (F,)),
            ("max_conc", max_conc, torch.int32, (F,))):
        check_tensor(name, t, dtype, shape)
    if F > MAX_ROWS:
        raise ValueError(f"{F} rows exceed the launch grid ({MAX_ROWS})")
    devices = {t.device for t in (occ, aff, wmask, mem_used, max_mem,
                                  n_funcs, f_mem, cap_pct, max_conc)}
    if len(devices) != 1:
        raise ValueError(f"inputs span several devices: {devices}")


def affinity_valid_kernel(occ, aff, wmask, mem_used, max_mem, n_funcs,
                          f_mem, cap_pct, max_conc) -> torch.Tensor:
    """Launch the kernel on the current stream: ``valid[F, W]`` (bool).

    Shapes and dtypes: occ[W,T] i32, aff[F,T] i8, wmask[F,W] bool,
    mem_used/max_mem[W] f32, n_funcs[W] i32, f_mem/cap_pct[F] f32,
    max_conc[F] i32, all contiguous on one CUDA device."""
    check_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                 cap_pct, max_conc)
    W, T = occ.shape
    F = aff.shape[0]
    valid = torch.empty((F, W), dtype=torch.bool, device=occ.device)
    if F == 0 or W == 0:
        return valid
    stream = torch.cuda.current_stream(occ.device).cuda_stream
    rc = KERNEL.fn()(
        aff.data_ptr(), f_mem.data_ptr(), cap_pct.data_ptr(),
        max_conc.data_ptr(), occ.data_ptr(), mem_used.data_ptr(),
        max_mem.data_ptr(), n_funcs.data_ptr(), wmask.data_ptr(),
        valid.data_ptr(), F, W, T, stream)
    if rc != 0:
        raise RuntimeError(f"affinity_valid launch failed: CUDA error {rc}")
    KERNEL.launches += 1
    return valid
