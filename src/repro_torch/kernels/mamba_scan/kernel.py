"""CUDA kernel for the mamba-1 selective scan (``csrc/selective_scan.cu``).

The Hopper counterpart of the reference's Pallas kernel
(``repro/kernels/mamba_scan/kernel.py::_scan_kernel``): the same float32
recurrence with the ``[channel tile, N]`` state kept on chip across the whole
sequence, but with the sequence walked by a loop inside each block instead
of a sequential grid axis, several states per thread, and the ragged S and
D edges masked in the kernel instead of padded.  The TPU tiling knobs
(``chunk``, ``bd``) have no counterpart; the kernel's own tiling is fixed
and mirrored below (:data:`CHUNK`, :data:`CHANNEL_TILE`, :data:`GROUP`,
:func:`states_per_thread`).  The source's header note says what bounds it.

:func:`selective_scan_kernel` takes CUDA tensors only; the public wrapper
(:func:`repro_torch.kernels.mamba_scan.ops.selective_scan`) routes CPU
tensors to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import NVCC_FLAGS, CudaKernel

_P, _N = ctypes.c_void_p, ctypes.c_int64
STATE_DIMS = (1, 2, 4, 8, 16, 32)
DTYPES = (torch.float32, torch.bfloat16)

# the kernel's tiling, as ``csrc/selective_scan.cu`` fixes it (``scan::kT``,
# ``kCh``, ``kU``, ``kMaxStatesPerThread``): steps per staged chunk,
# channels per block, steps per unrolled group (one reduce-scatter), and
# the most states of one channel a thread holds
CHUNK = 64
CHANNEL_TILE = 32
GROUP = 8
MAX_STATES_PER_THREAD = 4


def states_per_thread(n: int) -> int:
    """K, the states of one channel a thread holds at state size ``n``
    (``Shape<N>::K``); ``n // K`` lanes share a channel."""
    return min(n, MAX_STATES_PER_THREAD)


KERNEL = CudaKernel(
    "selective_scan", "mamba_scan/csrc/selective_scan.cu",
    entry="selective_scan_launch",
    # dt x b c a y, B S D N, dt/x/b/c bf16 flags, stream
    argtypes=[_P] * 6 + [_N] * 8 + [_P],
    flags=NVCC_FLAGS)


def check_shapes(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor) -> None:
    """What the kernel computes on, wherever the tensors lie: dt / x
    [B, S, D] and b / c [B, S, N] each float32 or bfloat16, a [D, N]
    float32, and N one of 1, 2, 4, 8, 16, 32."""
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(t.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"a must be [D, N], got {tuple(a.shape)}")
    B, S, D = dt.shape
    N = a.shape[1]
    if x.shape != dt.shape:
        raise ValueError(f"x {tuple(x.shape)} must match dt {tuple(dt.shape)}")
    if b.shape != (B, S, N) or c.shape != (B, S, N):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must be "
                         f"[B, S, N] = {(B, S, N)}")
    if a.shape[0] != D:
        raise ValueError(f"a {tuple(a.shape)} must be [D, N] for D = {D}")
    if N not in STATE_DIMS:
        raise ValueError(f"state size N = {N} is not supported by the kernel "
                         f"(one of {STATE_DIMS})")
    if B > 65535 or max(S, D) >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(B, S, D)} exceeds the kernel's grid "
                         "or int32 indexing")


def check_inputs(dt, x, b, c, a) -> None:
    """Everything the C entry point takes on trust: one CUDA device,
    contiguous tensors, and :func:`check_shapes`."""
    ts = (("dt", dt), ("x", x), ("b", b), ("c", c), ("a", a))
    for name, t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t in ts}) != 1:
        raise ValueError("dt, x, b, c, a lie on different devices")
    check_shapes(dt, x, b, c, a)


def selective_scan_kernel(dt, x, b, c, a) -> torch.Tensor:
    """Launch the kernel on the current stream: dt / x [B, S, D], b / c
    [B, S, N] (float32 or bfloat16 each), a [D, N] float32 -> y [B, S, D]
    float32."""
    check_inputs(dt, x, b, c, a)
    B, S, D = dt.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=dt.device)
    if y.numel() == 0:
        return y
    bf16 = [int(t.dtype == torch.bfloat16) for t in (dt, x, b, c)]
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    rc = KERNEL.fn()(dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                     a.data_ptr(), y.data_ptr(), B, S, D, a.shape[1], *bf16,
                     stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {rc}")
    KERNEL.launches += 1
    return y
