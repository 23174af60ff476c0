"""CUDA kernels of the mamba-1 block: the selective scan
(``csrc/selective_scan.cu``, two entries) and the causal conv
(``csrc/causal_conv.cu``).

The Hopper counterpart of the reference's Pallas kernel
(``repro/kernels/mamba_scan/kernel.py::_scan_kernel``): the same float32
recurrence with the ``[channel tile, N]`` state kept on chip across the whole
sequence, but with the sequence walked by a loop inside each block instead
of a sequential grid axis, several states per thread, and the ragged S and
D edges masked in the kernel instead of padded.  The TPU tiling knobs
(``chunk``, ``bd``) have no counterpart; the kernel's own tiling is fixed
and mirrored below (:data:`CHUNK`, :data:`CHANNEL_TILE`, :data:`GROUP`,
:func:`states_per_thread`).  The source's header note says what bounds it.

The scan's second entry (:data:`FUSED_KERNEL`, the same source) and the
conv kernel (:data:`CONV_KERNEL`) replace no TPU kernel: they fold the
block's float32 elementwise chain, which the JAX package leaves to XLA,
into the kernels on either side of the scan's inputs (the sources' notes).

The ``*_kernel`` functions take CUDA tensors only; the public wrappers
(:mod:`repro_torch.kernels.mamba_scan.ops`) route CPU tensors to the plain
versions in :mod:`.ref`.
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
#: the scan's second entry: the same source built with SCAN_FUSED_ENTRY
#: defined, a library of its own that holds only that entry's instances
FUSED_KERNEL = CudaKernel(
    "selective_scan_fused", "mamba_scan/csrc/selective_scan.cu",
    entry="selective_scan_fused_launch",
    # dt_proj dt_b x z b c a_log d_skip out, B S D N z_stride bc_stride bf16,
    # stream
    argtypes=[_P] * 9 + [_N] * 7 + [_P],
    flags=NVCC_FLAGS + ("-DSCAN_FUSED_ENTRY",))
#: the conv's taps are summed without FMA contraction (EXACT_FLAGS, the
#: default), bit for bit as the plain version sums them
CONV_KERNEL = CudaKernel(
    "causal_conv_silu", "mamba_scan/csrc/causal_conv.cu",
    entry="causal_conv_silu_launch",
    # x w b y, B S D kw x_stride bf16, stream
    argtypes=[_P] * 4 + [_N] * 6 + [_P])
#: the conv width the kernel is built for: mamba-1's, every config's
CONV_WIDTH = 4


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_one_card(names, *tensors) -> None:
    for name, t in zip(names, tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{', '.join(names)} lie on different devices")


def rows_in_place(t: torch.Tensor) -> bool:
    """Whether ``t`` [B, S, W] can be read in place as rows of
    ``t.stride(1)`` elements, row b S + s at element (b S + s) stride(1):
    a slice along the last dim of a contiguous [B, S, >= W] tensor."""
    B, S, W = t.shape
    return (t.stride(2) == 1 and t.stride(1) >= W
            and (B == 1 or t.stride(0) == S * t.stride(1)))


def bc_in_place(b: torch.Tensor, c: torch.Tensor) -> bool:
    """Whether the fused entry reads b and c [B, S, N] in place: rows of
    one stride (:func:`rows_in_place`) whose rows and starts keep cp.async's
    16-byte pieces (x_proj's output at falcon-mamba's widths: rows of 576
    bytes, b and c at 512 and 544)."""
    es = b.element_size()
    return (rows_in_place(b) and rows_in_place(c) and b.stride() == c.stride()
            and b.shape[-1] * es % 16 == 0 and b.stride(1) * es % 16 == 0
            and b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0)


def check_fused_shapes(dt_proj, dt_b, x, z, b, c, a_log, d_skip) -> None:
    """What the second entry computes on, wherever the tensors lie:
    dt_proj / x / z [B, S, D], b / c [B, S, N] and dt_b [D], all float32
    or all bfloat16 (the model's type); a_log [D, N] and d_skip [D]
    float32; N one of 1, 2, 4, 8, 16, 32."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt_proj", dt_proj), ("z", z), ("b", b), ("c", c),
                    ("dt_b", dt_b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
    for name, t in (("a_log", a_log), ("d_skip", d_skip)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    B, S, D = x.shape
    if a_log.dim() != 2 or a_log.shape[0] != D:
        raise ValueError(f"a_log {tuple(a_log.shape)} must be [D, N] for "
                         f"D = {D}")
    N = a_log.shape[1]
    for name, t, shape in (("dt_proj", dt_proj, (B, S, D)),
                           ("z", z, (B, S, D)), ("b", b, (B, S, N)),
                           ("c", c, (B, S, N)), ("dt_b", dt_b, (D,)),
                           ("d_skip", d_skip, (D,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")
    if N not in STATE_DIMS:
        raise ValueError(f"state size N = {N} is not supported by the kernel "
                         f"(one of {STATE_DIMS})")
    if B > 65535 or max(S, D) >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(B, S, D)} exceeds the kernel's grid "
                         "or int32 indexing")


def selective_scan_fused_kernel(dt_proj, dt_b, x, z, b, c, a_log,
                                d_skip) -> torch.Tensor:
    """Launch the second entry on the current stream (the arguments as
    :func:`check_fused_shapes` has them) -> [B, S, D] in x's type.  z is
    read in place where :func:`rows_in_place`, b and c where
    :func:`bc_in_place`; else each is copied contiguous first."""
    names = ("dt_proj", "dt_b", "x", "z", "b", "c", "a_log", "d_skip")
    _on_one_card(names, dt_proj, dt_b, x, z, b, c, a_log, d_skip)
    check_fused_shapes(dt_proj, dt_b, x, z, b, c, a_log, d_skip)
    B, S, D = x.shape
    N = a_log.shape[1]
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    dt_proj, x, dt_b, a_log, d_skip = (t.contiguous() for t in (
        dt_proj, x, dt_b, a_log, d_skip))
    if not rows_in_place(z):
        z = z.contiguous()
    if not bc_in_place(b, c):
        b, c = b.contiguous(), c.contiguous()
    rc = FUSED_KERNEL.fn()(
        dt_proj.data_ptr(), dt_b.data_ptr(), x.data_ptr(), z.data_ptr(),
        b.data_ptr(), c.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        out.data_ptr(), B, S, D, N, z.stride(1), b.stride(1),
        int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"selective_scan_fused launch failed: CUDA error "
                           f"{rc}")
    FUSED_KERNEL.launches += 1
    return out


def check_conv_shapes(x, w, b) -> None:
    """What the conv kernel computes on, wherever the tensors lie: x
    [B, S, D], w [D, kw] and b [D], one type, float32 or bfloat16, kw
    :data:`CONV_WIDTH`."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    B, S, D = x.shape
    if w.dim() != 2 or w.shape[0] != D or tuple(b.shape) != (D,):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} must be "
                         f"[D, kw] and [D] for D = {D}")
    if w.shape[1] != CONV_WIDTH:
        raise ValueError(f"conv width kw = {w.shape[1]} is not supported by "
                         f"the kernel ({CONV_WIDTH})")
    if B > 65535 or max(S, D) >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(B, S, D)} exceeds the kernel's grid "
                         "or int32 indexing")


def causal_conv_silu_kernel(x, w, b) -> torch.Tensor:
    """Launch the conv kernel on the current stream: x [B, S, D] (read in
    place where :func:`rows_in_place`, else copied contiguous first), w
    [D, kw], b [D] -> silu(conv(x) + b) [B, S, D] in x's type."""
    _on_one_card(("x", "w", "b"), x, w, b)
    check_conv_shapes(x, w, b)
    B, S, D = x.shape
    y = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if not rows_in_place(x):
        x = x.contiguous()
    w, b = w.contiguous(), b.contiguous()
    rc = CONV_KERNEL.fn()(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                          y.data_ptr(), B, S, D, w.shape[1], x.stride(1),
                          int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"causal_conv_silu launch failed: CUDA error {rc}")
    CONV_KERNEL.launches += 1
    return y
