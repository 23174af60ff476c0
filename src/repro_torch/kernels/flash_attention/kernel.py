"""CUDA kernels for flash attention: ``csrc/flash_attention_sm90.cu`` for
bfloat16 inputs (tensor cores: wgmma, TMA) and ``csrc/flash_attention.cu``
for float32 inputs (CUDA cores); :func:`choose_kernel` picks one.

The Hopper counterparts of the reference's Pallas kernel
(``repro/kernels/flash_attention/kernel.py::_flash_kernel``): the same
online-softmax forward over key tiles, with the ragged Sq / Skv edges masked
in the kernel instead of padded to 512-row blocks, and the key tiles that
the causal or window mask leaves empty never visited.  Each source's header
note says what bounds it.

:func:`flash_attention_kernel` takes CUDA tensors only; the public wrapper
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`) routes
CPU tensors to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..build import NVCC_FLAGS, CudaKernel

_P, _N = ctypes.c_void_p, ctypes.c_int64
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

#: float32 inputs: float32 math on the CUDA cores
KERNEL = CudaKernel(
    "flash_attention", "flash_attention/csrc/flash_attention.cu",
    entry="flash_attention_launch",
    # q k v o, B Sq Skv H K hd causal window, stream
    argtypes=[_P] * 4 + [_N] * 8 + [_P],
    flags=NVCC_FLAGS)
#: bfloat16 inputs: bf16 products on the tensor cores, float32 softmax and
#: accumulators
KERNEL_BF16 = CudaKernel(
    "flash_attention_bf16", "flash_attention/csrc/flash_attention_sm90.cu",
    entry="flash_attention_bf16_launch",
    # q k v o, B Sq Skv H K hd causal window, stream
    argtypes=[_P] * 4 + [_N] * 8 + [_P],
    flags=NVCC_FLAGS)


class Tiles(NamedTuple):
    """One bf16 instance's tiling: query rows a CTA (64 a consumer
    warpgroup), keys a tile, stages of the k / v ring, consumer
    warpgroups."""
    rows: int
    keys: int
    stages: int
    consumers: int


#: the bf16 kernel's tiles by head dim, as ``flash_attention_sm90.cu``'s
#: ``Tiles<HD>`` compiles them (:func:`compiled_tiles` reads them back)
TILES = {64: Tiles(128, 128, 3, 2), 128: Tiles(128, 128, 2, 2),
         256: Tiles(128, 64, 2, 2)}


def compiled_tiles(hd: int) -> Tiles:
    """The tiles that ``flash_attention_sm90.cu`` compiled for head dim
    ``hd``, from its ``flash_attention_bf16_tiles`` entry; builds the
    library on first use (on the machine with the card)."""
    out = (ctypes.c_int * 4)()
    fn = KERNEL_BF16.symbol("flash_attention_bf16_tiles", [_N, _P])
    rc = fn(hd, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{KERNEL_BF16.name} has no instance for "
                         f"head_dim {hd}")
    return Tiles(*out)


def choose_kernel(dtype: torch.dtype, hd: int) -> CudaKernel:
    """The kernel for inputs of ``dtype`` and head dim ``hd``: bfloat16 to
    the tensor-core kernel, float32 to the CUDA-core one; any other dtype or
    head dim raises."""
    if dtype not in DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not supported by the kernel "
                         f"(one of {HEAD_DIMS})")
    return KERNEL_BF16 if dtype == torch.bfloat16 else KERNEL


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """What the kernel computes on, wherever the tensors lie: one dtype and
    head dim that :func:`choose_kernel` takes, [B, Sq, H, hd] and
    [B, Skv, K, hd] with K dividing H, and a window of at least 1 that
    leaves every query row a key.  (A row with no key gets the mean of all
    v from the plain version's finite -1e30 mask; the kernel skips the
    tiles such a row would need, so it is refused rather than answered
    differently.)"""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [B, Skv, K, hd] for q {tuple(q.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    choose_kernel(q.dtype, hd)
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    Skv = k.shape[1]
    if window is not None and Sq >= Skv + window:
        # row i sees keys kv > i - window, none of them below Skv
        raise ValueError(f"query rows {Skv + window - 1} to {Sq - 1} see no "
                         f"key (Skv {Skv}, window {window})")
    if max(B, Sq, k.shape[1], H) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's int32 indexing")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """Everything the C entry point takes on trust: one CUDA device,
    contiguous 16-byte aligned tensors, and :func:`check_shapes`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v lie on different devices")
    check_shapes(q, k, v, window)


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """Launch :func:`choose_kernel`'s kernel on the current stream:
    q [B, Sq, H, hd], k / v [B, Skv, K, hd] -> o [B, Sq, H, hd] in q's dtype
    (float32 or bfloat16, accumulated in float32), for hd in 64, 128, 256."""
    check_inputs(q, k, v, window)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kern = choose_kernel(q.dtype, hd)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    rc = kern.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   B, Sq, Skv, H, K, hd, int(bool(causal)),
                   0 if window is None else int(window),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kern.name} launch failed: CUDA error {rc}")
    kern.launches += 1
    return o
