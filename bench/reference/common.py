"""Plain PyTorch pieces the reference families share.

Everything computes in float32 with TF32 off, from the weights the
benchmark made (``harness/weights.py``) and the token ids it drew.  The one
other precision is the control's, the step below the configurations'
bfloat16: ``"fp8"`` holds in float8 e4m3 what the program holds in bf16,
the weights and the activations between operations.  Both operands of
every linear layer are rounded (a scale per token row and per output
column, the usual recipe for serving in fp8) before the float32 product,
and so is the residual stream after each layer (a scale per token).
Nothing here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def exact_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    t = t.float()
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out] in float32 (or the control's fp8)."""
    if precision == "float32":
        return x.float() @ w.float()
    if precision == "fp8":
        return to_e4m3(x, -1) @ to_e4m3(w, -2)
    raise ValueError(f"unknown precision {precision!r}")


def hold(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The residual stream as it is held between layers: as it is in
    float32, rounded to e4m3 with a scale per token for the control."""
    return to_e4m3(x, -1) if precision == "fp8" else x


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)
