"""Public entries of the mamba block's kernels: the route by device.  A
CUDA tensor launches the hand-written kernel (:mod:`.kernel`); a CPU tensor,
or ``backend="ref"``, runs the plain PyTorch version (:mod:`.ref`).
Nothing falls back: a CUDA launch that fails raises.  The kernels have no
backward, so an input that requires grad is refused on every route
(:func:`..refuse_autograd`).

* :func:`selective_scan` — the scan with the reference's signature less its
  TPU tiling knobs (``chunk``, ``bd``), float32 y;
* :func:`selective_scan_fused` — the scan's second entry: softplus, the
  scan, the D skip, the gate and the cast, the prefill's SSM block from
  dt's product to the gated output;
* :func:`causal_conv_silu` — the block's conv, bias and SiLU.

The two block entries take plain tensors only: a DTensor (the sharded
step) is refused (:func:`..refuse_dtensors`)."""
from __future__ import annotations

from .. import refuse_autograd, refuse_dtensors
from .kernel import (causal_conv_silu_kernel, check_conv_shapes,
                     check_fused_shapes, check_shapes,
                     selective_scan_fused_kernel, selective_scan_kernel)
from .ref import causal_conv_silu_ref, selective_scan_fused_ref, \
    selective_scan_ref


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}: 'auto' or 'ref'")


def selective_scan(dt, x, b, c, a, *, backend="auto"):
    """dt / x [B,S,D], b / c [B,S,N], a [D,N] -> y [B,S,D] float32.

    dt, x, b and c may each be float32 or bfloat16; a is float32; N is one
    of 1, 2, 4, 8, 16, 32.  Anything else raises, on every route."""
    _check_backend(backend)
    refuse_autograd("selective_scan", dt, x, b, c, a)
    if backend == "auto" and dt.device.type == "cuda":
        # the kernel's wrapper checks the shapes with the rest
        return selective_scan_kernel(dt.contiguous(), x.contiguous(),
                                     b.contiguous(), c.contiguous(),
                                     a.contiguous())
    check_shapes(dt, x, b, c, a)
    if backend == "ref" or dt.device.type == "cpu":
        return selective_scan_ref(dt, x, b, c, a)
    raise ValueError(f"unsupported device {dt.device}: 'cuda' or 'cpu'")


def selective_scan_fused(dt_proj, dt_b, x, z, b, c, a_log, d_skip, *,
                         backend="auto"):
    """dt_proj / x / z [B,S,D], b / c [B,S,N], dt_b [D] (the model's type,
    float32 or bfloat16), a_log [D,N] and d_skip [D] (float32) -> [B,S,D]
    in x's type: ``(scan(softplus(dt_proj + dt_b), x, b, c, -exp(a_log)) +
    d_skip x) silu(z)``.  z, b and c may be strided views (the block's
    in_proj and x_proj outputs).  Anything else raises, on every route."""
    _check_backend(backend)
    ins = (dt_proj, dt_b, x, z, b, c, a_log, d_skip)
    refuse_autograd("selective_scan_fused", *ins)
    refuse_dtensors("selective_scan_fused", *ins)
    if backend == "auto" and x.device.type == "cuda":
        return selective_scan_fused_kernel(*ins)
    check_fused_shapes(*ins)
    if backend == "ref" or x.device.type == "cpu":
        return selective_scan_fused_ref(*ins)
    raise ValueError(f"unsupported device {x.device}: 'cuda' or 'cpu'")


def causal_conv_silu(x, w, b, *, backend="auto"):
    """x [B,S,D] (a strided view too: the first half of in_proj's output),
    w [D,kw], b [D], one type (float32 or bfloat16), kw 4 -> silu(the
    causal depthwise conv of x + b) [B,S,D] in x's type, from zeros before
    the sequence.  Anything else raises, on every route."""
    _check_backend(backend)
    refuse_autograd("causal_conv_silu", x, w, b)
    refuse_dtensors("causal_conv_silu", x, w, b)
    if backend == "auto" and x.device.type == "cuda":
        return causal_conv_silu_kernel(x, w, b)
    check_conv_shapes(x, w, b)
    if backend == "ref" or x.device.type == "cpu":
        return causal_conv_silu_ref(x, w, b)
    raise ValueError(f"unsupported device {x.device}: 'cuda' or 'cpu'")
