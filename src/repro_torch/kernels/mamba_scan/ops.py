"""Public selective-scan entry: the route by device, with the reference's
signature less its TPU tiling knobs (``chunk``, ``bd``).  A CUDA tensor
launches the hand-written kernel (:mod:`.kernel`); a CPU tensor, or
``backend="ref"``, runs the plain PyTorch version (:mod:`.ref`).  Nothing
falls back: a CUDA launch that fails raises.  The kernel has no backward,
so an input that requires grad is refused on every route
(:func:`..refuse_autograd`)."""
from __future__ import annotations

from .. import refuse_autograd
from .kernel import check_shapes, selective_scan_kernel
from .ref import selective_scan_ref


def selective_scan(dt, x, b, c, a, *, backend="auto"):
    """dt / x [B,S,D], b / c [B,S,N], a [D,N] -> y [B,S,D] float32.

    dt, x, b and c may each be float32 or bfloat16; a is float32; N is one
    of 1, 2, 4, 8, 16, 32.  Anything else raises, on every route."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}: 'auto' or 'ref'")
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
