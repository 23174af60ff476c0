"""The plain PyTorch version of the selective-scan kernel: the recurrence
stepped over the sequence in float32, in the order of the JAX package's
oracle (``repro/kernels/mamba_scan/ref.py``).  The CPU path and the
yardstick the kernel is held to on the card.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ;   y_t = h_t . C_t
    (per channel d, state n; h_0 = 0)
"""
from __future__ import annotations

import torch


def selective_scan_ref(dt, x, b, c, a):
    """dt / x [B,S,D], b / c [B,S,N], a [D,N] -> y [B,S,D] float32.  The
    inputs are widened to float32 on entry, as the kernel widens them on
    load."""
    dt, x, b, c, a = (t.float() for t in (dt, x, b, c, a))
    B, S, D = dt.shape
    h = torch.zeros((B, D, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t]  # [B, D]
        abar = torch.exp(dt_t[..., None] * a)  # [B, D, N]
        h = abar * h + (dt_t * x[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    if not ys:
        return torch.zeros((B, S, D), dtype=torch.float32, device=dt.device)
    return torch.stack(ys, dim=1)
