"""The plain PyTorch versions of the mamba block's kernels: the CPU path
and the yardstick each kernel is held to on the card.

* :func:`selective_scan_ref` — the recurrence stepped over the sequence in
  float32, in the order of the JAX package's oracle
  (``repro/kernels/mamba_scan/ref.py``)::

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ;   y_t = h_t . C_t
      (per channel d, state n; h_0 = 0)

* :func:`selective_scan_fused_ref` — the scan kernel's second entry:
  softplus before the recurrence, the D skip, the gate and the cast after;
* :func:`causal_conv_silu_ref` — the conv kernel: conv, bias and SiLU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def selective_scan_fused_ref(dt_proj, dt_b, x, z, b, c, a_log, d_skip):
    """The plain version of the scan kernel's second entry: the mamba
    block from dt's product to the gated output, operation for operation as
    the block's plain path runs it.  dt_proj / x / z [B,S,D] and b / c
    [B,S,N] and dt_b [D] in the model's type, a_log [D,N] and d_skip [D]
    float32 -> [B,S,D] in x's type::

        dt = softplus(float(dt_proj) + float(dt_b))   (threshold 20)
        y = selective_scan_ref(dt, x, b, c, -exp(a_log))
        out = ((y + d_skip float(x)) silu(float(z))) in x's type
    """
    dt = F.softplus(dt_proj.float() + dt_b.float())
    y = selective_scan_ref(dt, x, b, c, -torch.exp(a_log))
    y = y + d_skip * x.float()
    return (y * F.silu(z.float())).to(x.dtype)


def causal_conv_silu_ref(x, w, b):
    """The plain version of the conv kernel: the depthwise causal conv over
    the sequence as the block's plain path computes it (a zero context of
    kw - 1 rows, float32 taps summed in order from a zero accumulator, the
    bias, a cast to x's type), then SiLU in float32 and a cast.  x [B,S,D]
    (any strides), w [D,kw], b [D], one type -> [B,S,D] in x's type."""
    B, S, D = x.shape
    kw = w.shape[-1]
    ctx = torch.zeros((B, kw - 1, D), dtype=x.dtype, device=x.device)
    xp = torch.cat([ctx, x], dim=1)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kw):
        y = y + xp[:, i:i + S, :].float() * w[:, i].float()
    y = (y + b.float()).to(x.dtype)
    return F.silu(y.float()).to(x.dtype)
