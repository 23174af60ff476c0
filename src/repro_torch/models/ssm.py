"""Mamba-1 selective state-space block (the falcon-mamba substrate).

Prefill runs the selective scan through
:func:`repro_torch.kernels.mamba_scan.selective_scan`: the hand-written
kernel on the card, its plain version on the CPU.  The reference has a
chunked and an unchunked associative scan in JAX; both compute the same
recurrence, so the port has one path.  The D skip, the ``silu(z)`` gate,
the cast to the model's dtype and ``out_proj`` stay outside the kernel, as
in the reference.  Decode steps the recurrence once in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMSpec
from repro_torch.kernels import mamba_scan as ms

from .layers import const_param, normal_param


class Mamba(nn.Module):
    """The reference's leaves: ``in_proj`` [D, 2 di], the depthwise
    ``conv_w`` [di, kw] and ``conv_b``, ``x_proj`` [di, dt_rank + 2N],
    ``dt_w`` [dt_rank, di] and ``dt_b``, ``a_log`` [di, N] (S4D-real, float32),
    ``d_skip`` [di] (ones, float32) and ``out_proj`` [di, D]."""

    def __init__(self, d_model: int, spec: SSMSpec, dtype, *, generator,
                 device):
        super().__init__()
        di = spec.expand * d_model
        dtr = spec.resolved_dt_rank(d_model)
        N = spec.d_state
        g = dict(generator=generator, device=device)
        self.in_proj = normal_param((d_model, 2 * di), dtype, **g)
        self.conv_w = normal_param((di, spec.conv_dim), dtype, **g,
                                   scale=1.0 / math.sqrt(spec.conv_dim))
        self.conv_b = const_param((di,), 0.0, dtype, device)
        self.x_proj = normal_param((di, dtr + 2 * N), dtype, **g)
        self.dt_w = normal_param((dtr, di), dtype, **g)
        self.dt_b = const_param((di,), 0.0, dtype, device)
        a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
        self.a_log = nn.Parameter(torch.log(a).repeat(di, 1),
                                  requires_grad=False)
        self.d_skip = const_param((di,), 1.0, torch.float32, device)
        self.out_proj = normal_param((di, d_model), dtype, **g)


def causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over the sequence, as the reference's unrolled
    float32 taps (not ``F.conv1d``, which cuDNN would run in TF32).
    x [B,S,di], w [di,kw], conv_state [B,di,kw-1] or None (zeros).  Returns
    (y [B,S,di] in x's dtype, new conv_state [B,di,kw-1])."""
    B, S, di = x.shape
    kw = w.shape[-1]
    if conv_state is None:
        ctx = torch.zeros((B, kw - 1, di), dtype=x.dtype, device=x.device)
    else:
        ctx = conv_state.transpose(1, 2).to(x.dtype)
    xp = torch.cat([ctx, x], dim=1)  # [B, S+kw-1, di]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kw):  # kw is tiny (4)
        y = y + xp[:, i:i + S, :].float() * w[:, i].float()
    y = y + b.float()
    new_state = xp[:, S:, :].transpose(1, 2).contiguous() if kw > 1 else None
    return y.to(x.dtype), new_state


def _ssm_inputs(m: Mamba, x, spec: SSMSpec, conv_state=None):
    """The projections both paths share: (xc, z, dt f32, b, c, a f32, new
    conv state), as the reference builds them."""
    D = x.shape[-1]
    N = spec.d_state
    dtr = spec.resolved_dt_rank(D)
    xr, z = (x @ m.in_proj).chunk(2, dim=-1)
    xc, new_conv = causal_conv(xr, m.conv_w, m.conv_b, conv_state)
    xc = F.silu(xc.float()).to(x.dtype)
    dt_raw, b_ssm, c_ssm = (xc @ m.x_proj).split([dtr, N, N], dim=-1)
    # softplus: the reference's logaddexp(x, 0); torch's thresholds at 20,
    # where the two differ by less than 2e-9
    dt = F.softplus((dt_raw @ m.dt_w).float() + m.dt_b.float())
    a = -torch.exp(m.a_log)
    return xc, z, dt, b_ssm, c_ssm, a, new_conv


def mamba_forward(m: Mamba, x, spec: SSMSpec, *,
                  scan_dtype: str = "float32"):
    """x [B, S, D] -> [B, S, D] (prefill).  The scan runs in float32; the
    reference's bfloat16 scan intermediates are not ported."""
    if scan_dtype != "float32":
        raise NotImplementedError(
            f"ssm_scan_dtype={scan_dtype!r} is not ported: the port's scan "
            "runs in float32 (ROADMAP.md, Queue 1)")
    xc, z, dt, b_ssm, c_ssm, a, _ = _ssm_inputs(m, x, spec)
    y = ms.selective_scan(dt, xc, b_ssm, c_ssm, a)  # [B, S, di] f32
    y = y + m.d_skip * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ m.out_proj


def mamba_decode_step(m: Mamba, x, state: Tuple, spec: SSMSpec):
    """One-token decode.  x [B, 1, D]; state = (conv_state [B,di,kw-1],
    h [B,di,N] float32).  Returns (y [B,1,D], new_state)."""
    conv_state, h = state
    xc, z, dt, b_ssm, c_ssm, a, new_conv = _ssm_inputs(m, x, spec,
                                                      conv_state)
    dt, xc0 = dt[:, 0], xc[:, 0].float()  # [B, di]
    abar = torch.exp(dt[..., None] * a)  # [B, di, N]
    bx = (dt * xc0)[..., None] * b_ssm[:, 0, None, :].float()
    h_new = abar * h + bx
    y = (h_new * c_ssm[:, 0, None, :].float()).sum(-1)
    y = y + m.d_skip * xc0
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    return (y @ m.out_proj)[:, None, :], (new_conv, h_new)


def init_mamba_state(B: int, d_model: int, spec: SSMSpec, dtype, device):
    """(conv_state [B,di,kw-1] in ``dtype``, h [B,di,N] float32), zeros."""
    di = spec.expand * d_model
    return (torch.zeros((B, di, spec.conv_dim - 1), dtype=dtype,
                        device=device),
            torch.zeros((B, di, spec.d_state), dtype=torch.float32,
                        device=device))
