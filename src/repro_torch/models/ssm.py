"""Mamba-1 selective state-space block (the falcon-mamba substrate).

Two scans compute the same recurrence, and the caller picks one
(``scan_impl``):

* ``"kernel"`` (serving: prefill) — :func:`repro_torch.kernels.mamba_scan.
  selective_scan`: the hand-written kernel on the card, its plain version on
  the CPU.  It has no backward, and its function is float32;
* ``"chunked"`` (training) — the reference's differentiable scan: an
  associative scan over the whole sequence when ``chunk <= 0`` or
  ``chunk >= S``, else chunks of ``chunk`` steps (the sequence zero-padded
  to a multiple) with the ``[B, di, N]`` state carried across them and
  ``abar`` / ``bx`` built per chunk, the intermediates in ``scan_dtype``.
  The associative scan is the reference's ``jax.lax.associative_scan``
  recursion, step for step, so both combine in the same order.

The D skip, the ``silu(z)`` gate, the cast to the model's dtype and
``out_proj`` stay outside the scan, as in the reference.  Decode steps the
recurrence once in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMSpec
from repro_torch.kernels import mamba_scan as ms

from repro_torch.sharding.ctx import shard, sum_partials

from .layers import const_param, dtype_of, normal_param


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
    if conv_state is None:  # prefill / train, where the reference constrains
        xc = shard(xc, "act_bti")
    # x_proj contracts the channels, which the model axis splits: its
    # partial sums are reduced before dt_b (split like the channels) is
    # added to their product with dt_w
    proj = sum_partials(xc @ m.x_proj)
    dt_raw, b_ssm, c_ssm = proj.split([dtr, N, N], dim=-1)
    # softplus: the reference's logaddexp(x, 0); torch's thresholds at 20,
    # where the two differ by less than 2e-9
    dt = F.softplus((dt_raw @ m.dt_w).float() + m.dt_b.float())
    a = -torch.exp(m.a_log)
    return xc, z, dt, b_ssm, c_ssm, a, new_conv


def _combine(left, right):
    """The scan's operator on (a, b) pairs: h -> a2 (a1 h + b1) + b2."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 1 (``len(even)`` is
    ``len(odd)`` or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def associative_scan(a, b):
    """Inclusive scan of the pairs ``(a, b)`` along dim 1 under
    :func:`_combine`: ``jax.lax.associative_scan``'s recursion (combine
    adjacent pairs, scan the halves, fill in the even positions), so the
    products are formed in the same order as the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _ssm_scan_chunked(chunks, h0):
    """h_t = abar_t * h_{t-1} + bx_t ;  y_t = h_t · c_t, chunk by chunk.

    ``chunks`` yields ``(abar [B,cl,di,N], bx [B,cl,di,N], c [B,cl,N])``,
    built lazily per chunk by the caller; the state ``h0`` [B,di,N] is
    carried across them.  Returns (the last state, y [B,S,di] float32)."""
    h, ys = h0, []
    for ab, bxc, cc in chunks:
        # prefix transforms within the chunk
        a_pref, b_pref = associative_scan(ab, bxc)
        h_t = a_pref * h[:, None] + b_pref  # [B, cl, di, N]
        ys.append(torch.einsum("bldn,bln->bld", h_t.float(), cc.float()))
        h = h_t[:, -1]
    return h, torch.cat(ys, dim=1)


def _scan_chunked(xc, dt, b_ssm, c_ssm, a, *, chunk: int, scan_dtype):
    """The reference's differentiable scan: y [B, S, di] float32."""
    B, S, di = xc.shape
    sd = dtype_of(scan_dtype)
    if chunk <= 0 or chunk >= S:
        # unchunked: one associative scan over the whole sequence (h0 = 0)
        dtc = dt.to(sd)
        abar = torch.exp(dtc[..., None] * a.to(sd)).to(sd)
        bx = (dtc * xc.to(sd))[..., None] * b_ssm.to(sd)[:, :, None, :]
        _, h_t = associative_scan(abar, bx)
        return torch.einsum("bsdn,bsn->bsd", h_t.float(),
                            c_ssm.to(sd).float())
    pad = (-S) % chunk

    def padded(t):
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    dt_p, xc_p = padded(dt).to(sd), padded(xc).to(sd)
    b_p, c_p = padded(b_ssm).to(sd), padded(c_ssm).to(sd)
    a = a.to(sd)

    def chunks():  # abar / bx built per chunk keeps memory at chunk size
        for j in range(0, S + pad, chunk):
            dtj, xj, bj = (t[:, j:j + chunk] for t in (dt_p, xc_p, b_p))
            abar = torch.exp(dtj[..., None] * a).to(sd)
            bx = (dtj * xj)[..., None] * bj[:, :, None, :]
            yield abar, bx, c_p[:, j:j + chunk]

    h0 = torch.zeros((B, di, a.shape[-1]), dtype=sd, device=xc.device)
    _, y = _ssm_scan_chunked(chunks(), h0)
    return y[:, :S]


def scan_on_shards(xc, dt, b_ssm, c_ssm, a, **kw):
    """:func:`_scan_chunked` (``kw`` its keywords).  On plain tensors, the
    call itself.  On DTensors (the dry run's sharded step) each rank scans
    its own batch rows (the data axes) and channels (the model axis) under
    ``local_map``: the recurrence never mixes rows or channels, so no rank
    needs another's, and the scan's many small ops run on local tensors.
    b and c are made whole over the model axis first."""
    from repro_torch.sharding.ctx import by_axis, data_model_sizes, is_dtensor

    if not is_dtensor(xc):
        return _scan_chunked(xc, dt, b_ssm, c_ssm, a, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xc.device_mesh
    n_data, m = data_model_sizes(mesh)
    batch = Shard(0) if xc.shape[0] % n_data == 0 else Replicate()
    by_chan = xc.shape[2] % m == 0
    chan = by_axis(mesh, batch, Shard(2) if by_chan else Replicate())
    rows = by_axis(mesh, batch, Replicate())
    a_pl = by_axis(mesh, Replicate(), Shard(0) if by_chan else Replicate())
    return local_map(
        lambda *t: _scan_chunked(*t, **kw), out_placements=list(chan),
        in_placements=(chan, chan, rows, rows, a_pl), device_mesh=mesh,
        redistribute_inputs=True)(xc, dt, b_ssm, c_ssm, a)


def mamba_forward(m: Mamba, x, spec: SSMSpec, *, scan_impl: str = "kernel",
                  chunk: int = 256, scan_dtype: str = "float32"):
    """x [B, S, D] -> [B, S, D] (prefill or train).  ``scan_impl`` picks
    the scan (module docstring): ``"kernel"`` runs in float32 and refuses
    another ``scan_dtype``; ``"chunked"`` takes ``chunk`` and
    ``scan_dtype`` as the reference does."""
    xc, z, dt, b_ssm, c_ssm, a, _ = _ssm_inputs(m, x, spec)
    if scan_impl == "kernel":
        if scan_dtype != "float32":
            raise NotImplementedError(
                f"ssm_scan_dtype={scan_dtype!r} on the scan kernel: its "
                "function is float32; scan_impl='chunked' takes "
                "bfloat16 intermediates")
        y = ms.selective_scan(dt, xc, b_ssm, c_ssm, a)  # [B, S, di] f32
    elif scan_impl == "chunked":
        y = scan_on_shards(xc, dt, b_ssm, c_ssm, a, chunk=chunk,
                           scan_dtype=scan_dtype)
    else:
        raise ValueError(f"unknown scan impl {scan_impl!r}")
    y = y + m.d_skip * xc.float()
    # cast before out_proj: bf16 partial-sum all-reduces are half the traffic
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
