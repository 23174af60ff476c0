"""Mamba-1 selective state-space block (the falcon-mamba substrate).

Two paths compute the same block, and the caller picks one
(``scan_impl``):

* ``"kernel"`` (serving: prefill) — the block through two hand-written
  kernels on the card (their plain versions on the CPU), with the four
  matrix products on ``torch.matmul`` around them:
  :func:`repro_torch.kernels.mamba_scan.causal_conv_silu` (the conv, its
  bias and SiLU, reading in_proj's output in place) and
  :func:`repro_torch.kernels.mamba_scan.selective_scan_fused` (softplus,
  the scan, the D skip, the ``silu(z)`` gate and the cast).  The plain
  versions repeat the chunked path's elementwise chain operation for
  operation.  They have no backward, the scan's function is float32, and
  they take no DTensor;
* ``"chunked"`` (training, the sharded step) — the reference's
  differentiable scan: an
  associative scan over the whole sequence when ``chunk <= 0`` or
  ``chunk >= S``, else chunks of ``chunk`` steps (the sequence zero-padded
  to a multiple) with the ``[B, di, N]`` state carried across them and
  ``abar`` / ``bx`` built per chunk, the intermediates in ``scan_dtype``.
  The associative scan is the reference's ``jax.lax.associative_scan``
  recursion, step for step, so both combine in the same order.

On the chunked path the conv, the D skip, the ``silu(z)`` gate, the cast
to the model's dtype and ``out_proj`` stay outside the scan, as in the
reference.  Decode steps the recurrence once in plain PyTorch, its conv
state carried.

With ``SSMSpec.inner_norm`` (Jamba's mixer) dt's low-rank input, B and C
each pass an RMS norm with weights (``dt_norm``, ``b_norm``, ``c_norm``)
right after ``x_proj``, on all three paths (:func:`_inner_norms`): plain
PyTorch operations before ``dt_w`` and the scan.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMSpec
from repro_torch.kernels import mamba_scan as ms

from repro_torch.sharding.ctx import (gathered, is_dtensor, project, shard,
                                     shards, sum_partials, unflatten)

from .layers import const_param, dtype_of, normal_param, rmsnorm


class Mamba(nn.Module):
    """The reference's leaves: ``in_proj`` [D, 2 di], the depthwise
    ``conv_w`` [di, kw] and ``conv_b``, ``x_proj`` [di, dt_rank + 2N],
    ``dt_w`` [dt_rank, di] and ``dt_b``, ``a_log`` [di, N] (S4D-real, float32),
    ``d_skip`` [di] (ones, float32) and ``out_proj`` [di, D]; with
    ``spec.inner_norm`` also the RMS norms' weights ``dt_norm`` [dt_rank],
    ``b_norm`` and ``c_norm`` [N] (ones) and their epsilon ``eps``."""

    def __init__(self, d_model: int, spec: SSMSpec, dtype, *, generator,
                 device, eps: float = 1e-6):
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
        if spec.inner_norm:
            self.eps = eps
            self.dt_norm = const_param((dtr,), 1.0, dtype, device)
            self.b_norm = const_param((N,), 1.0, dtype, device)
            self.c_norm = const_param((N,), 1.0, dtype, device)


def _inner_norms(m: Mamba, spec: SSMSpec, dt_raw, b_ssm, c_ssm):
    """dt's low-rank input, B and C as the scan takes them: unchanged, or
    each through its RMS norm under ``spec.inner_norm``."""
    if not spec.inner_norm:
        return dt_raw, b_ssm, c_ssm
    return (rmsnorm(dt_raw, m.dt_norm, m.eps), rmsnorm(b_ssm, m.b_norm, m.eps),
            rmsnorm(c_ssm, m.c_norm, m.eps))


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


def conv_on_shards(x, w, b, conv_state=None):
    """:func:`causal_conv`.  On plain tensors, the call itself.  On
    DTensors (the dry run's sharded step) each rank convolves its own batch
    rows (the data axes) and channels (the model axis) under ``local_map``,
    the sequence made whole first: the conv never mixes rows or channels,
    and its zero context and float32 accumulator are then local, where
    ``torch.zeros`` of ``x``'s shape would be a tensor of the global shape
    on every rank."""
    if not is_dtensor(x):
        return causal_conv(x, w, b, conv_state)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in x.placements]
    chan = [Shard(0) if p.is_shard(2) else Replicate() for p in rows]
    # the ranks that split the rows each hold a partial sum of w's and b's
    # gradients
    chan_grad = [Partial() if p.is_shard(0) else c
                 for p, c in zip(rows, chan)]
    state = [Shard(1) if p.is_shard(2) else p for p in rows]
    state_in = state if conv_state is not None else None
    return local_map(
        causal_conv, out_placements=(rows, state if w.shape[-1] > 1
                                     else None),
        in_placements=(rows, chan, chan, state_in),
        in_grad_placements=(rows, chan_grad, chan_grad, state_in),
        device_mesh=x.device_mesh, redistribute_inputs=True)(
        x, w, b, conv_state)


def softplus_on_shards(x):
    """``F.softplus(x)``, elementwise, on each rank's own shard of a
    DTensor under ``local_map`` (its partial sums reduced first).  The
    explicit choice: DTensor's decomposition of softplus differs between
    PyTorch versions, and in some it makes float32 tensors of the global
    shape on every rank."""
    if not is_dtensor(x):
        return F.softplus(x)
    from torch.distributed.tensor.experimental import local_map

    x = sum_partials(x)
    return local_map(F.softplus, out_placements=list(x.placements),
                     in_placements=(tuple(x.placements),),
                     device_mesh=x.device_mesh)(x)


def _in_proj(x, w):
    """``project(x, w).chunk(2, -1)``: the conv's input and the gate.  On
    a DTensor whose ``w`` columns the model axis splits, the two halves'
    columns lie on different ranks (the first half of them hold the conv
    input's), and DTensor splits the product only by gathering its
    channels whole on every rank.  The explicit choice, where the rows
    outnumber d_model (prefill, training): the weight is gathered instead
    and each half split anew over the model axis, d_model x 2 d_inner
    elements in place of rows x 2 d_inner; a decode step's few rows are
    gathered as before."""
    m, half = shards(w, 1), w.shape[1] // 2
    if m == 1 or half % m or math.prod(x.shape[:-1]) <= w.shape[0]:
        return project(x, w).chunk(2, dim=-1)
    from torch.distributed.tensor import Shard

    halves = unflatten(gathered(w), 1, (2, half))  # the columns gathered
    halves = halves.redistribute(halves.device_mesh, [
        Shard(2) if name == "model" else p for name, p in
        zip(halves.device_mesh.mesh_dim_names, halves.placements)])
    return x @ halves[:, 0], x @ halves[:, 1]


def _ssm_inputs(m: Mamba, x, spec: SSMSpec, conv_state=None):
    """The chunked path's and the decode step's projections and elementwise
    chain: (xc, z, dt f32, b, c, a f32, new conv state), as the reference
    builds them.  The kernel path (:func:`_forward_kernels`) runs the same
    chain inside its two kernels instead."""
    D = x.shape[-1]
    N = spec.d_state
    dtr = spec.resolved_dt_rank(D)
    xr, z = _in_proj(x, m.in_proj)
    xc, new_conv = conv_on_shards(xr, m.conv_w, m.conv_b, conv_state)
    xc = F.silu(xc.float()).to(x.dtype)
    if conv_state is None:  # prefill / train, where the reference constrains
        xc = shard(xc, "act_bti")
    # x_proj contracts the channels, which the model axis splits: its
    # partial sums are reduced before dt_b (split like the channels) is
    # added to their product with dt_w
    proj = sum_partials(xc @ m.x_proj)
    dt_raw, b_ssm, c_ssm = _inner_norms(m, spec,
                                        *proj.split([dtr, N, N], dim=-1))
    # softplus: the reference's logaddexp(x, 0); torch's thresholds at 20,
    # where the two differ by less than 2e-9
    dt = softplus_on_shards((dt_raw @ m.dt_w).float() + m.dt_b.float())
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
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xc.device_mesh
    n_data, m = data_model_sizes(mesh)
    by_row = xc.shape[0] % n_data == 0
    batch = Shard(0) if by_row else Replicate()
    by_chan = xc.shape[2] % m == 0
    chan = by_axis(mesh, batch, Shard(2) if by_chan else Replicate())
    rows = by_axis(mesh, batch, Replicate())
    a_pl = by_axis(mesh, Replicate(), Shard(0) if by_chan else Replicate())
    # b and c feed every channel, a every row: the ranks that split those
    # each hold a partial sum of their gradients
    rows_grad = by_axis(mesh, batch, Partial() if by_chan else Replicate())
    a_grad = by_axis(mesh, Partial() if by_row else Replicate(),
                     Shard(0) if by_chan else Replicate())
    return local_map(
        lambda *t: _scan_chunked(*t, **kw), out_placements=list(chan),
        in_placements=(chan, chan, rows, rows, a_pl),
        in_grad_placements=(chan, chan, rows_grad, rows_grad, a_grad),
        device_mesh=mesh, redistribute_inputs=True)(xc, dt, b_ssm, c_ssm, a)


def _forward_kernels(m: Mamba, x, spec: SSMSpec):
    """The prefill through the block's two kernels: in_proj, the conv
    kernel on its first half in place, x_proj, dt's product, the scan's
    second entry (z, b and c read in place; b and c contiguous after
    the inner norms), out_proj."""
    N = spec.d_state
    dtr = spec.resolved_dt_rank(x.shape[-1])
    xr, z = (x @ m.in_proj).chunk(2, dim=-1)
    xc = ms.causal_conv_silu(xr, m.conv_w, m.conv_b)
    dt_raw, b_ssm, c_ssm = _inner_norms(
        m, spec, *(xc @ m.x_proj).split([dtr, N, N], dim=-1))
    y = ms.selective_scan_fused(dt_raw @ m.dt_w, m.dt_b, xc, z, b_ssm, c_ssm,
                                m.a_log, m.d_skip)
    return y @ m.out_proj


def mamba_forward(m: Mamba, x, spec: SSMSpec, *, scan_impl: str = "kernel",
                  chunk: int = 256, scan_dtype: str = "float32"):
    """x [B, S, D] -> [B, S, D] (prefill or train).  ``scan_impl`` picks
    the path (module docstring): ``"kernel"`` runs the scan in float32 and
    refuses another ``scan_dtype``; ``"chunked"`` takes ``chunk`` and
    ``scan_dtype`` as the reference does."""
    if scan_impl == "kernel":
        if scan_dtype != "float32":
            raise NotImplementedError(
                f"ssm_scan_dtype={scan_dtype!r} on the scan kernel: its "
                "function is float32; scan_impl='chunked' takes "
                "bfloat16 intermediates")
        return _forward_kernels(m, x, spec)
    if scan_impl != "chunked":
        raise ValueError(f"unknown scan impl {scan_impl!r}")
    xc, z, dt, b_ssm, c_ssm, a, _ = _ssm_inputs(m, x, spec)
    y = scan_on_shards(xc, dt, b_ssm, c_ssm, a, chunk=chunk,
                       scan_dtype=scan_dtype)
    y = y + m.d_skip * xc.float()
    # cast before out_proj: bf16 partial-sum all-reduces are half the traffic
    y = (y * F.silu(z.float())).to(x.dtype)
    return project(y, m.out_proj)


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
    return project(y, m.out_proj)[:, None, :], (new_conv, h_new)


def init_mamba_state(B: int, d_model: int, spec: SSMSpec, dtype, device):
    """(conv_state [B,di,kw-1] in ``dtype``, h [B,di,N] float32), zeros."""
    di = spec.expand * d_model
    return (torch.zeros((B, di, spec.conv_dim - 1), dtype=dtype,
                        device=device),
            torch.zeros((B, di, spec.d_state), dtype=torch.float32,
                        device=device))
