"""Mixture-of-Experts FFN — GShard-style grouped top-k dispatch.

Tokens are reshaped into groups of ``group_size``; routing builds per-group
one-hot dispatch / combine tensors ``[G, n, E, C]`` with per-expert capacity
``C`` (:func:`_capacity`), and the expert FFN runs as batched einsums over
the expert axis, as the reference's ``repro/models/moe.py`` computes it.  No
TPU kernel carries this path: the reference's products are plain einsums
outside any Pallas kernel, and so are the port's.

Two points where PyTorch and JAX differ, and how the port holds the
reference's answer:

* ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order among equal values, so the
  top-k comes from a stable descending sort;
* ``jax.nn.gelu`` defaults to the tanh form, so the gelu experts use
  ``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoESpec
from repro_torch.sharding.ctx import shard, unflatten

from .layers import normal_param


class MoE(nn.Module):
    """The router ``router`` [D, E], in float32 whatever the model's dtype
    (the reference draws it in float32), and the experts' ``w_up``
    [E, D, ff], ``w_down`` [E, ff, D] and, for swiglu, ``w_gate``
    [E, D, ff] in the model's dtype."""

    def __init__(self, d_model: int, spec: MoESpec, dtype, mlp_type: str, *,
                 generator, device):
        super().__init__()
        E, ff = spec.n_experts, spec.d_ff_expert
        g = dict(generator=generator, device=device)
        self.router = normal_param((d_model, E), torch.float32, **g)
        if mlp_type == "swiglu":
            self.w_gate = normal_param((E, d_model, ff), dtype, **g)
        self.w_up = normal_param((E, d_model, ff), dtype, **g)
        self.w_down = normal_param((E, ff, d_model), dtype, **g)


def _capacity(spec: MoESpec, n: int) -> int:
    cap = int(spec.top_k * n / spec.n_experts * spec.capacity_factor)
    cap = max(cap, spec.top_k, 4)
    return -(-cap // 4) * 4  # round up to a multiple of 4


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest of ``probs`` along the last axis, largest first,
    the lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(moe: MoE, x, spec: MoESpec, mlp_type: str):
    """x [B, S, D] -> [B, S, D].  Capacity-dropped top-k routing."""
    B, S, D = x.shape
    N = B * S
    g = min(spec.group_size, N)
    pad = (-N) % g
    xf = x.reshape(N, D)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    G = xf.shape[0] // g
    xg = unflatten(xf, 0, (G, g))
    xg = shard(xg, "moe_tokens")  # [G('data'), n, D]

    E, k = spec.n_experts, spec.top_k
    cap = _capacity(spec, g)

    logits = torch.einsum("gnd,de->gne", xg.float(), moe.router)
    probs = torch.softmax(logits, dim=-1)  # [G, n, E]
    top_p, top_i = _top_k(probs, k)  # [G, n, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # position-in-expert per routing choice, processed in priority order
    counts = torch.zeros((G, 1, E), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((G, g, E, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((G, g, E, cap), dtype=torch.float32,
                          device=x.device)
    for j in range(k):
        oh = F.one_hot(top_i[..., j], E).float()  # [G, n, E]
        pos = torch.cumsum(oh, dim=1) - oh + counts  # prior occupancy
        keep = oh * (pos < cap)
        counts = counts + keep.sum(dim=1, keepdim=True)
        # a kept choice's slot is below cap; a dropped one's is 0, and its
        # keep row is zero
        slot = F.one_hot((pos * keep).sum(-1).long(), cap).float()
        sel = keep[..., None] * slot[..., None, :]  # [G, n, E, cap]
        dispatch = dispatch + sel.to(x.dtype)
        combine = combine + sel * top_p[..., j][..., None, None]

    dispatch = shard(dispatch, "moe_dispatch")
    combine = shard(combine, "moe_dispatch")

    weights = [moe.w_up, moe.w_down]
    if mlp_type == "swiglu":
        weights.append(moe.w_gate)
    out = experts_on_shards(dispatch, combine, xg, *weights,
                            mlp_type=mlp_type)
    out = out.reshape(-1, D)
    if pad:
        out = out[:N]
    return out.reshape(B, S, D)


def _experts(dispatch, combine, xg, w_up, w_down, w_gate=None, *,
             mlp_type: str):
    """The expert FFN on dispatched tokens: [G, n, D] out."""
    # gather tokens into expert buffers: [G, E, cap, D]
    expert_in = torch.einsum("gnec,gnd->gecd", dispatch, xg)
    expert_in = shard(expert_in, "moe_expert_in")
    if mlp_type == "swiglu":
        gate = torch.einsum("gecd,edf->gecf", expert_in, w_gate)
        up = torch.einsum("gecd,edf->gecf", expert_in, w_up)
        h = F.silu(gate.float()).to(xg.dtype) * up
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in,
                                w_up).float(),
                   approximate="tanh").to(xg.dtype)
    expert_out = torch.einsum("gecf,efd->gecd", h, w_down)
    expert_out = shard(expert_out, "moe_expert_in")
    return torch.einsum("gnec,gecd->gnd", combine.to(xg.dtype), expert_out)


def experts_on_shards(dispatch, combine, xg, *weights, mlp_type: str):
    """:func:`_experts`.  On plain tensors, the call itself.  On DTensors
    (the dry run's sharded step) the explicit choice where DTensor's
    backward of these einsums views non-contiguous local gradients: each
    rank runs its own groups (the data axes) through its own experts (the
    model axis) under ``local_map``, the weights whole over the data axes
    (the FSDP gather), and the per-expert outputs summed over the model
    axis (a ``Partial`` result)."""
    from repro_torch.sharding.ctx import by_axis, data_model_sizes, is_dtensor

    if not is_dtensor(xg):
        return _experts(dispatch, combine, xg, *weights, mlp_type=mlp_type)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xg.device_mesh
    n_data, m = data_model_sizes(mesh)
    group = Shard(0) if xg.shape[0] % n_data == 0 else Replicate()
    by_expert = m > 1 and dispatch.shape[2] % m == 0
    sel = by_axis(mesh, group, Shard(2) if by_expert else Replicate())
    rows = by_axis(mesh, group, Replicate())
    w_pl = by_axis(mesh, Replicate(), Shard(0) if by_expert else Replicate())
    out = by_axis(mesh, group, Partial() if by_expert else Replicate())
    return local_map(
        lambda *t: _experts(*t, mlp_type=mlp_type), out_placements=list(out),
        in_placements=(sel, sel, rows) + (w_pl,) * len(weights),
        device_mesh=mesh, redistribute_inputs=True)(
        dispatch, combine, xg, *weights)
