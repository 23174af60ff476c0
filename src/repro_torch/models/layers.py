"""Shared building blocks of the model stack: parameter containers
(:class:`torch.nn.Module`) and the plain functions that apply them.

Weights keep the JAX package's layout (``x @ w`` with ``w`` as
``[d_in, d_out]``), so a converted parameter is the same array on both
sides.  Norms and activations compute in float32 and cast back, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.ctx import is_dtensor


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #


def normal_param(shape, dtype, *, generator: torch.Generator, device,
                 scale: Optional[float] = None) -> nn.Parameter:
    """A normal draw scaled by ``1/sqrt(fan_in)`` (or ``scale``), made in
    float32 on ``device`` from ``generator`` and cast to ``dtype``.  A
    ``fan_in`` of 0 (a zero-width FFN's ``w_down``) gives the empty
    parameter, as the reference does."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in) if fan_in else 1.0
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype), requires_grad=False)


def const_param(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #


def rmsnorm(x, weight, eps: float = 1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (``w``) or LayerNorm (``w``, ``b``)."""

    def __init__(self, d: int, norm_type: str, eps: float, dtype, device):
        super().__init__()
        self.norm_type, self.eps = norm_type, eps
        self.w = const_param((d,), 1.0, dtype, device)
        if norm_type != "rmsnorm":
            self.b = const_param((d,), 0.0, dtype, device)

    def forward(self, x):
        if self.norm_type == "rmsnorm":
            return rmsnorm(x, self.w, self.eps)
        return layernorm(x, self.w, self.b, self.eps)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #


class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or a GELU MLP with biases.
    The GELU is the tanh approximation, JAX's ``jax.nn.gelu`` default."""

    def __init__(self, d: int, ff: int, mlp_type: str, dtype, *,
                 generator, device):
        super().__init__()
        self.mlp_type = mlp_type
        g = dict(generator=generator, device=device)
        if mlp_type == "swiglu":
            self.w_gate = normal_param((d, ff), dtype, **g)
            self.w_up = normal_param((d, ff), dtype, **g)
            self.w_down = normal_param((ff, d), dtype, **g)
        else:
            self.w_up = normal_param((d, ff), dtype, **g)
            self.b_up = const_param((ff,), 0.0, dtype, device)
            self.w_down = normal_param((ff, d), dtype, **g)
            self.b_down = const_param((d,), 0.0, dtype, device)

    def forward(self, x):
        if self.mlp_type == "swiglu":
            g = x @ self.w_gate
            u = x @ self.w_up
            return (F.silu(g.float()).to(x.dtype) * u) @ self.w_down
        h = x @ self.w_up + self.b_up
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ self.w_down + self.b_down


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] int.  The
    split-half layout: the first and second halves of the head are the
    real and imaginary parts."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# embeddings / heads
# --------------------------------------------------------------------------- #


class Embed(nn.Module):
    """Token table ``tok`` [vocab, d], drawn with unit scale."""

    def __init__(self, vocab: int, d: int, dtype, *, generator, device):
        super().__init__()
        self.tok = normal_param((vocab, d), dtype, generator=generator,
                                device=device, scale=1.0)

    def forward(self, tokens):
        if is_dtensor(self.tok):
            return lookup_on_shards(self.tok, tokens)
        return self.tok[tokens]


def lookup_on_shards(tok, tokens):
    """``tok[tokens]`` for a DTensor table (the dry run's sharded step).
    DTensor's rules for a lookup into a vocab-sharded table fail in the
    backward (an index with a partial gradient; ``embedding``'s masked
    partial against a plain one), so this is the explicit choice: the
    table is gathered whole and each rank looks up its own rows of
    ``tokens`` under ``local_map``; the table's gradient is a partial sum
    over the axes that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tok.device_mesh
    whole = (Replicate(),) * mesh.ndim
    rows = tuple(tokens.placements) if is_dtensor(tokens) else whole
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    return local_map(lambda t, i: t[i], out_placements=list(rows),
                     in_placements=(whole, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(tok, tokens)

