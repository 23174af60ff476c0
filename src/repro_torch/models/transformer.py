"""Decoder-only LM for the dense and vlm families: the layer stack, prefill
(``lm_forward``), logits, and decode against linear, ring and buffered
caches.

The reference stacks layers ``[G, ...]`` per period position and scans over
groups; the port keeps one flat :class:`torch.nn.ModuleList` in execution
order instead: group g, period position p is layer ``g * period + p``, and
the ``n_tail`` tail layers follow with ``layer_kind(p)`` of their own index
p.  So layer i always has period position ``i % period``.  Mamba layers and
MoE FFNs belong to the SSM/hybrid slice and raise ``NotImplementedError``.
``remat`` is a training knob; the serving path runs under
``torch.no_grad()`` and ignores it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .attention import (attention, cache_insert, decode_attention,
                        decode_attention_buffered, ring_insert,
                        ring_slot_positions)
from .layers import (MLP, Embed, Norm, apply_rope, dtype_of, normal_param,
                     const_param)

NOT_PORTED = ("{what} is not ported yet: it comes with the SSM/hybrid slice "
              "(ROADMAP.md, Queue 1: models/ssm.py, models/moe.py and the "
              "mamba selective-scan kernel)")


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv``, ``wo`` (``[d_in, d_out]``), and
    ``bq``, ``bk``, ``bv`` with ``qkv_bias``."""

    def __init__(self, cfg: ModelConfig, dtype, *, generator, device):
        super().__init__()
        D, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        g = dict(generator=generator, device=device)
        self.n_heads, self.n_kv_heads, self.head_dim = H, K, hd
        self.wq = normal_param((D, H * hd), dtype, **g)
        self.wk = normal_param((D, K * hd), dtype, **g)
        self.wv = normal_param((D, K * hd), dtype, **g)
        self.wo = normal_param((H * hd, D), dtype, **g)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = const_param((H * hd,), 0.0, dtype, device)
            self.bk = const_param((K * hd,), 0.0, dtype, device)
            self.bv = const_param((K * hd,), 0.0, dtype, device)

    def qkv(self, x):
        B, S, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        hd = self.head_dim
        return (q.reshape(B, S, self.n_heads, hd),
                k.reshape(B, S, self.n_kv_heads, hd),
                v.reshape(B, S, self.n_kv_heads, hd))


class Layer(nn.Module):
    """One pre-norm block: ``ln1``, attention (``attn``), ``ln2``, dense
    FFN (``mlp``).  ``kind`` is ``attn`` (global) or ``local`` (sliding
    window)."""

    def __init__(self, cfg: ModelConfig, p: int, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.kind = cfg.layer_kind(p)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt, device)
        self.attn = Attention(cfg, dt, generator=generator, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dt,
                       generator=generator, device=device)


class LM(nn.Module):
    """The decoder-only LM's parameters: ``embed``, the flat ``layers``,
    ``final_norm``, ``lm_head`` (absent with ``tie_embeddings``) and the
    vision ``frontend`` projection (``w1``, ``w2``) of the vlm family."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        g = dict(generator=generator, device=device)
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, **g)
        self.layers = nn.ModuleList(
            Layer(cfg, i % cfg.period, **g) for i in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt,
                               device)
        if not cfg.tie_embeddings:
            self.lm_head = normal_param((cfg.d_model, cfg.vocab), dt, **g)
        if cfg.frontend == "vision":
            self.frontend = nn.ParameterDict({
                "w1": normal_param((cfg.frontend_dim, cfg.d_model), dt, **g),
                "w2": normal_param((cfg.d_model, cfg.d_model), dt, **g)})


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run:
    mamba layers, MoE FFNs (and with them the ssm, hybrid and moe
    families)."""
    for p in range(cfg.period):
        if cfg.layer_kind(p) == "mamba":
            raise NotImplementedError(NOT_PORTED.format(
                what=f"{cfg.name}'s mamba layers"))
        if cfg.ffn_kind(p) != "dense":
            raise NotImplementedError(NOT_PORTED.format(
                what=f"{cfg.name}'s MoE FFNs"))


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> LM:
    check_supported(cfg)
    return LM(cfg, generator=generator, device=device)


# --------------------------------------------------------------------------- #
# layer application
# --------------------------------------------------------------------------- #


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _apply_layer(cfg: ModelConfig, layer: Layer, x, positions, impl):
    h = layer.ln1(x)
    B, S, _ = h.shape
    q, k, v = layer.attn.qkv(h)
    theta = _rope_theta(cfg, layer.kind)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    window = cfg.sliding_window if layer.kind == "local" else None
    y = attention(q, k, v, positions, positions, causal=True, window=window,
                  impl=impl, chunk=cfg.attn_chunk, q_block=cfg.attn_q_block)
    x = x + y.reshape(B, S, -1) @ layer.attn.wo
    return x + layer.mlp(layer.ln2(x))


def _input_embeds(cfg: ModelConfig, model: LM, batch):
    x = model.embed(batch["tokens"])
    if cfg.frontend == "vision":
        p = batch["patches"] @ model.frontend["w1"]
        p = F.gelu(p.float(), approximate="tanh").to(x.dtype) \
            @ model.frontend["w2"]
        x = torch.cat([p.to(x.dtype), x], dim=1)
    return x


def lm_forward(cfg: ModelConfig, model: LM, batch, *, impl=None):
    """-> final hidden states [B, S_total, D]."""
    impl = impl or cfg.attn_impl
    x = _input_embeds(cfg, model, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for layer in model.layers:
        x = _apply_layer(cfg, layer, x, positions, impl)
    return model.final_norm(x)


def head_weights(cfg: ModelConfig, model: LM):
    if cfg.tie_embeddings:
        return model.embed.tok.T
    return model.lm_head


def lm_logits(cfg: ModelConfig, model: LM, hidden):
    return (hidden @ head_weights(cfg, model)).float()


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device="cuda"):
    """Empty decode cache: one dict per layer in execution order (``k``,
    ``v``; ring caches of ``sliding_window`` slots on local layers; the
    append buffers ``bk``, ``bv`` on global layers with ``decode_buffer``),
    the next position ``pos`` and, with ``decode_buffer``, ``cache_len``."""
    check_supported(cfg)
    dt = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    shape = lambda L: (B, L, cfg.n_kv_heads, hd)  # noqa: E731

    def one(p):
        kind = cfg.layer_kind(p)
        L = cfg.sliding_window if kind == "local" else max_len
        lc = {"k": torch.zeros(shape(L), dtype=dt, device=device),
              "v": torch.zeros(shape(L), dtype=dt, device=device)}
        if kind == "attn" and cfg.decode_buffer:
            lc["bk"] = torch.zeros(shape(cfg.decode_buffer), dtype=dt,
                                   device=device)
            lc["bv"] = torch.zeros(shape(cfg.decode_buffer), dtype=dt,
                                   device=device)
        return lc

    cache = {"layers": [one(i % cfg.period) for i in range(cfg.n_layers)],
             "pos": 0}
    if cfg.decode_buffer:
        cache["cache_len"] = 0
    return cache


def _decode_layer(cfg: ModelConfig, layer: Layer, lc, x, pos: int,
                  cache_len: Optional[int]):
    h = layer.ln1(x)
    B = x.shape[0]
    q, k, v = layer.attn.qkv(h)
    theta = _rope_theta(cfg, layer.kind)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, theta)
    k = apply_rope(k, posv, theta)
    if layer.kind == "local":
        w = cfg.sliding_window
        kc, vc = ring_insert(lc["k"], lc["v"], k, v, pos, w)
        y = decode_attention(q, kc, vc, pos,
                             slot_pos=ring_slot_positions(pos, w, x.device))
    elif cfg.decode_buffer:
        # paged-append: the main cache is read-only; the new token lands in
        # the small append buffer
        bi = pos - cache_len
        if not 0 <= bi < lc["bk"].shape[1]:
            raise IndexError(f"append buffer full at position {pos}: "
                             "merge_decode_buffer must run every "
                             f"{cfg.decode_buffer} tokens")
        lc["bk"][:, bi:bi + 1] = k.to(lc["bk"].dtype)
        lc["bv"][:, bi:bi + 1] = v.to(lc["bv"].dtype)
        y = decode_attention_buffered(q, lc["k"], lc["v"], lc["bk"],
                                      lc["bv"], cache_len, pos)
    else:
        kc, vc = cache_insert(lc["k"], lc["v"], k, v, pos)
        y = decode_attention(q, kc, vc, pos, slot_pos=None)
    x = x + y.reshape(B, 1, -1) @ layer.attn.wo
    return x + layer.mlp(layer.ln2(x))


def lm_decode_step(cfg: ModelConfig, model: LM, cache, token):
    """token [B, 1] -> (logits [B, vocab] f32, new cache).  The cache's
    tensors are written in place; the returned cache (its ``pos`` one
    further) replaces the one passed in."""
    x = model.embed(token)
    pos = cache["pos"]
    cache_len = cache.get("cache_len")
    for layer, lc in zip(model.layers, cache["layers"]):
        x = _decode_layer(cfg, layer, lc, x, pos, cache_len)
    new_cache = {**cache, "pos": pos + 1}
    x = model.final_norm(x)
    return lm_logits(cfg, model, x)[:, 0], new_cache


def merge_decode_buffer(cfg: ModelConfig, cache):
    """Fold the (full) append buffer into the main cache, in place — runs
    once every ``decode_buffer`` tokens."""
    if not cfg.decode_buffer:
        return cache
    cl = cache["cache_len"]
    n = cfg.decode_buffer
    for lc in cache["layers"]:
        if "bk" not in lc:
            continue
        if cl + n > lc["k"].shape[1]:
            raise IndexError(f"merging {n} buffered tokens at {cl} overflows "
                             f"a cache of {lc['k'].shape[1]} slots")
        lc["k"][:, cl:cl + n] = lc["bk"]
        lc["v"][:, cl:cl + n] = lc["bv"]
        lc["bk"].zero_()
        lc["bv"].zero_()
    return {**cache, "cache_len": cl + n}

