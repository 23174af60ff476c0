"""Encoder-decoder backbone (seamless-m4t-large-v2), the reference's
``models/encdec.py`` on PyTorch modules.

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings [B, S_src, frontend_dim], which a learned
projection maps to d_model.  The encoder is bidirectional (RoPE, then
attention with ``causal=False``); the decoder is causal, with
cross-attention (no bias) over the encoder's output.  The reference stacks
each side ``[G, ...]`` and scans; the port keeps two flat
:class:`torch.nn.ModuleList`\\ s, ``enc`` and ``dec``.

A serving prefill encodes once: :func:`encode`, then the decoder pass
(:func:`decode_hidden`), then :func:`encdec_prefill_cache` on the same
encoder output.  :func:`encdec_forward` is the two passes in one, as the
reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.ctx import shard, unflatten

from .attention import (attention_on_shards, cache_insert,
                        decode_attention)
from .layers import MLP, Embed, Norm, apply_rope, dtype_of, normal_param
from .transformer import Attention, lm_loss, remat


class EncLayer(nn.Module):
    """``ln1``, self-attention ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype, *, generator, device):
        super().__init__()
        g = dict(generator=generator, device=device)
        norm = (cfg.d_model, cfg.norm_type, cfg.norm_eps, dtype, device)
        self.ln1 = Norm(*norm)
        self.attn = Attention(cfg, dtype, **g)
        self.ln2 = Norm(*norm)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, **g)


class DecLayer(nn.Module):
    """``ln1``, causal self-attention ``attn``, ``ln2``, cross-attention
    ``cross`` (no bias), ``ln3``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype, *, generator, device):
        super().__init__()
        g = dict(generator=generator, device=device)
        norm = (cfg.d_model, cfg.norm_type, cfg.norm_eps, dtype, device)
        self.ln1 = Norm(*norm)
        self.attn = Attention(cfg, dtype, **g)
        self.ln2 = Norm(*norm)
        self.cross = Attention(cfg, dtype, qkv_bias=False, **g)
        self.ln3 = Norm(*norm)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, **g)


class EncDec(nn.Module):
    """The parameters of the reference's ``init_encdec``:
    ``frontend_proj``, the ``enc`` stack, ``enc_norm``, ``embed``, the
    ``dec`` stack, ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        g = dict(generator=generator, device=device)
        self.frontend_proj = normal_param((cfg.frontend_dim, cfg.d_model), dt,
                                          **g)
        self.enc = nn.ModuleList(EncLayer(cfg, dt, **g)
                                 for _ in range(cfg.enc_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt,
                             device)
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, **g)
        self.dec = nn.ModuleList(DecLayer(cfg, dt, **g)
                                 for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt,
                               device)
        self.lm_head = normal_param((cfg.d_model, cfg.vocab), dt, **g)


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device) -> EncDec:
    return EncDec(cfg, generator=generator, device=device)


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)


def _enc_layer(cfg: ModelConfig, layer: EncLayer, x, positions, impl):
    B, S, _ = x.shape
    q, k, v = layer.attn.qkv(layer.ln1(x))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    y = attention_on_shards(q, k, v, positions, positions, causal=False,
                            impl=impl, chunk=cfg.attn_chunk)
    x = x + y.reshape(B, S, -1) @ layer.attn.wo
    x = shard(x, "act_btd")
    return shard(x + layer.mlp(layer.ln2(x)), "act_btd")


def encode(cfg: ModelConfig, model: EncDec, frames, *, impl=None):
    """frames [B, S_src, frontend_dim] -> encoder output [B, S_src, D]."""
    impl = impl or cfg.attn_impl
    x = frames.to(dtype_of(cfg.dtype)) @ model.frontend_proj
    positions = _positions(x.shape[1], x.device)
    x = shard(x, "act_btd")
    for layer in model.enc:
        x = remat(cfg, _enc_layer, cfg, layer, x, positions, impl)
    return model.enc_norm(x)


# --------------------------------------------------------------------------- #
# decoder
# --------------------------------------------------------------------------- #


def _cross_kv(cfg: ModelConfig, layer: DecLayer, enc_out):
    hd = cfg.resolved_head_dim
    return (unflatten(enc_out @ layer.cross.wk, -1, (cfg.n_kv_heads, hd)),
            unflatten(enc_out @ layer.cross.wv, -1, (cfg.n_kv_heads, hd)))


def _dec_layer(cfg: ModelConfig, layer: DecLayer, x, enc_out, positions,
               impl, pos=None, lc=None):
    """The training / prefill path when ``lc`` is None (self-attention over
    ``positions``, cross-attention over ``enc_out``); else one decode step
    at ``pos`` against the layer's cache ``lc`` (its self cache written in
    place, its cross K / V read whole)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = layer.attn.qkv(layer.ln1(x))
    if lc is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        y = attention_on_shards(q, k, v, positions, positions,
                                causal=True, impl=impl,
                                chunk=cfg.attn_chunk)
    else:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        kc, vc = cache_insert(lc["k"], lc["v"], k, v, pos)
        y = decode_attention(q, kc, vc, pos)
    x = x + y.reshape(B, S, -1) @ layer.attn.wo

    cq = unflatten(layer.ln2(x) @ layer.cross.wq, -1, (cfg.n_heads, hd))
    if lc is None:
        ck, cv = _cross_kv(cfg, layer, enc_out)
        y = attention_on_shards(cq, ck, cv, positions,
                                _positions(ck.shape[1], x.device),
                                causal=False, impl=impl,
                                chunk=cfg.attn_chunk)
    else:
        Se = lc["cross_k"].shape[1]
        y = decode_attention(cq, lc["cross_k"], lc["cross_v"], Se - 1)
    x = x + y.reshape(B, S, -1) @ layer.cross.wo
    return shard(x + layer.mlp(layer.ln3(x)), "act_btd")


def decode_hidden(cfg: ModelConfig, model: EncDec, tokens, enc_out, *,
                  impl=None):
    """The decoder pass of :func:`encdec_forward` on a given encoder
    output: tokens [B, S_tgt] -> decoder hidden [B, S_tgt, D]."""
    impl = impl or cfg.attn_impl
    x = model.embed(tokens)
    positions = _positions(x.shape[1], x.device)
    for layer in model.dec:
        x = remat(cfg, _dec_layer, cfg, layer, x, enc_out, positions, impl)
    return model.final_norm(x)


def encdec_forward(cfg: ModelConfig, model: EncDec, batch, *, impl=None):
    """batch: frames [B, S_src, fd], tokens [B, S_tgt] -> decoder hidden
    [B, S_tgt, D]."""
    enc_out = encode(cfg, model, batch["frames"], impl=impl)
    return decode_hidden(cfg, model, batch["tokens"], enc_out, impl=impl)


def encdec_loss(cfg: ModelConfig, model: EncDec, hidden, labels):
    return lm_loss(cfg, model, hidden, labels)


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def encdec_init_cache(cfg: ModelConfig, B: int, max_len: int, enc_len: int,
                      *, device="cuda"):
    """Empty decode cache: per decoder layer, the self cache ``k`` / ``v``
    [B, max_len, K, hd] and the cross cache ``cross_k`` / ``cross_v``
    [B, enc_len, K, hd]; the next position ``pos``."""
    dt = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim

    def zeros(L):
        return torch.zeros((B, L, cfg.n_kv_heads, hd), dtype=dt,
                           device=device)

    return {"layers": [{"k": zeros(max_len), "v": zeros(max_len),
                        "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}
                       for _ in range(cfg.n_layers)],
            "pos": 0}


def encdec_prefill_cache(cfg: ModelConfig, model: EncDec, enc_out, B: int,
                         max_len: int):
    """A decode cache with every layer's cross K / V computed from the
    encoder output ``enc_out`` [B, S_src, D] and an empty self cache of
    ``max_len`` slots."""
    cache = encdec_init_cache(cfg, B, max_len, 0, device=enc_out.device)
    for layer, lc in zip(model.dec, cache["layers"]):
        lc["cross_k"], lc["cross_v"] = _cross_kv(cfg, layer, enc_out)
    return cache


def encdec_decode_step(cfg: ModelConfig, model: EncDec, cache, token):
    """token [B, 1] -> (logits [B, vocab] f32, new cache).  The self caches
    are written in place; the returned cache (its ``pos`` one further)
    replaces the one passed in."""
    x = model.embed(token)
    pos = cache["pos"]
    for layer, lc in zip(model.dec, cache["layers"]):
        x = _dec_layer(cfg, layer, x, None, None, "direct", pos=pos, lc=lc)
    x = model.final_norm(x)
    logits = shard((x @ model.lm_head).float()[:, 0], "logits_bv")
    return logits, {**cache, "pos": pos + 1}
