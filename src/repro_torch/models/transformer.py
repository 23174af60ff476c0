"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families: the
layer stack, prefill (``lm_forward``), logits, and decode against linear,
ring and buffered attention caches and mamba conv / state caches.

The reference stacks layers ``[G, ...]`` per period position and scans over
groups; the port keeps one flat :class:`torch.nn.ModuleList` in execution
order instead: group g, period position p is layer ``g * period + p``, and
the ``n_tail`` tail layers follow with ``layer_kind(p)`` of their own index
p.  So layer i always has period position ``i % period``, which decides its
mixer (``layer_kind``: attention, local attention or mamba) and its FFN
(``ffn_kind``: dense, MoE, or MoE with arctic's dense residual).  A
hybrid's attention layer sits at ``cfg.attn_offset`` of its period (0, the
first, unless the configuration says otherwise; Jamba's is 4), and with
``cfg.pos_emb == "none"`` its q and k enter attention and the cache
unrotated.
``remat="full"`` checkpoints each layer in a train step (:func:`remat`);
the serving path runs under ``torch.no_grad()``, where it does nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.obs.spans import span
from repro_torch.sharding.ctx import (is_dtensor, project, shard, shards,
                                     sum_partials, unflatten)

from .attention import (attention_on_shards, cache_insert, decode_attention,
                        decode_attention_buffered, ring_insert,
                        ring_slot_positions)
from .layers import (MLP, Embed, Norm, apply_rope, dtype_of, normal_param,
                     const_param)
from .moe import MoE, moe_ffn
from .ssm import Mamba, init_mamba_state, mamba_decode_step, mamba_forward


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv``, ``wo`` (``[d_in, d_out]``), and
    ``bq``, ``bk``, ``bv`` with ``qkv_bias`` (the config's unless given: the
    enc-dec family's cross-attention has none)."""

    def __init__(self, cfg: ModelConfig, dtype, *, generator, device,
                 qkv_bias: Optional[bool] = None):
        super().__init__()
        D, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        g = dict(generator=generator, device=device)
        self.n_heads, self.n_kv_heads, self.head_dim = H, K, hd
        self.wq = normal_param((D, H * hd), dtype, **g)
        self.wk = normal_param((D, K * hd), dtype, **g)
        self.wv = normal_param((D, K * hd), dtype, **g)
        self.wo = normal_param((H * hd, D), dtype, **g)
        self.qkv_bias = cfg.qkv_bias if qkv_bias is None else qkv_bias
        if self.qkv_bias:
            self.bq = const_param((H * hd,), 0.0, dtype, device)
            self.bk = const_param((K * hd,), 0.0, dtype, device)
            self.bv = const_param((K * hd,), 0.0, dtype, device)

    def qkv(self, x):
        B, S, _ = x.shape
        q = project(x, self.wq)
        k, v = project(x, self.wk), project(x, self.wv)
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        hd = self.head_dim
        return (unflatten(q, -1, (self.n_heads, hd)),
                unflatten(k, -1, (self.n_kv_heads, hd)),
                unflatten(v, -1, (self.n_kv_heads, hd)))


class Layer(nn.Module):
    """One pre-norm block: ``ln1``, the mixer, ``ln2``, the FFN.  ``kind``
    is ``attn`` (global) or ``local`` (sliding window), with attention
    (``attn``) as the mixer, or ``mamba``, with the SSM block (``ssm``).
    ``ffn_kind`` is ``dense`` (``mlp``), ``moe`` (``moe``) or ``moe+dense``
    (both, summed), as the reference's ``_init_layer`` lays them out."""

    def __init__(self, cfg: ModelConfig, p: int, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.kind = cfg.layer_kind(p)
        self.ffn_kind = cfg.ffn_kind(p)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, cfg.norm_eps, dt, device)
        if self.kind == "mamba":
            self.ssm = Mamba(cfg.d_model, cfg.ssm, dt, generator=generator,
                             device=device, eps=cfg.norm_eps)
        else:
            self.attn = Attention(cfg, dt, generator=generator,
                                  device=device)
        if self.ffn_kind in ("dense", "moe+dense"):
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dt,
                           generator=generator, device=device)
        if self.ffn_kind in ("moe", "moe+dense"):
            self.moe = MoE(cfg.d_model, cfg.moe, dt, cfg.mlp_type,
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


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> LM:
    return LM(cfg, generator=generator, device=device)


# --------------------------------------------------------------------------- #
# layer application
# --------------------------------------------------------------------------- #


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _rotate(cfg: ModelConfig, kind: str, q, k, positions):
    """q and k rotated by RoPE at ``positions``, or as they are under
    ``pos_emb="none"``."""
    if cfg.pos_emb == "none":
        return q, k
    if cfg.pos_emb != "rope":
        raise ValueError(f"unknown pos_emb {cfg.pos_emb!r}: rope or none")
    theta = _rope_theta(cfg, kind)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def _apply_ffn(cfg: ModelConfig, layer: Layer, h):
    if layer.ffn_kind == "dense":
        return layer.mlp(h)
    with span("model.moe"):
        out = moe_ffn(layer.moe, h, cfg.moe, cfg.mlp_type)
    if layer.ffn_kind == "moe+dense":
        out = out + layer.mlp(h)
    return out


def _apply_layer(cfg: ModelConfig, layer: Layer, x, positions, impl,
                 scan_impl):
    h = layer.ln1(x)
    if layer.kind == "mamba":
        y = mamba_forward(layer.ssm, h, cfg.ssm, scan_impl=scan_impl,
                          chunk=cfg.scan_chunk,
                          scan_dtype=cfg.ssm_scan_dtype)
    else:
        B, S, _ = h.shape
        q, k, v = layer.attn.qkv(h)
        q, k = _rotate(cfg, layer.kind, q, k, positions)
        q = shard(q, "attn_q")
        k = shard(k, "attn_kv")
        v = shard(v, "attn_kv")
        window = cfg.sliding_window if layer.kind == "local" else None
        y = attention_on_shards(q, k, v, positions, positions, causal=True,
                                window=window, impl=impl,
                                chunk=cfg.attn_chunk,
                                q_block=cfg.attn_q_block)
        y = shard(y, "attn_out")
        y = project(y.reshape(B, S, -1), layer.attn.wo)
    x = x + y
    x = shard(x, "act_btd")
    x = x + _apply_ffn(cfg, layer, layer.ln2(x))
    return shard(x, "act_btd")


def _input_embeds(cfg: ModelConfig, model: LM, batch):
    x = model.embed(batch["tokens"])
    if cfg.frontend == "vision":
        # float32 patches against bf16 weights multiply in float32, as
        # JAX's type promotion has it
        w1 = model.frontend["w1"]
        dt = torch.promote_types(batch["patches"].dtype, w1.dtype)
        p = batch["patches"].to(dt) @ w1.to(dt)
        p = F.gelu(p.float(), approximate="tanh").to(x.dtype) \
            @ model.frontend["w2"]
        x = torch.cat([p.to(x.dtype), x], dim=1)
    return x


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    ``"full"`` and autograd is recording (a train step): the counterpart of
    the reference's ``jax.checkpoint`` around its scan body.  The numbers
    are the same; the layer's activations are recomputed in the backward
    pass instead of kept."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def lm_forward(cfg: ModelConfig, model: LM, batch, *, impl=None,
               scan_impl: str = "kernel"):
    """-> final hidden states [B, S_total, D].  ``impl`` picks the
    attention path (``cfg.attn_impl`` unless given), ``scan_impl`` the
    mamba layers' scan (``models/ssm.py``)."""
    impl = impl or cfg.attn_impl
    with span("model.embed"):
        x = _input_embeds(cfg, model, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = shard(x, "act_btd")
    for layer in model.layers:
        with span("model.layer"):
            x = remat(cfg, _apply_layer, cfg, layer, x, positions, impl,
                      scan_impl)
    with span("model.final_norm"):
        return model.final_norm(x)


def head_weights(cfg: ModelConfig, model: LM):
    if cfg.tie_embeddings:
        return model.embed.tok.T
    return model.lm_head


def lm_loss(cfg: ModelConfig, model, hidden, labels):
    """Chunked cross-entropy: logits are made ``loss_chunk`` tokens at a
    time, in float32; labels below 0 weigh nothing.  The mean over the
    weighted tokens, as the reference's ``lm_loss`` (its padding of the
    last chunk adds only weightless rows, so the port does not pad).  On a
    DTensor whose tokens are split over data shards each chunk takes
    ``loss_chunk`` tokens of every shard, so no chunk crosses a shard."""
    B, S, D = hidden.shape
    head = head_weights(cfg, model)
    n = shards(hidden, 0)
    h = hidden.reshape(n, B * S // n, D)
    y = labels.reshape(n, B * S // n)
    chunk = min(cfg.loss_chunk, h.shape[1])
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        yc = y[:, c0:c0 + chunk].reshape(-1)
        logits = project(h[:, c0:c0 + chunk], head).float()  # [n, chunk, V]
        logits = shard(logits.reshape(yc.shape[0], -1), "logits")
        lse = logsumexp_on_shards(logits)
        # the label's logit kept 2-D until the subtraction
        correct = label_logits(logits, yc.clamp(0, cfg.vocab - 1).long())
        w = (yc >= 0).float()
        tot = tot + ((lse[:, None] - correct)[:, 0] * w).sum()
        cnt = cnt + w.sum()
    return tot / torch.clamp(cnt, min=1.0)


def logsumexp_on_shards(logits):
    """``torch.logsumexp(logits, -1)`` of [T, V] logits.  On a DTensor
    whose vocab is split, the explicit choice: the rows' max and their sums
    of exponentials are reduced over the vocab shards (two all-reduces of
    [T]), where DTensor's own logsumexp makes the vocab whole on every rank
    (gemma3-4b's loss chunk: [8192, 262144] float32, 8.6 GB a device)."""
    if shards(logits, 1) == 1:
        return torch.logsumexp(logits, dim=-1)
    m = sum_partials(logits.amax(-1)).detach()
    return m + torch.log(sum_partials(torch.exp(logits - m[:, None])
                                      .sum(-1)))


def label_logits(logits, labels):
    """``logits.gather(-1, labels[:, None])``: logits [T, V], labels [T]
    in range -> [T, 1].  On a DTensor whose vocab the model axis splits,
    the explicit choice (as :func:`repro_torch.models.layers.
    lookup_on_shards` for the embedding): each rank takes, under
    ``local_map``, the labels that fall in its own vocab shard (0 for the
    others) and the model axis sums them (a ``Partial`` result), so the
    backward scatters into local zeros.  DTensor's own gather on a
    vocab-split row makes zeros of the global [T, V] shape on every rank
    in the backward."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[:, None])
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    pl = tuple(logits.placements)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    out = tuple(Partial() if p.is_shard(1) else r for p, r in zip(pl, rows))
    split = [d for d, p in enumerate(pl) if p.is_shard(1)]
    lg_pl = tuple(p if p.is_shard(1) else r for p, r in zip(pl, rows))

    def local(lg, y):
        rank = 0  # this rank's vocab shard, the split mesh dims major first
        for d in split:
            rank = rank * mesh.size(d) + mesh.get_local_rank(d)
        i = y - rank * lg.shape[1]
        ok = (i >= 0) & (i < lg.shape[1])
        g = lg.gather(-1, i.clamp(0, lg.shape[1] - 1)[:, None])
        return torch.where(ok[:, None], g, torch.zeros_like(g))

    return local_map(local, out_placements=list(out),
                     in_placements=(lg_pl, rows), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def lm_logits(cfg: ModelConfig, model: LM, hidden):
    return project(hidden, head_weights(cfg, model)).float()


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device="cuda"):
    """Empty decode cache: one dict per layer in execution order (``k``,
    ``v``; ring caches of ``sliding_window`` slots on local layers; the
    append buffers ``bk``, ``bv`` on global layers with ``decode_buffer``;
    ``conv`` [B, di, kw-1] in the model's dtype and ``h`` [B, di, N] in
    float32 on mamba layers), the next position ``pos`` and, with
    ``decode_buffer``, ``cache_len``."""
    dt = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    shape = lambda L: (B, L, cfg.n_kv_heads, hd)  # noqa: E731

    def one(p):
        kind = cfg.layer_kind(p)
        if kind == "mamba":
            conv, h = init_mamba_state(B, cfg.d_model, cfg.ssm, dt, device)
            return {"conv": conv, "h": h}
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
    if layer.kind == "mamba":
        y, (lc["conv"], lc["h"]) = mamba_decode_step(
            layer.ssm, h, (lc["conv"], lc["h"]), cfg.ssm)
        x = x + y
        return x + _apply_ffn(cfg, layer, layer.ln2(x))
    B = x.shape[0]
    q, k, v = layer.attn.qkv(h)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k = _rotate(cfg, layer.kind, q, k, posv)
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
    x = x + project(y.reshape(B, 1, -1), layer.attn.wo)
    return x + _apply_ffn(cfg, layer, layer.ln2(x))


def lm_decode_step(cfg: ModelConfig, model: LM, cache, token):
    """token [B, 1] -> (logits [B, vocab] f32, new cache).  The cache's
    tensors are written in place (a mamba layer's ``conv`` and ``h`` are
    replaced in its dict); the returned cache (its ``pos`` one further)
    replaces the one passed in."""
    x = model.embed(token)
    pos = cache["pos"]
    cache_len = cache.get("cache_len")
    for layer, lc in zip(model.layers, cache["layers"]):
        x = _decode_layer(cfg, layer, lc, x, pos, cache_len)
    new_cache = {**cache, "pos": pos + 1}
    x = model.final_norm(x)
    logits = shard(lm_logits(cfg, model, x)[:, 0], "logits_bv")
    return logits, new_cache


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

