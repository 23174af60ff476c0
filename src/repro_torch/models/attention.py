"""GQA attention: the direct path, the chunked online-softmax paths, the
switch that picks one (``impl="flash"`` reaches the hand-written kernel),
decode against linear, ring and buffered caches, and the cache writes.

Same maths as the JAX package's ``models/attention.py``.  Where the
reference multiplies in bf16 with float32 accumulation
(``preferred_element_type``), the port widens the bf16 operands to float32
first: the products of bf16 values are exact in float32, so the sums are
the same up to their order.  The cache writes update the cache tensors in
place (JAX returns new arrays): a decode step's cache replaces the one it
was given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.sharding.ctx import (is_dtensor, shards, sum_partials,
                                     unflatten)

NEG_INF = -1e30


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: Optional[int]):
    """[Sq, Skv] additive bias from position masks."""
    ok = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= kv_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, zero + NEG_INF)


def attention_direct(q, k, v, q_pos, kv_pos, *, causal=True, window=None):
    """Reference/smoke path: materialises the score matrix.

    q [B,Sq,H,hd], k/v [B,Skv,K,hd] -> [B,Sq,H,hd]
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, Sq, K, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    scores = scores + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _scaled_q(q, hd: int):
    """q / sqrt(hd), in q's dtype (as the reference divides)."""
    return q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)


def _online_step(m, l, acc, s, vj):
    """One kv chunk of the online softmax: s [..., Sq, c] f32 scores,
    vj [B, c, K, hd]; the probabilities are rounded to v's dtype before
    the product, as the reference does."""
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqc,bckh->bkgqh", p.to(vj.dtype).float(), vj.float())
    return m_new, l_new, acc_new


def attention_chunked(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                      chunk=512):
    """Online-softmax over kv chunks: O(Sq * chunk) live scores instead of
    O(Sq * Skv); every chunk is visited, as in the reference."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    K = k.shape[2]
    G = H // K
    if Skv % chunk != 0:
        pad = chunk - Skv % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=2 ** 30)
        Skv += pad
    qf = _scaled_q(q, hd).reshape(B, Sq, K, G, hd).float()
    dev = q.device
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, chunk):
        kj, vj = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kj.float())
        s = s + _mask_bias(q_pos, kv_pos[c0:c0 + chunk], causal=causal,
                           window=window)
        m, l, acc = _online_step(m, l, acc, s, vj)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attention_chunked2d(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                        chunk=512, q_block=2048):
    """Two-level chunking: queries are blocked too, and only the
    (q-block, kv-chunk) pairs the causal (and sliding-window) mask can reach
    are visited.  Positions are contiguous from 0 on this path (the
    prefill/train case), as in the reference."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    K = k.shape[2]
    G = H // K
    qb = min(q_block, Sq)
    if Sq % qb != 0:
        return attention_chunked(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, chunk=chunk)
    ck = min(chunk, Skv)
    n_q = Sq // qb
    n_kv = (Skv + (-Skv) % ck) // ck
    dev = q.device
    qf = _scaled_q(q, hd).reshape(B, n_q, qb, K, G, hd)
    out = torch.zeros((B, n_q, qb, K, G, hd), dtype=q.dtype, device=dev)
    for i in range(n_q):
        qlo, qhi = i * qb, (i + 1) * qb - 1
        qp = qlo + torch.arange(qb, dtype=torch.int32, device=dev)
        qi = qf[:, i].float()
        m = torch.full((B, K, G, qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, qb, hd), dtype=torch.float32, device=dev)
        for j in range(n_kv):
            klo = j * ck
            khi = min((j + 1) * ck, Skv) - 1
            if causal and klo > qhi:
                continue  # entirely in the future
            if window is not None and khi <= qlo - window:
                continue  # entirely outside the window
            kj = k[:, klo:klo + ck]
            vj = v[:, klo:klo + ck]
            if kj.shape[1] < ck:  # the ragged last chunk, zero-padded
                pad = ck - kj.shape[1]
                kj = torch.nn.functional.pad(kj, (0, 0, 0, 0, 0, pad))
                vj = torch.nn.functional.pad(vj, (0, 0, 0, 0, 0, pad))
            kp = klo + torch.arange(ck, dtype=torch.int32, device=dev)
            s = torch.einsum("bqkgh,bckh->bkgqc", qi, kj.float())
            ok = (kp < Skv)[None, :].expand(qb, ck)
            if causal:
                ok = ok & (kp[None, :] <= qp[:, None])
            if window is not None:
                ok = ok & (kp[None, :] > qp[:, None] - window)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m, l, acc = _online_step(m, l, acc, s, vj)
        blk = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, i] = blk.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, Sq, H, hd)


def attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
              impl="chunked", chunk=512, q_block=2048):
    """The attention switch: small problems (Sq * Skv <= 256 * 256) always
    take the direct path; otherwise ``impl`` picks chunked, chunked2d,
    direct or flash (the hand-written kernel on the card)."""
    if impl == "direct" or q.shape[1] * k.shape[1] <= 256 * 256:
        return attention_direct(q, k, v, q_pos, kv_pos, causal=causal,
                                window=window)
    if impl == "chunked":
        return attention_chunked(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, chunk=chunk)
    if impl == "chunked2d":
        return attention_chunked2d(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, chunk=chunk,
                                   q_block=q_block)
    if impl == "flash":
        from repro_torch.kernels import flash_attention as fa
        # the kernel takes positions 0..S-1, the only ones prefill passes
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


# --------------------------------------------------------------------------- #
# decode (one new token against a cache)
# --------------------------------------------------------------------------- #


def _decode_q(q, k_cache):
    """The scaled query [B, 1, H, hd] as float32 [B, K, G, hd], K the
    cache's kv heads.  On DTensors q first takes the cache's layout (its
    batch split, its head_dim split over the model axis, the heads whole),
    so the score product contracts a split head_dim into partial sums,
    which the callers reduce whole (``sum_partials``).  The explicit
    choice: split over the heads, q cannot follow 4 kv heads over a model
    axis of 8, and its reshape into groups makes a strided shard; left
    partial, the scores' softmax splits the heads over the model axis,
    which the values' split head_dim does not match.  DTensor plans every
    candidate strategy of a product on such layouts by a graph search,
    50-100 ms each on a 3-D mesh (minutes a decode step)."""
    _, _, K, hd = k_cache.shape
    q = _scaled_q(q, hd)
    if is_dtensor(q) and is_dtensor(k_cache):
        from torch.distributed.tensor import Replicate

        q = q.redistribute(q.device_mesh, [
            p if p.is_shard(0) or p.is_shard(3) else Replicate()
            for p in k_cache.placements])
    return unflatten(q[:, 0], 1, (K, q.shape[2] // K)).float()


def _decode_out(out, dtype):
    """[B, K, G, hd] float32 -> [B, 1, H, hd] in ``dtype``.  On a DTensor
    whose head_dim the model axis splits (the decode caches' layout), the
    split moves to the heads (an all-to-all of one token's output; a
    gather where the shards do not divide the heads): the caller's merge
    of heads and head_dim would otherwise make a strided shard, which
    ``wo``'s row shards do not match and for which DTensor plans every
    candidate strategy by a graph search, ~50 ms each on a 3-D mesh."""
    out = out.flatten(1, 2)
    if is_dtensor(out) and shards(out, 2) > 1:
        from torch.distributed.tensor import Replicate, Shard

        n = shards(out, 1) * shards(out, 2)
        to = Shard(1) if out.shape[1] % n == 0 else Replicate()
        out = out.redistribute(out.device_mesh, [
            to if p.is_shard(2) else p for p in out.placements])
    return out[:, None].to(dtype)


def decode_attention(q, k_cache, v_cache, pos: int, *, slot_pos=None):
    """q [B,1,H,hd]; caches [B,Smax,K,hd]; ``pos`` = index of the new token.
    ``slot_pos`` [Smax] gives the absolute position stored in each cache
    slot (ring buffers); defaults to iota for linear caches."""
    Smax = k_cache.shape[1]
    if slot_pos is None:
        slot_pos = torch.arange(Smax, dtype=torch.int32, device=q.device)
    qf = _decode_q(q, k_cache)
    s = sum_partials(torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()))
    ok = slot_pos <= pos
    s = torch.where(ok[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return _decode_out(out, q.dtype)


def decode_attention_buffered(q, k_cache, v_cache, kb, vb, cache_len: int,
                              pos: int):
    """Decode against a read-only main cache plus a small append buffer.

    q [B,1,H,hd]; k_cache/v_cache [B,L,K,hd] hold positions [0, cache_len);
    kb/vb [B,BUF,K,hd] hold positions [cache_len, cache_len+BUF); ``pos`` is
    the current token's position (attends to everything <= pos).
    """
    L, BUF = k_cache.shape[1], kb.shape[1]
    dev = q.device
    qf = _decode_q(q, k_cache)
    s1 = sum_partials(torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()))
    s2 = sum_partials(torch.einsum("bkgh,bskh->bkgs", qf, kb.float()))
    ok1 = torch.arange(L, dtype=torch.int32, device=dev) < cache_len
    ok2 = cache_len + torch.arange(BUF, dtype=torch.int32, device=dev) <= pos
    s1 = torch.where(ok1[None, None, None, :], s1,
                     torch.full_like(s1, NEG_INF))
    s2 = torch.where(ok2[None, None, None, :], s2,
                     torch.full_like(s2, NEG_INF))
    m = torch.maximum(s1.amax(-1), s2.amax(-1))
    e1 = torch.exp(s1 - m[..., None])
    e2 = torch.exp(s2 - m[..., None])
    l = e1.sum(-1) + e2.sum(-1)
    o = torch.einsum("bkgs,bskh->bkgh", e1.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o + torch.einsum("bkgs,bskh->bkgh", e2.to(vb.dtype).float(),
                         vb.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return _decode_out(o, q.dtype)


def _write_slot(cache, new, slot: int) -> None:
    if not 0 <= slot < cache.shape[1]:
        raise IndexError(f"cache slot {slot} outside a cache of "
                         f"{cache.shape[1]} slots")
    cache[:, slot:slot + 1] = new.to(cache.dtype)


def cache_insert(k_cache, v_cache, k_new, v_new, pos: int):
    """Write [B,1,K,hd] at index ``pos`` of a linear cache, in place.  A
    position past the cache raises (JAX would clamp it onto the last
    slot)."""
    _write_slot(k_cache, k_new, pos)
    _write_slot(v_cache, v_new, pos)
    return k_cache, v_cache


def ring_insert(k_cache, v_cache, k_new, v_new, pos: int, window: int):
    """Write [B,1,K,hd] at slot ``pos % window`` of a ring cache, in
    place."""
    slot = pos % window
    _write_slot(k_cache, k_new, slot)
    _write_slot(v_cache, v_new, slot)
    return k_cache, v_cache


def ring_slot_positions(pos: int, window: int, device=None):
    """Absolute position stored in each slot of a ring cache after writing
    ``pos``: slot s holds the largest p <= pos with p % window == s."""
    s = torch.arange(window, dtype=torch.int32, device=device)
    p = pos - torch.remainder(pos - s, window)
    return torch.where(p >= 0, p, torch.full_like(p, 2 ** 30))


def attention_on_shards(q, k, v, q_pos, kv_pos, **kw):
    """:func:`attention` (``kw`` its keywords).  On plain tensors, the call
    itself.  On DTensors (the dry run's sharded step) DTensor has no
    sharding rule for the chunked paths' grouped products, so this is the
    explicit choice: each rank runs :func:`attention` on its own batch rows
    (the mesh's data axes) and q heads (the model axis), with the kv heads
    those q heads read, under ``local_map``; q, k and v are redistributed
    to that layout first (k and v whole over the model axis)."""
    from repro_torch.sharding.ctx import by_axis, data_model_sizes

    if not is_dtensor(q):
        return attention(q, k, v, q_pos, kv_pos, **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, _, H, _ = q.shape
    K = k.shape[2]
    n_data, m = data_model_sizes(mesh)
    by_head = m > 1 and H % m == 0
    G, Hl = H // K, H // m
    if by_head and Hl % G and G % Hl:
        raise ValueError(f"{H} q heads over {m} ranks split the {K} kv "
                         "heads' groups")
    batch = Shard(0) if B % n_data == 0 else Replicate()
    q_pl = by_axis(mesh, batch, Shard(2) if by_head else Replicate())
    kv_pl = by_axis(mesh, batch, Replicate())

    def local(q, k, v, q_pos, kv_pos):
        if by_head:  # the kv heads of this rank's q heads
            r = mesh.get_local_rank("model")
            lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return attention(q, k, v, q_pos, kv_pos, **kw)

    # with the heads split, each rank's k and v gradients are partial sums
    # over the q heads it holds
    kv_grad = by_axis(mesh, batch, Partial() if by_head else Replicate())
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl, None, None),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, None, None),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, q_pos, kv_pos)
