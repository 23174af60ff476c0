"""Plain reference of a decoder-only mixture-of-experts transformer
(qwen3-moe-30b-a3b): one prompt to its last position's logits, in
float32.

Per layer, on x [S, D]:

    h     = rmsnorm(x) * w_ln1
    q, k, v = h @ wq, h @ wk, h @ wv           # H query heads, K kv heads
    q, k  = rope(q), rope(k)                   # split-half, theta
    x     = x + causal_gqa_attention(q, k, v) @ wo
    h     = rmsnorm(x) * w_ln2
    x     = x + moe(h)

``moe``: tokens in groups of ``group_size`` (the last padded with zero
rows); per group, a float32 router's softmax, the top-k experts (the
lower index first among equal probabilities), their probabilities
divided by their sum; each expert keeps at most ``capacity`` routing
choices, taken choice by choice (every token's first choice before any
token's second) and token by token within a choice; a dropped choice adds
nothing.  A kept choice adds its weight times the expert's SwiGLU FFN of
the token.  Then rmsnorm and the LM head at the last position.  The
capacity dropping is the program's GShard dispatch, where the published
model drops nothing; the configuration's ``semantics`` give it, with the
norms' epsilon.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.harness.weights import Leaf
from bench.reference.common import hold, linear, rmsnorm, silu

#: query rows x heads x keys of one block of attention scores, at most
SCORES = 1 << 28


def dims(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"],
            cfg["num_experts"], cfg["num_experts_per_tok"],
            cfg["moe_intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def leaves(cfg: dict):
    """The weights, by the names the program's layout gives them, in the
    types it serves them in (the router in float32)."""
    D, H, K, hd, E, k, F_, V, L = dims(cfg)
    dt = cfg["torch_dtype"]
    return [
        Leaf("embed.tok", (V, D), 1, dt, {"normal": 1.0}),
        Leaf("layers.*.ln1.w", (D,), L, dt, {"around": [1.0, 0.1]}),
        Leaf("layers.*.ln2.w", (D,), L, dt, {"around": [1.0, 0.1]}),
        Leaf("layers.*.attn.wq", (D, H * hd), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.attn.wk", (D, K * hd), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.attn.wv", (D, K * hd), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.attn.wo", (H * hd, D), L, dt,
             {"normal": (H * hd) ** -0.5}),
        Leaf("layers.*.moe.router", (D, E), L, "float32",
             {"normal": D ** -0.5}),
        Leaf("layers.*.moe.w_gate", (E, D, F_), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.moe.w_up", (E, D, F_), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.moe.w_down", (E, F_, D), L, dt, {"normal": F_ ** -0.5}),
        Leaf("final_norm.w", (D,), 1, dt, {"around": [1.0, 0.1]}),
        Leaf("lm_head", (D, V), 1, dt, {"normal": D ** -0.5}),
    ]


# --------------------------------------------------------------------------- #
# the benchmark's arithmetic (harness/flops.py)
# --------------------------------------------------------------------------- #


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token goes through, the LM head apart: the
    attention projections, the router and its top-k experts' three
    matrices, in every layer."""
    D, H, K, hd, E, k, F_, V, L = dims(cfg)
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    return L * (attn + D * E + k * 3 * D * F_)


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attention_shape(cfg: dict):
    """(attention layers, query heads, head dim)."""
    return (cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["head_dim"])


# --------------------------------------------------------------------------- #
# the forward pass
# --------------------------------------------------------------------------- #


def rope(x, theta: float):
    """x [S, heads, hd], positions 0..S-1; the first and second halves of a
    head are the real and imaginary parts."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q [S, H, hd], k / v [S, K, hd] -> [S, H, hd]; query blocks, each
    against the keys up to its last row."""
    S, H, hd = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    rows = max(1, SCORES // (H * S))
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) / hd ** 0.5
        later = torch.arange(q1, device=q.device)[None, :] \
            > torch.arange(q0, q1, device=q.device)[:, None]
        s = s.masked_fill(later, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    return out


def capacity(cfg: dict, group: int) -> int:
    sem = cfg["semantics"]
    k, E = cfg["num_experts_per_tok"], cfg["num_experts"]
    cap = int(k * group / E * sem["capacity_factor"])
    cap = max(cap, k, 4)
    return -(-cap // 4) * 4


def keep(cfg: dict, top_i):
    """Which routing choices [G, g, k] fit their expert's capacity: choice
    by choice, token by token within a choice."""
    E = cfg["num_experts"]
    cap = capacity(cfg, top_i.shape[1])
    used = torch.zeros((top_i.shape[0], E), dtype=torch.long,
                       device=top_i.device)
    kept = torch.zeros_like(top_i, dtype=torch.bool)
    for j in range(top_i.shape[-1]):
        hot = F.one_hot(top_i[..., j], E)  # [G, g, E]
        slot = ((torch.cumsum(hot, dim=1) - hot + used[:, None]) * hot).sum(-1)
        kept[..., j] = slot < cap
        used += (hot * kept[..., j, None]).sum(1)
    return kept


def route(cfg: dict, xg, router, precision: str):
    """xg [G, g, D] -> (experts [G, g, k], weights [G, g, k], kept
    [G, g, k]): the top-k of the router's softmax, their probabilities
    over their sum, and the choices that fit their expert's capacity."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(linear(xg, router, precision), dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    top_p = probs.gather(-1, top_i)
    w = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_i, w, keep(cfg, top_i)


def moe(cfg: dict, W, i: int, h, precision: str):
    """The MoE FFN of layer i on h [S, D]."""
    S, D = h.shape
    g = min(cfg["semantics"]["group_size"], S)
    n = -(-S // g) * g
    xg = torch.cat([h, h.new_zeros((n - S, D))]).reshape(n // g, g, D)
    top_i, w, kept = route(cfg, xg, W.layer("layers.*.moe.router", i),
                           precision)
    xf, top_i, w, kept = (t.reshape((n,) + t.shape[2:])
                          for t in (xg, top_i, w, kept))
    out = torch.zeros_like(xf)
    gate, up = W.layer("layers.*.moe.w_gate", i), \
        W.layer("layers.*.moe.w_up", i)
    down = W.layer("layers.*.moe.w_down", i)
    for e in range(cfg["num_experts"]):
        tok, choice = torch.nonzero((top_i == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = xf[tok]
        y = linear(silu(linear(rows, gate[e], precision))
                   * linear(rows, up[e], precision), down[e], precision)
        out.index_add_(0, tok, y * w[tok, choice][:, None])
    return out[:S]


@torch.no_grad()
def last_logits(cfg: dict, W, tokens, precision: str = "float32"):
    """tokens [S] -> the last position's logits [vocab], float32."""
    D, H, K, hd, E, k, F_, V, L = dims(cfg)
    eps, theta = cfg["semantics"]["norm_eps"], cfg["rope_theta"]
    x = hold(W.kinds["embed.tok"][tokens].float(), precision)
    S = x.shape[0]
    for i in range(L):
        h = rmsnorm(x, W.layer("layers.*.ln1.w", i), eps)
        q = linear(h, W.layer("layers.*.attn.wq", i), precision)
        kk = linear(h, W.layer("layers.*.attn.wk", i), precision)
        v = linear(h, W.layer("layers.*.attn.wv", i), precision)
        o = causal_attention(rope(q.view(S, H, hd), theta),
                             rope(kk.view(S, K, hd), theta), v.view(S, K, hd))
        x = hold(x + linear(o.reshape(S, H * hd),
                            W.layer("layers.*.attn.wo", i), precision),
                 precision)
        x = hold(x + moe(cfg, W, i, rmsnorm(
            x, W.layer("layers.*.ln2.w", i), eps), precision), precision)
    h = rmsnorm(x[-1:], W.kinds["final_norm.w"], eps)
    return linear(h, W.kinds["lm_head"], precision)[0]
