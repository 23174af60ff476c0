"""Plain reference of Jamba (AI21-Jamba2-Mini, ``transformers``'
``modeling_jamba.py``): one prompt to its last position's logits, in
float32.

Layer i sits at position p = i mod ``attn_layer_period`` of its period.
On x [S, D]:

    h = rmsnorm(x) * w_ln1
    x = x + (attention(h) if p == attn_layer_offset else mixer(h))
    h = rmsnorm(x) * w_ln2
    x = x + (moe(h) if i mod expert_layer_period == expert_layer_offset
             else mlp(h))

then rmsnorm and the LM head at the last position.

* ``attention``: causal grouped-query attention with no positional
  encoding at all (``moe_transformer.causal_attention``);
* ``mixer``: the Mamba-1 block of ``mamba.py``, with Jamba's RMS norms with
  weights on dt's low-rank input, B and C right after ``x_proj``
  (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``);
* ``moe``: a float32 softmax over all experts of the router's logits, the
  top-k (the lower index first among equal probabilities), their
  probabilities as they are (not divided by their sum); each expert's
  SwiGLU on the rows routed to it, its weights widened one expert at a
  time, weighted and added; nothing is dropped;
* ``mlp``: the dense SwiGLU.

Every norm takes ``rms_norm_eps``.  The program lays its parameters out
layer by layer, and the kinds of layer interleave, so every leaf is one
layer's: ``layers.<i>.<part>``.
"""
from __future__ import annotations

import math

import torch

from bench.harness.weights import Leaf
from bench.reference.common import hold, linear, rmsnorm, silu, softplus
from bench.reference.mamba import causal_conv, selective_scan
from bench.reference.moe_transformer import causal_attention


def dims(cfg: dict):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(D=D, H=H, K=cfg["num_key_value_heads"], hd=D // H,
                E=cfg["num_experts"], k=cfg["num_experts_per_tok"],
                F=cfg["intermediate_size"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"], di=cfg["mamba_expand"] * D,
                N=cfg["mamba_d_state"], R=cfg["mamba_dt_rank"],
                kw=cfg["mamba_d_conv"])


def is_attention(cfg: dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def has_experts(cfg: dict, i: int) -> bool:
    return i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]


def leaves(cfg: dict):
    """The weights, by the names the program's layout gives them, in the
    types it serves them in (the router in float32)."""
    d = dims(cfg)
    D, H, K, hd, E, F_, di, N, R, kw = (d[n] for n in (
        "D", "H", "K", "hd", "E", "F", "di", "N", "R", "kw"))
    dt = cfg["torch_dtype"]
    norm = {"around": [1.0, 0.1]}
    lo, hi = cfg["assumed"]["time_step_min"], cfg["assumed"]["time_step_max"]
    out = [Leaf("embed.tok", (d["V"], D), 1, dt, {"normal": 1.0})]
    for i in range(d["L"]):
        def leaf(part, shape, init, dtype=dt):
            out.append(Leaf(f"layers.{i}.{part}", shape, 1, dtype, init))

        leaf("ln1.w", (D,), norm)
        leaf("ln2.w", (D,), norm)
        if is_attention(cfg, i):
            leaf("attn.wq", (D, H * hd), {"normal": D ** -0.5})
            leaf("attn.wk", (D, K * hd), {"normal": D ** -0.5})
            leaf("attn.wv", (D, K * hd), {"normal": D ** -0.5})
            leaf("attn.wo", (H * hd, D), {"normal": (H * hd) ** -0.5})
        else:
            leaf("ssm.in_proj", (D, 2 * di), {"normal": D ** -0.5})
            leaf("ssm.conv_w", (di, kw), {"normal": kw ** -0.5})
            leaf("ssm.conv_b", (di,), {"normal": 0.1})
            leaf("ssm.x_proj", (di, R + 2 * N), {"normal": di ** -0.5})
            leaf("ssm.dt_w", (R, di), {"normal": R ** -0.5})
            leaf("ssm.dt_b", (di,), {"dt_bias": [lo, hi]})
            leaf("ssm.a_log", (di, N), {"log_arange": N}, "float32")
            leaf("ssm.d_skip", (di,), {"around": [1.0, 0.1]}, "float32")
            leaf("ssm.out_proj", (di, D), {"normal": di ** -0.5})
            leaf("ssm.dt_norm", (R,), norm)
            leaf("ssm.b_norm", (N,), norm)
            leaf("ssm.c_norm", (N,), norm)
        if has_experts(cfg, i):
            leaf("moe.router", (D, E), {"normal": D ** -0.5}, "float32")
            leaf("moe.w_gate", (E, D, F_), {"normal": D ** -0.5})
            leaf("moe.w_up", (E, D, F_), {"normal": D ** -0.5})
            leaf("moe.w_down", (E, F_, D), {"normal": F_ ** -0.5})
        else:
            leaf("mlp.w_gate", (D, F_), {"normal": D ** -0.5})
            leaf("mlp.w_up", (D, F_), {"normal": D ** -0.5})
            leaf("mlp.w_down", (F_, D), {"normal": F_ ** -0.5})
    out += [Leaf("final_norm.w", (D,), 1, dt, norm),
            Leaf("lm_head", (D, d["V"]), 1, dt, {"normal": D ** -0.5})]
    return out


# --------------------------------------------------------------------------- #
# the benchmark's arithmetic (harness/flops.py, the expert reader)
# --------------------------------------------------------------------------- #


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token goes through, the LM head apart: each
    layer's mixer (the Mamba block's four matrices, or the attention's
    projections) and its FFN (the router and its top-k experts' three
    matrices, or the dense SwiGLU)."""
    d = dims(cfg)
    D, H, K, hd, di, R, N, F_ = (d[n] for n in (
        "D", "H", "K", "hd", "di", "R", "N", "F"))
    mamba = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    total = 0
    for i in range(d["L"]):
        total += attn if is_attention(cfg, i) else mamba
        total += (D * d["E"] + d["k"] * 3 * D * F_ if has_experts(cfg, i)
                  else 3 * D * F_)
    return total


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attention_shape(cfg: dict):
    """(attention layers, query heads, head dim)."""
    d = dims(cfg)
    return (sum(is_attention(cfg, i) for i in range(d["L"])), d["H"],
            d["hd"])


def moe_layers(cfg: dict) -> int:
    """MoE FFN calls in one prefill: one per expert layer."""
    return sum(has_experts(cfg, i) for i in range(cfg["num_hidden_layers"]))


def scan_layers(cfg: dict) -> int:
    """Selective-scan calls in one prefill: one a Mamba layer."""
    return sum(not is_attention(cfg, i)
               for i in range(cfg["num_hidden_layers"]))


def scan_bytes(cfg: dict, S: int) -> int:
    """Bytes one selective-scan call over S steps must move, counted as
    ``mamba.scan_bytes`` counts them: dt [S, di] float32, x [S, di]
    bfloat16, B and C [S, N] bfloat16 and a [di, N] float32 read once, y
    [S, di] float32 written once."""
    d = dims(cfg)
    di, N = d["di"], d["N"]
    return S * di * 4 + S * di * 2 + 2 * S * N * 2 + di * N * 4 + S * di * 4


def expert_flops(cfg: dict, S: int) -> float:
    """Useful FLOPs of one MoE layer's expert products over S tokens: k
    choices a token, each through an expert's three matrices."""
    d = dims(cfg)
    return 2.0 * S * d["k"] * 3 * d["D"] * d["F"]


def expert_bytes(cfg: dict, S: int) -> float:
    """Bytes one MoE layer's expert products must move over S tokens, in
    the served type: the weights of every expert the tokens reach (as many
    as k uniform choices a token reach on average, which is all of them
    for S of a few dozen and more), read once, and the routed rows read
    and the results written once."""
    d = dims(cfg)
    E, k = d["E"], d["k"]
    size = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["torch_dtype"]]
    reached = E * (1.0 - (1.0 - k / E) ** S)
    return size * (reached * 3 * d["D"] * d["F"] + 2 * S * k * d["D"])


# --------------------------------------------------------------------------- #
# the forward pass
# --------------------------------------------------------------------------- #


def _w(W, i: int, part: str):
    return W.kinds[f"layers.{i}.{part}"]


def attention(cfg: dict, W, i: int, h, precision: str):
    d = dims(cfg)
    S, H, K, hd = h.shape[0], d["H"], d["K"], d["hd"]
    q = linear(h, _w(W, i, "attn.wq"), precision).view(S, H, hd)
    k = linear(h, _w(W, i, "attn.wk"), precision).view(S, K, hd)
    v = linear(h, _w(W, i, "attn.wv"), precision).view(S, K, hd)
    o = causal_attention(q, k, v)
    return linear(o.reshape(S, H * hd), _w(W, i, "attn.wo"), precision)


def mixer(cfg: dict, W, i: int, h, precision: str):
    d = dims(cfg)
    di, N, R = d["di"], d["N"], d["R"]
    eps = cfg["semantics"]["norm_eps"]
    xz = linear(h, _w(W, i, "ssm.in_proj"), precision)
    xr, z = xz[:, :di], xz[:, di:]
    xc = silu(causal_conv(xr, _w(W, i, "ssm.conv_w"),
                          _w(W, i, "ssm.conv_b")))
    dt_r, B, C = linear(xc, _w(W, i, "ssm.x_proj"), precision).split(
        [R, N, N], dim=-1)
    dt_r = rmsnorm(dt_r, _w(W, i, "ssm.dt_norm"), eps)
    B = rmsnorm(B, _w(W, i, "ssm.b_norm"), eps)
    C = rmsnorm(C, _w(W, i, "ssm.c_norm"), eps)
    dt = softplus(linear(dt_r, _w(W, i, "ssm.dt_w"), precision)
                  + _w(W, i, "ssm.dt_b").float())
    a = -torch.exp(_w(W, i, "ssm.a_log").float())
    y = selective_scan(dt, xc, B, C, a)
    y = y + _w(W, i, "ssm.d_skip").float() * xc
    return linear(y * silu(z), _w(W, i, "ssm.out_proj"), precision)


def swiglu(h, gate, up, down, precision: str):
    return linear(silu(linear(h, gate, precision))
                  * linear(h, up, precision), down, precision)


def route(cfg: dict, h, router, precision: str):
    """h [S, D] -> (experts [S, k], weights [S, k]): the top-k of the
    router's softmax, the lower index first among equal probabilities, and
    their probabilities as they are."""
    probs = torch.softmax(linear(h, router, precision), dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True)[1][:, :cfg["num_experts_per_tok"]]
    return top_i, probs.gather(-1, top_i)


def moe(cfg: dict, W, i: int, h, precision: str):
    """The MoE FFN of layer i on h [S, D]."""
    top_i, w = route(cfg, h, _w(W, i, "moe.router"), precision)
    gate, up = _w(W, i, "moe.w_gate"), _w(W, i, "moe.w_up")
    down = _w(W, i, "moe.w_down")
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        tok, choice = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], gate[e], up[e], down[e], precision)
        out.index_add_(0, tok, y * w[tok, choice][:, None])
    return out


@torch.no_grad()
def last_logits(cfg: dict, W, tokens, precision: str = "float32"):
    """tokens [S] -> the last position's logits [vocab], float32."""
    eps = cfg["semantics"]["norm_eps"]
    x = hold(W.kinds["embed.tok"][tokens].float(), precision)
    for i in range(cfg["num_hidden_layers"]):
        h = rmsnorm(x, _w(W, i, "ln1.w"), eps)
        mix = attention if is_attention(cfg, i) else mixer
        x = hold(x + mix(cfg, W, i, h, precision), precision)
        h = rmsnorm(x, _w(W, i, "ln2.w"), eps)
        if has_experts(cfg, i):
            y = moe(cfg, W, i, h, precision)
        else:
            y = swiglu(h, _w(W, i, "mlp.w_gate"), _w(W, i, "mlp.w_up"),
                       _w(W, i, "mlp.w_down"), precision)
        x = hold(x + y, precision)
    h = rmsnorm(x[-1:], W.kinds["final_norm.w"], eps)
    return linear(h, W.kinds["lm_head"], precision)[0]
