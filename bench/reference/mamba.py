"""Plain reference of a Mamba-1 language model (falcon-mamba-7b): the
forward pass of one prompt to its last position's logits, in float32.

Per layer, on x [S, D]:

    h        = rmsnorm(x) * w_ln1
    xr, z    = split(h @ in_proj)                     # [S, di] each
    xc       = silu(causal depthwise conv(xr) + conv_b)   # kernel kw
    dt_r, B, C = split(xc @ x_proj)                   # [S, R], [S, N], [S, N]
    dt       = softplus(dt_r @ dt_w + dt_b)           # [S, di]
    a        = -exp(a_log)                            # [di, N]
    h_t      = exp(dt_t a) * h_{t-1} + (dt_t x_t) B_t # the selective scan
    y_t      = h_t . C_t + d_skip * xc_t
    x        = x + (y * silu(z)) @ out_proj

then rmsnorm and the LM head at the last position.  The configuration's
``semantics`` name the program's choices where they depart from the
published model (the norms' epsilon; no RMS norm on B, C and dt).  The
scan runs in chunks: within a chunk step by step for all chunks at once,
then the carries across chunks, then each chunk's share of its carry-in.
"""
from __future__ import annotations

import torch

from bench.harness.weights import Leaf
from bench.reference.common import hold, linear, rmsnorm, silu, softplus

#: steps of a scan chunk
CHUNK = 32


def dims(cfg: dict):
    return (cfg["hidden_size"], cfg["intermediate_size"], cfg["state_size"],
            cfg["time_step_rank"], cfg["conv_kernel"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def leaves(cfg: dict):
    """The weights, by the names the program's layout gives them, in the
    types it serves them in.  The program lays a second norm and a
    zero-width FFN after each mixer; the norm has no effect on the output
    and is drawn as ones."""
    D, di, N, R, kw, V, L = dims(cfg)
    dt = cfg["torch_dtype"]
    lo, hi = cfg["time_step_min"], cfg["time_step_max"]
    return [
        Leaf("embed.tok", (V, D), 1, dt, {"normal": 1.0}),
        Leaf("layers.*.ln1.w", (D,), L, dt, {"around": [1.0, 0.1]}),
        Leaf("layers.*.ln2.w", (D,), L, dt, {"ones": True}),
        Leaf("layers.*.ssm.in_proj", (D, 2 * di), L, dt, {"normal": D ** -0.5}),
        Leaf("layers.*.ssm.conv_w", (di, kw), L, dt, {"normal": kw ** -0.5}),
        Leaf("layers.*.ssm.conv_b", (di,), L, dt, {"normal": 0.1}),
        Leaf("layers.*.ssm.x_proj", (di, R + 2 * N), L, dt,
             {"normal": di ** -0.5}),
        Leaf("layers.*.ssm.dt_w", (R, di), L, dt, {"normal": R ** -0.5}),
        Leaf("layers.*.ssm.dt_b", (di,), L, dt, {"dt_bias": [lo, hi]}),
        Leaf("layers.*.ssm.a_log", (di, N), L, "float32", {"log_arange": N}),
        Leaf("layers.*.ssm.d_skip", (di,), L, "float32", {"around": [1.0, 0.1]}),
        Leaf("layers.*.ssm.out_proj", (di, D), L, dt, {"normal": di ** -0.5}),
        Leaf("final_norm.w", (D,), 1, dt, {"around": [1.0, 0.1]}),
        Leaf("lm_head", (D, V), 1, dt, {"normal": D ** -0.5}),
    ]


# --------------------------------------------------------------------------- #
# the benchmark's arithmetic (harness/flops.py)
# --------------------------------------------------------------------------- #


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token goes through, the LM head apart."""
    D, di, N, R, kw, V, L = dims(cfg)
    return L * (D * 2 * di + di * (R + 2 * N) + R * di + di * D)


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attention_shape(cfg: dict):
    """(attention layers, heads, head dim): none in this family."""
    return 0, 0, 0


def scan_layers(cfg: dict) -> int:
    """Selective-scan calls in one prefill: one a layer."""
    return cfg["num_hidden_layers"]


def scan_bytes(cfg: dict, S: int) -> int:
    """Bytes one selective-scan call over S steps must move: dt [S, di]
    float32, x [S, di] bfloat16, B and C [S, N] bfloat16 and a [di, N]
    float32 read once, y [S, di] float32 written once."""
    D, di, N, *_ = dims(cfg)
    return S * di * 4 + S * di * 2 + 2 * S * N * 2 + di * N * 4 + S * di * 4


# --------------------------------------------------------------------------- #
# the forward pass
# --------------------------------------------------------------------------- #


def causal_conv(x, w, b):
    """x [S, di], w [di, kw]: y_t = sum_i w[:, i] x_{t - kw + 1 + i} + b."""
    S, kw = x.shape[0], w.shape[1]
    xp = torch.cat([x.new_zeros((kw - 1, x.shape[1])), x])
    y = b.float().expand(S, -1).clone()
    for i in range(kw):
        y += xp[i:i + S] * w[:, i].float()
    return y


def selective_scan(dt, x, B, C, a):
    """y_t = h_t . C_t, h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, h_0 = 0;
    dt, x [S, di]; B, C [S, N]; a [di, N]; all float32."""
    S, di = dt.shape
    T = CHUNK
    n = -(-S // T)
    pad = n * T - S

    def chunks(t):  # [S, ...] -> [n, T, ...]; padded steps carry nothing
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        return t.reshape((n, T) + t.shape[1:])

    dt_c, x_c, B_c, C_c = (chunks(t) for t in (dt, x, B, C))
    h = x.new_zeros((n, di, a.shape[1]))
    y = x.new_zeros((n, T, di))
    for t in range(T):  # within each chunk, from a zero state
        h = torch.exp(dt_c[:, t, :, None] * a) * h \
            + (dt_c[:, t] * x_c[:, t])[:, :, None] * B_c[:, t, None, :]
        y[:, t] = torch.einsum("cdn,cn->cd", h, C_c[:, t])
    carry = [x.new_zeros(h.shape[1:])]  # the state entering each chunk
    decay = torch.exp(dt_c.sum(1)[:, :, None] * a)  # a chunk's whole decay
    for c in range(n - 1):
        carry.append(decay[c] * carry[-1] + h[c])
    carry = torch.stack(carry)
    p = torch.ones_like(h)
    for t in range(T):  # each step's share of its chunk's carry-in
        p = p * torch.exp(dt_c[:, t, :, None] * a)
        y[:, t] += torch.einsum("cdn,cn->cd", p * carry, C_c[:, t])
    return y.reshape(n * T, di)[:S]


def mixer(cfg: dict, W, i: int, h, precision: str):
    D, di, N, R, kw, V, L = dims(cfg)
    xz = linear(h, W.layer("layers.*.ssm.in_proj", i), precision)
    xr, z = xz[:, :di], xz[:, di:]
    xc = silu(causal_conv(xr, W.layer("layers.*.ssm.conv_w", i),
                          W.layer("layers.*.ssm.conv_b", i)))
    proj = linear(xc, W.layer("layers.*.ssm.x_proj", i), precision)
    dt_r, B, C = proj.split([R, N, N], dim=-1)
    dt = softplus(linear(dt_r, W.layer("layers.*.ssm.dt_w", i), precision)
                  + W.layer("layers.*.ssm.dt_b", i).float())
    a = -torch.exp(W.layer("layers.*.ssm.a_log", i).float())
    y = selective_scan(dt, xc, B, C, a)
    y = y + W.layer("layers.*.ssm.d_skip", i).float() * xc
    return linear(y * silu(z), W.layer("layers.*.ssm.out_proj", i),
                  precision)


@torch.no_grad()
def last_logits(cfg: dict, W, tokens, precision: str = "float32"):
    """tokens [S] -> the last position's logits [vocab], float32."""
    eps = cfg["semantics"]["norm_eps"]
    x = hold(W.kinds["embed.tok"][tokens].float(), precision)
    for i in range(cfg["num_hidden_layers"]):
        h = rmsnorm(x, W.layer("layers.*.ln1.w", i), eps)
        x = hold(x + mixer(cfg, W, i, h, precision), precision)
    h = rmsnorm(x[-1:], W.kinds["final_norm.w"], eps)
    return linear(h, W.kinds["lm_head"], precision)[0]
