"""Model / shape configuration dataclasses shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1  # MoE replaces the FFN on layers where (idx % k == k-1)
    dense_residual: bool = False  # arctic: dense FFN in parallel with the MoE
    capacity_factor: float = 1.25
    group_size: int = 512  # GShard-style dispatch group length (tokens)
    # gshard: groups with a capacity (above), the top-k weights divided by
    # their sum; dropless: every choice served through per-expert row
    # blocks, weighted by the softmax as it is (jamba as published)
    dispatch: str = "gshard"


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default d_model // 16
    inner_norm: bool = False  # jamba: weighted RMS norms on dt, B and C

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None  # gemma3: different theta for global layers
    sliding_window: Optional[int] = None  # local-attention window
    local_global_period: Optional[Tuple[int, int]] = None  # (n_local, period)
    attn_every: Optional[int] = None  # hybrid: 1 attn layer per `attn_every` layers
    attn_offset: int = 0  # hybrid: period position of the attention layer
    pos_emb: str = "rope"  # rope | none (jamba: no positional encoding)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    enc_layers: int = 0  # encoder-decoder: encoder depth (n_layers = decoder depth)
    frontend: Optional[str] = None  # None | audio | vision
    frontend_dim: int = 0  # raw feature dim produced by the (stub) frontend
    n_patches: int = 256  # vlm: patch tokens prepended to the text sequence
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # -- runtime knobs (tuned per §Perf) -------------------------------------- #
    remat: str = "full"  # full | none | ssm_out (save scan outputs only)
    attn_impl: str = "chunked"  # chunked | chunked2d | flash | direct
    attn_tp: str = "auto"  # auto (XLA picks) | head (q sharded on heads, k/v replicated)
    attn_chunk: int = 512  # kv chunk for memory-efficient attention
    attn_q_block: int = 2048  # q block for chunked2d
    seq_shard_acts: bool = False  # Megatron-style SP on inter-block activations
    kv_dtype: str = "model"  # model | int8 (quantised decode KV cache)
    decode_buffer: int = 0  # paged-append KV: read-only main cache + N-slot buffer
    scan_chunk: int = 256  # ssm chunk length
    ssm_scan_dtype: str = "float32"  # float32 | bfloat16 (assoc-scan intermediates)
    loss_chunk: int = 8192  # CE-loss token chunk (bounds logits materialisation)
    causal_block_skip: bool = False  # §Perf: skip fully-masked kv blocks (trades HLO size)

    # ---- derived ------------------------------------------------------------- #

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        """Layer-pattern period (the scan group width P)."""
        if self.local_global_period is not None:
            return self.local_global_period[1]
        if self.attn_every is not None:
            return self.attn_every
        if self.moe is not None and self.moe.every_k_layers > 1:
            return self.moe.every_k_layers
        return 1

    @property
    def n_groups(self) -> int:
        """Full scan groups; a remainder of ``n_layers % period`` layers runs
        unrolled as a tail (gemma3: 34 = 5*6 + 4 local tail layers)."""
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers % self.period

    def layer_kind(self, p: int) -> str:
        """Kind of sub-layer at position ``p`` of a period: attn|local|mamba."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_every is not None:  # hybrid: attention at attn_offset
            return "attn" if p == self.attn_offset else "mamba"
        if self.local_global_period is not None:
            n_local, _ = self.local_global_period
            return "local" if p < n_local else "attn"
        return "attn"

    def ffn_kind(self, p: int) -> str:
        """moe | dense | moe+dense for the FFN at period position ``p``."""
        if self.moe is None:
            return "dense"
        k = self.moe.every_k_layers
        is_moe = (p % k) == (k - 1)
        if not is_moe:
            return "dense"
        return "moe+dense" if self.moe.dense_residual else "moe"

    def reduced(self, *, seed_dims: bool = True) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        period = self.period
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                group_size=64,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=4, dt_rank=8)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * period,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=512,
            enc_layers=2 if self.enc_layers else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            n_patches=8,
            sliding_window=16 if self.sliding_window else None,
            moe=moe,
            ssm=ssm,
            attn_chunk=32,
            scan_chunk=16,
            loss_chunk=256,
            dtype="float32",
        )


# --------------------------------------------------------------------------- #
# input shapes (assigned per-arch shape set)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid/mostly-local.
LONG_CONTEXT_OK = {"gemma3-4b", "falcon-mamba-7b", "jamba-1.5-large-398b"}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""


# --------------------------------------------------------------------------- #
# parameter counting (for MODEL_FLOPS = 6 N D)
# --------------------------------------------------------------------------- #


def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total params, active params per token) — active differs for MoE."""
    D, V = cfg.d_model, cfg.vocab
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads

    def attn_params() -> int:
        p = D * H * hd + 2 * D * K * hd + H * hd * D
        if cfg.qkv_bias:
            p += H * hd + 2 * K * hd
        return p

    def dense_ffn(ff: int) -> int:
        if cfg.mlp_type == "swiglu":
            return 3 * D * ff
        return 2 * D * ff

    def mamba_params() -> int:
        s = cfg.ssm or SSMSpec()
        di = s.expand * D
        dtr = s.resolved_dt_rank(D)
        return (
            D * 2 * di  # in_proj
            + di * s.conv_dim  # depthwise conv
            + di * (dtr + 2 * s.d_state)  # x_proj
            + dtr * di + di  # dt_proj (+bias)
            + di * s.d_state  # A_log
            + di  # D skip
            + di * D  # out_proj
            + ((dtr + 2 * s.d_state) if s.inner_norm else 0)  # dt, B, C norms
        )

    total = 0
    active = 0
    n_dec = cfg.n_layers
    for layer in range(n_dec):
        p = layer % cfg.period
        kind = cfg.layer_kind(p)
        if kind in ("attn", "local"):
            total += attn_params(); active += attn_params()
        else:
            total += mamba_params(); active += mamba_params()
        fk = cfg.ffn_kind(p)
        if fk == "dense":
            total += dense_ffn(cfg.d_ff); active += dense_ffn(cfg.d_ff)
        else:
            m = cfg.moe
            expert = dense_ffn(m.d_ff_expert)
            total += m.n_experts * expert + D * m.n_experts
            active += m.top_k * expert + D * m.n_experts
            if fk == "moe+dense":
                total += dense_ffn(cfg.d_ff); active += dense_ffn(cfg.d_ff)
        total += 2 * D; active += 2 * D  # norms

    # encoder stack (dense attention + ffn, bidirectional) + decoder cross-attn
    for _ in range(cfg.enc_layers):
        total += attn_params() + dense_ffn(cfg.d_ff) + 2 * D
        active += attn_params() + dense_ffn(cfg.d_ff) + 2 * D
    if cfg.enc_layers:
        cross = n_dec * (attn_params() + D)
        total += cross; active += cross

    emb = V * D
    total += emb; active += emb
    if not cfg.tie_embeddings:
        total += emb; active += emb
    if cfg.frontend == "vision":
        proj = cfg.frontend_dim * D + D * D
        total += proj; active += proj
    if cfg.frontend == "audio":
        proj = cfg.frontend_dim * D
        total += proj; active += proj
    total += D; active += D  # final norm
    return int(total), int(active)
