"""Architecture registry: the 10 assigned configs, selectable via ``--arch``.

Every config follows the assignment sheet exactly; where a derived quantity is
needed (head_dim, d_inner, ...) the derivation is noted inline with its source
tier.  ``reduced()`` variants power the CPU smoke tests.
"""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, MoESpec, SSMSpec

# --------------------------------------------------------------------------- #
# dense LMs
# --------------------------------------------------------------------------- #

GEMMA3_4B = ModelConfig(
    # [hf:google/gemma-3-4b-pt; unverified] 5:1 local:global, window 1024,
    # head_dim 256 (HF config; 2560/8=320 would be MXU-hostile), global rope 1e6.
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    sliding_window=1024, local_global_period=(5, 6),
    rope_theta=1e4, rope_theta_global=1e6,
    tie_embeddings=True,
)

STARCODER2_15B = ModelConfig(
    # [arXiv:2402.19173; hf] GQA kv=4, RoPE, LayerNorm + non-gated GELU MLP.
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    norm_type="layernorm", mlp_type="gelu", qkv_bias=True, rope_theta=1e5,
)

QWEN15_110B = ModelConfig(
    # [hf:Qwen/Qwen1.5-110B; hf] QKV bias.
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
)

QWEN15_32B = ModelConfig(
    # [hf:Qwen/Qwen1.5-32B; hf] QKV bias, kv=40 (MHA-like).
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
)

# --------------------------------------------------------------------------- #
# SSM / hybrid
# --------------------------------------------------------------------------- #

FALCON_MAMBA_7B = ModelConfig(
    # [arXiv:2410.05355; unverified] mamba1, attn-free; d_inner = 2*d_model,
    # d_state=16, dt_rank = d_model/16 = 256.
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    ssm=SSMSpec(d_state=16, conv_dim=4, expand=2),
)

JAMBA_15_LARGE = ModelConfig(
    # [arXiv:2403.19887; hf] 1:7 attn:mamba interleave (period 8, attn first),
    # MoE 16e top-2 every other layer; dense FFN d_ff=24576 on non-MoE layers.
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    attn_every=8,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2),
    ssm=SSMSpec(d_state=16, conv_dim=4, expand=2),
)

# --------------------------------------------------------------------------- #
# enc-dec (audio) / VLM
# --------------------------------------------------------------------------- #

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    # [arXiv:2308.11596; hf] enc-dec backbone only; audio frontend is a stub
    # providing 1024-d frame embeddings (frontend_dim below).
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    frontend="audio", frontend_dim=1024,
    norm_type="layernorm", mlp_type="gelu",
)

INTERNVL2_76B = ModelConfig(
    # [arXiv:2404.16821; unverified] InternLM2-76B-ish backbone; InternViT
    # frontend is a stub providing 3200-d patch features, projected via
    # 2-layer MLP; 256 patch tokens prepended.
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    frontend="vision", frontend_dim=3200, n_patches=256,
    rope_theta=1e6,
)

# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #

ARCTIC_480B = ModelConfig(
    # [hf:Snowflake/snowflake-arctic-base; hf] 128 experts top-2 with a dense
    # residual FFN in parallel (dense d_ff = expert d_ff = 4864 per sheet).
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    moe=MoESpec(n_experts=128, top_k=2, d_ff_expert=4864, every_k_layers=1,
                dense_residual=True),
)

QWEN3_MOE_30B = ModelConfig(
    # [hf:Qwen/Qwen3-30B-A3B; hf] 128 experts top-8, per-expert d_ff 768.
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=768, every_k_layers=1),
    rope_theta=1e6,
)


ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        GEMMA3_4B, STARCODER2_15B, QWEN15_110B, QWEN15_32B, FALCON_MAMBA_7B,
        JAMBA_15_LARGE, SEAMLESS_M4T_LARGE_V2, INTERNVL2_76B, ARCTIC_480B,
        QWEN3_MOE_30B,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
