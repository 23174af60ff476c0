"""The benchmark's own count of the work a request needs, from the
configuration's published sizes and never from the program: the yardstick
of ``mfu.prefill``, ``scan_roofline`` and ``flash_roofline``.

A prefill of S prompt tokens needs

* 2 FLOPs per multiply-add of every matrix a token goes through: the
  family's active matrix parameters per token (``reference/<family>.py``
  ``matmul_params``) times S, and the LM head once, for the last position
  whose logits the first token needs;
* causal attention's useful FLOPs in each attention layer: q k^T and p v
  over the S (S + 1) / 2 query-key pairs the mask keeps, 2 x 2 x hd FLOPs
  a pair and head.

The embedding is a lookup, and norms, activations, the scan's recurrence
and the routing's softmax are not matrix work: none of them is counted.
"""
from __future__ import annotations

from types import ModuleType

from . import peaks


def causal_attention_flops(S: int, heads: int, head_dim: int) -> float:
    """Useful FLOPs of one causal attention call over S positions."""
    return 4.0 * heads * head_dim * S * (S + 1) / 2


def prefill_flops(family: ModuleType, cfg: dict, S: int) -> float:
    """Useful FLOPs of one prefill of S tokens through the whole model."""
    layers, heads, head_dim = family.attention_shape(cfg)
    return (2.0 * family.matmul_params(cfg) * S
            + 2.0 * family.head_params(cfg)
            + layers * causal_attention_flops(S, heads, head_dim))


def flash_bound_s(S: int, heads: int, head_dim: int) -> float:
    """The least time one causal bf16 attention call can take: its useful
    FLOPs at the bf16 peak."""
    return causal_attention_flops(S, heads, head_dim) / peaks.BF16_FLOPS


def scan_bound_s(family: ModuleType, cfg: dict, S: int) -> float:
    """The least time one selective-scan call over S steps can take: its
    inputs read once and its output written once at the HBM rate."""
    return family.scan_bytes(cfg, S) / peaks.HBM_BYTES
