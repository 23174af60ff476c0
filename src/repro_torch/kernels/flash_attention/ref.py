"""The plain PyTorch version of the flash-attention kernel: direct
softmax(QK^T)V with causal / sliding-window masks and GQA head grouping, on
contiguous positions from 0 (the maths of
:func:`repro_torch.models.attention.attention_direct`).  The CPU path and
the yardstick the kernel is held to on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attention_direct


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    Sq, Skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    return attention_direct(q, k, v, q_pos, kv_pos, causal=causal,
                            window=window)
