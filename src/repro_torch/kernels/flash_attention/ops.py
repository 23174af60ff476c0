"""Public flash-attention entry: the route by device and the model-facing
signature.  A CUDA tensor launches the hand-written kernel for its dtype
(:func:`.kernel.choose_kernel`); a CPU tensor runs the plain PyTorch
version (:mod:`.ref`).  Nothing falls back: a CUDA launch that fails
raises.  The kernel has no backward, so an input that requires grad is
refused on both devices (:func:`..refuse_autograd`)."""
from __future__ import annotations

from .. import refuse_autograd
from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal=True, window=None):
    """q [B,Sq,H,hd], k/v [B,Skv,K,hd] -> [B,Sq,H,hd].

    The kernel takes contiguous positions from 0 (the only ones the prefill
    path produces), so it takes no ``q_pos``/``kv_pos``: a caller with other
    positions gets a ``TypeError``, not a wrong answer.  Nothing is padded:
    the kernel masks the ragged edges.
    """
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cuda":
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}: 'cuda' or 'cpu'")
