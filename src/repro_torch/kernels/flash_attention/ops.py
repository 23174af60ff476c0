"""Public flash-attention entry: the route by device and the model-facing
signature.  A CUDA tensor launches the hand-written kernel for its dtype
(:func:`.kernel.choose_kernel`); a CPU tensor, or ``backend="ref"``, runs
the plain PyTorch version (:mod:`.ref`).  Nothing falls back: a CUDA launch
that fails raises."""
from __future__ import annotations

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, q_pos=None, kv_pos=None, *, causal=True,
                    window=None, backend="auto"):
    """q [B,Sq,H,hd], k/v [B,Skv,K,hd] -> [B,Sq,H,hd].

    ``q_pos``/``kv_pos`` are accepted for signature parity with
    :func:`repro_torch.models.attention.attention`; the kernel assumes
    contiguous positions starting at 0 (the only case the prefill path
    produces).  Nothing is padded: the kernel masks the ragged edges.
    """
    if backend == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}: 'auto' or 'ref'")
    if q.device.type == "cuda":
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}: 'cuda' or 'cpu'")
