"""Public wrapper around the fused bulk decide kernel — the bulk twin of
:mod:`.ops`: a CUDA tensor launches the hand-written kernel
(:mod:`.bulk_kernel`), a CPU tensor runs the plain PyTorch version
(:mod:`.bulk_ref`), and nothing falls back.  ``bulk_decide_np`` is the
numpy-in, numpy-out host entry with the JAX reference's signature.
"""
from __future__ import annotations

import numpy as np
import torch

from .bulk_kernel import bulk_decide_kernel
from .bulk_np import bulk_decide_ref_np
from .bulk_ref import bulk_decide_ref
from .ops import _on, as_inputs, resolve_device
from .ref_np import NO_CAP, NO_CONC


def _fill(R: int, W: int, strat, warm):
    if strat is None:
        strat = np.zeros((R,), np.int32)
    if warm is None:
        warm = np.zeros((R, W), np.int32)
    return strat, warm


def bulk_decide(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                cap_pct=None, max_conc=None, strat=None, warm=None):
    """Fused bulk decide on ``occ``'s device: ``(valid[R, W] bool,
    score[R, W] f32, winner[R] i32)`` with ``winner == -1`` when a row has
    no valid worker — the CUDA kernel for a CUDA ``occ``, the plain version
    for a CPU one."""
    device = occ.device if isinstance(occ, torch.Tensor) else \
        torch.device("cpu")
    args = as_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                     cap_pct, max_conc, device)
    W = args[0].shape[0]
    R = args[1].shape[0]
    strat, warm = _fill(R, W, strat, warm)
    strat = _on(strat, torch.int32, device)
    warm = _on(warm, torch.int32, device)
    if warm.shape != (R, W):
        warm = torch.broadcast_to(warm, (R, W)).contiguous()
    if device.type == "cuda":
        return bulk_decide_kernel(*args, strat, warm)
    if device.type == "cpu":
        return bulk_decide_ref(*args, strat, warm)
    raise ValueError(f"unsupported device {device}: 'cuda' or 'cpu'")


def bulk_decide_np(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                   cap_pct=None, max_conc=None, strat=None, warm=None, *,
                   backend: str = "torch", device="cuda"):
    """Host-side convenience: numpy in/out.  ``backend="torch"`` computes
    the float32 encoding on ``device`` (bit-identical to the JAX
    reference's ``ref`` backend); ``backend="np"`` runs the exact-arithmetic
    (float64 score) twin the session's ``np`` backend uses."""
    R = np.asarray(aff).shape[0]
    W = np.asarray(occ).shape[0]
    if backend == "np":
        if cap_pct is None:
            cap_pct = np.full((R,), NO_CAP, np.float32)
        if max_conc is None:
            max_conc = np.full((R,), NO_CONC, np.int32)
        strat, warm = _fill(R, W, strat, warm)
        return bulk_decide_ref_np(
            occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct,
            max_conc, strat, warm)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}: 'torch' or 'np'")
    dev = resolve_device(device)
    valid, score, winner = bulk_decide(
        _on(occ, torch.int32, dev), aff, wmask, mem_used, max_mem, n_funcs,
        f_mem, cap_pct, max_conc, strat, warm)
    return valid.cpu().numpy(), score.cpu().numpy(), winner.cpu().numpy()
