"""Public wrapper around the affinity kernel: dtype/device placement and the
route by device.  A CUDA tensor launches the hand-written kernel
(:mod:`.kernel`); a CPU tensor runs the plain PyTorch version (:mod:`.ref`).
Nothing falls back: a CUDA launch that fails raises.

``affinity_valid_np`` is the numpy-in, numpy-out host entry with the JAX
reference's signature; its ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``) says where the float32 work runs, and ``backend="np"`` runs the
pure-numpy twin (:mod:`.ref_np`) instead.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import affinity_valid_kernel
from .ref import affinity_valid_ref
from .ref_np import NO_CAP, NO_CONC, affinity_valid_ref_np


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present — the port never moves work to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' for the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: 'cuda' or 'cpu'")
    return dev


_NP = {torch.int32: np.int32, torch.int8: np.int8, torch.bool: np.bool_,
       torch.float32: np.float32}


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One input as a contiguous tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=_NP[dtype])).to(
        device)


def as_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct,
              max_conc, device):
    """The validity inputs as the kernels take them, on ``device``; absent
    capacity/concurrency rules become the ``NO_CAP``/``NO_CONC``
    sentinels."""
    occ = _on(occ, torch.int32, device)
    aff = _on(aff, torch.int8, device)
    W, T = occ.shape
    F = aff.shape[0]
    if aff.shape[1] != T:
        raise ValueError(f"tag axes differ: occ {T}, aff {aff.shape[1]}")
    if cap_pct is None:
        cap_pct = np.full((F,), NO_CAP, np.float32)
    if max_conc is None:
        max_conc = np.full((F,), NO_CONC, np.int32)
    return (occ, aff, _on(wmask, torch.bool, device),
            _on(mem_used, torch.float32, device),
            _on(max_mem, torch.float32, device),
            _on(n_funcs, torch.int32, device),
            _on(f_mem, torch.float32, device),
            _on(cap_pct, torch.float32, device),
            _on(max_conc, torch.int32, device))


def affinity_valid(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                   cap_pct=None, max_conc=None) -> torch.Tensor:
    """Batched Listing-1 ``valid()``: ``valid[F, W]`` (bool) on ``occ``'s
    device — the CUDA kernel for a CUDA ``occ``, the plain version for a
    CPU one.  Inputs may be tensors or arrays; they are moved to ``occ``'s
    device and cast to the kernel's dtypes."""
    device = occ.device if isinstance(occ, torch.Tensor) else \
        torch.device("cpu")
    args = as_inputs(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                     cap_pct, max_conc, device)
    if device.type == "cuda":
        return affinity_valid_kernel(*args)
    if device.type == "cpu":
        return affinity_valid_ref(*args)
    raise ValueError(f"unsupported device {device}: 'cuda' or 'cpu'")


def affinity_valid_np(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                      cap_pct=None, max_conc=None, *, backend: str = "torch",
                      device="cuda") -> np.ndarray:
    """Host-side convenience: numpy in/out.  ``backend="torch"`` computes in
    float32 on ``device`` (the kernel on ``"cuda"``, the plain version on
    ``"cpu"``) — bit-identical to the JAX reference's ``ref`` backend;
    ``backend="np"`` runs the pure-numpy twin on the host."""
    if backend == "np":
        F = np.asarray(aff).shape[0]
        if cap_pct is None:
            cap_pct = np.full((F,), NO_CAP, np.float32)
        if max_conc is None:
            max_conc = np.full((F,), NO_CONC, np.int32)
        return affinity_valid_ref_np(
            occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct,
            max_conc)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}: 'torch' or 'np'")
    dev = resolve_device(device)
    occ_t = _on(occ, torch.int32, dev)
    return affinity_valid(occ_t, aff, wmask, mem_used, max_mem, n_funcs,
                          f_mem, cap_pct, max_conc).cpu().numpy()
