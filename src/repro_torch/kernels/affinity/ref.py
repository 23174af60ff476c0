"""Plain PyTorch version of the batched ``valid()`` matrix (Listing 1, lines
17-36, vectorized over F pending functions x W workers) — the float32 twin
of the JAX reference's ``ref.py`` and the yardstick the CUDA kernel
(:mod:`.kernel`) is held to, bit for bit.

Encoding
--------
* ``occ[W, T]``      int32   tag-occupancy counts per worker
* ``aff[F, T]``      int8    +1 affine, -1 anti-affine, 0 unconstrained
* ``wmask[F, W]``    bool    block's worker list (wildcard -> all alive)
* ``mem_used[W]``    f32     current memory per worker
* ``max_mem[W]``     f32     worker capacity (0 for dead/padded workers)
* ``n_funcs[W]``     i32     resident instance count
* ``f_mem[F]``       f32     memory demand of each pending function
* ``cap_pct[F]``     f32     block's capacity_used threshold in %, ``NO_CAP`` if absent
* ``max_conc[F]``    i32     block's max_concurrent_invocations, ``NO_CONC`` if absent

A worker w is valid for function f iff every affine tag is present, no
anti-affine tag is present, memory fits, and the invalidate rules pass.
All tensors lie on one device; the result lies there too.
"""
from __future__ import annotations

import torch


def affinity_valid_ref(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                       cap_pct, max_conc) -> torch.Tensor:
    empty = (occ == 0).to(torch.float32)  # [W, T]
    present = 1.0 - empty

    pos = (aff == 1).to(torch.float32)  # [F, T]
    neg = (aff == -1).to(torch.float32)

    # violations[f, w] = #affine tags missing on w + #anti-affine tags present
    # (0/1 products summed in float32: exact below 2**24 tags)
    violations = pos @ empty.T + neg @ present.T  # [F, W]
    ok_aff = violations == 0

    ok_fit = mem_used[None, :] + f_mem[:, None] <= max_mem[None, :]
    ok_cap = mem_used[None, :] < (cap_pct[:, None] * 0.01) * max_mem[None, :]
    ok_conc = n_funcs[None, :] < max_conc[:, None]

    return wmask & ok_aff & ok_fit & ok_cap & ok_conc
