"""Pure-numpy oracle for the batched ``valid()`` matrix — the dependency-free
twin of :mod:`.ref` (same encoding, same semantics, no JAX required).  This is
what keeps the batched scheduling data plane importable in minimal
environments (CI runs the tier-1 suite with numpy only); the jnp reference
and the Pallas kernel remain the accelerated paths.
"""
from __future__ import annotations

import numpy as np

NO_CAP = 1e9  # sentinel: no capacity_used rule
NO_CONC = 2**30  # sentinel: no max_concurrent_invocations rule


def affinity_valid_ref_np(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                          cap_pct, max_conc) -> np.ndarray:
    occ = np.asarray(occ, np.int32)
    aff = np.asarray(aff, np.int8)
    empty = (occ == 0).astype(np.float32)  # [W, T]
    present = 1.0 - empty

    pos = (aff == 1).astype(np.float32)  # [F, T]
    neg = (aff == -1).astype(np.float32)

    # violations[f, w] = #affine tags missing on w + #anti-affine tags present
    violations = pos @ empty.T + neg @ present.T  # [F, W]
    ok_aff = violations == 0

    mem_used = np.asarray(mem_used, np.float32)
    max_mem = np.asarray(max_mem, np.float32)
    f_mem = np.asarray(f_mem, np.float32)
    cap_pct = np.asarray(cap_pct, np.float32)
    max_conc = np.asarray(max_conc, np.int32)
    n_funcs = np.asarray(n_funcs, np.int32)

    ok_fit = mem_used[None, :] + f_mem[:, None] <= max_mem[None, :]
    ok_cap = mem_used[None, :] < (cap_pct[:, None] * 0.01) * max_mem[None, :]
    ok_conc = n_funcs[None, :] < max_conc[:, None]

    return np.asarray(wmask, bool) & ok_aff & ok_fit & ok_cap & ok_conc
