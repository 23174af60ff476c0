"""Plain PyTorch version of the fused bulk decide pass — the float32 twin of
:mod:`.bulk_np` (same encoding, device dtypes) and of the JAX reference's
``bulk_ref.py``, and the yardstick the CUDA kernel (:mod:`.bulk_kernel`) is
held to, bit for bit.  The ``warmest`` lexicographic packing uses base
``2**22`` with the load clamped to ``2**22 - 1`` so every packed value (at
most ``3 * 2**22 - 1 < 2**24``) stays exactly representable in float32.

``min_cost`` scores here are the cost scaled by ``1 / CONGESTION_S`` (20x):
``load + {10, 2, 0}[rank]`` — pure integer arithmetic in float32 (exact,
and immune to FMA contraction), with the same ordering as the exact
rational cost.  That ordering can differ from the float64 scalar reference
only where the scalar's rounding breaks a rational tie — the session's
``np`` backend keeps the bit-exact float64 path.
"""
from __future__ import annotations

import torch

from .bulk_np import STRAT_BEST_FIRST, STRAT_LEAST_LOADED, STRAT_WARMEST
from .ref import affinity_valid_ref

F32_EXACT = 16777216.0  # 2**24: largest run of consecutive exact f32 ints
# warmest packs (2 - rank) * BASE + load; the max packed value 3 * 2**22 - 1
# must stay under 2**24 or the f32 add swallows small loads (spacing at
# 2**25 is 4) — hence base 2**22, not 2**24
WARMEST_BASE_F32 = 4194304.0  # 2**22
# LIFECYCLE_S / CONGESTION_S: the 20x-scaled start costs, exact in f32.
MIN_COST_LIFE_F32 = (10.0, 2.0, 0.0)
MIN_COST_LOAD_CLAMP = F32_EXACT - 16.0  # keep load + life exact


def bulk_scores_ref(valid, strat, warm, loads) -> torch.Tensor:
    """Score matrix [R, W] in float32; invalid cells score ``+inf``."""
    R, W = valid.shape
    strat = strat.reshape(R, 1)
    rank = torch.clamp(torch.broadcast_to(warm, (R, W)), 0, 2)
    rankf = rank.to(torch.float32)
    loadf = loads.to(torch.float32).reshape(1, W)

    s_wm = ((2.0 - rankf) * WARMEST_BASE_F32
            + torch.clamp(loadf, max=WARMEST_BASE_F32 - 1.0))
    life = torch.where(rank >= 2, MIN_COST_LIFE_F32[2],
                       torch.where(rank >= 1, MIN_COST_LIFE_F32[1],
                                   MIN_COST_LIFE_F32[0]))
    s_mc = life + torch.clamp(loadf, max=MIN_COST_LOAD_CLAMP)
    score = torch.where(
        strat == STRAT_BEST_FIRST, 2.0 - rankf,
        torch.where(strat == STRAT_LEAST_LOADED, loadf + 0.0 * rankf,
                    torch.where(strat == STRAT_WARMEST, s_wm, s_mc)))
    return torch.where(valid, score, torch.inf)


def bulk_decide_ref(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                    cap_pct, max_conc, strat, warm):
    """Full fused pass in plain PyTorch: (valid[R, W] bool, score[R, W]
    f32, winner[R] i32), ``winner == -1`` where a row has no valid
    worker."""
    valid = affinity_valid_ref(
        occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct, max_conc)
    score = bulk_scores_ref(valid, strat, warm, n_funcs)
    R = score.shape[0]
    if score.shape[1] == 0:
        return valid, score, torch.full((R,), -1, dtype=torch.int32,
                                        device=score.device)
    idx = torch.argmin(score, dim=1)  # the first minimum on a tie
    minv = score.gather(1, idx[:, None])[:, 0]
    winner = torch.where(torch.isinf(minv), -1, idx).to(torch.int32)
    return valid, score, winner
