"""Pure-numpy twin of the fused bulk decide pass — candidate masks *and*
strategy scores + argmin winners for a wave of R pending tag-rows over W
workers, no JAX required.  The jnp reference (:mod:`.bulk_ref`) and the
Pallas kernel (:mod:`.bulk_kernel`) are the accelerated paths; this module
is both the minimal-CI fallback and the exact-arithmetic oracle the
incremental session's ``np`` backend runs (all scores in float64, so the
``min_cost`` ordering is bit-identical to the scalar reference).

Score encoding (one row per pending block, argmin over workers picks the
winner; ``np.argmin`` takes the *first* minimum, which reproduces every
built-in strategy's first-candidate-on-tie rule):

* ``best_first``   -> ``2 - rank``            (warmth-narrowed first valid)
* ``least_loaded`` -> ``load``                (strict-< first-min on load)
* ``warmest``      -> ``(2 - rank) * 2**31 + load``  (lexicographic
  ``(-warmth, load)`` packed exactly: rank in [0, 2], load int32 < 2**31,
  every packed value < 3 * 2**31 << 2**53 so float64 is exact)
* ``min_cost``     -> ``LIFECYCLE_S[rank] + CONGESTION_S * load`` — the
  same IEEE operation sequence as ``strategies.incremental_cost``
* invalid workers  -> ``+inf``; a row with no valid worker wins ``-1``.
"""
from __future__ import annotations

import numpy as np

from .ref_np import NO_CAP, NO_CONC, affinity_valid_ref_np

# Strategy codes for the ``strat`` row vector fed to the bulk kernels.
STRAT_BEST_FIRST = 0
STRAT_LEAST_LOADED = 1
STRAT_WARMEST = 2
STRAT_MIN_COST = 3
STRATEGY_CODES = {
    "best_first": STRAT_BEST_FIRST,
    "least_loaded": STRAT_LEAST_LOADED,
    "warmest": STRAT_WARMEST,
    "min_cost": STRAT_MIN_COST,
}

# Duplicated from repro.core.strategies — importing it here would be circular
# (repro.core.__init__ -> batched -> kernels.affinity).  A lock-step test in
# tests/test_bulk_kernels.py asserts the two copies never drift.
LIFECYCLE_S = (0.5, 0.1, 0.0)  # cold, warm, hot incremental start cost
CONGESTION_S = 0.05

WARMEST_BASE = 2147483648.0  # 2**31: exact lexicographic packing in float64
INVALID_SCORE = np.inf

_LIFE_ARR = np.asarray(LIFECYCLE_S, np.float64)


def bulk_scores_np(valid, strat, warm, loads) -> np.ndarray:
    """Score matrix [R, W] in float64: per-row strategy code ``strat[R]``,
    warmth ranks ``warm`` ([R, W] or broadcastable), loads ``loads[W]``.
    Invalid cells score ``+inf``."""
    valid = np.asarray(valid, bool)
    R, W = valid.shape
    strat = np.asarray(strat, np.int64).reshape(R, 1)
    rank = np.clip(np.broadcast_to(np.asarray(warm), (R, W)), 0, 2)
    rankf = rank.astype(np.float64)
    loadf = np.asarray(loads, np.float64).reshape(1, W)

    score = np.where(
        strat == STRAT_BEST_FIRST, 2.0 - rankf,
        np.where(
            strat == STRAT_LEAST_LOADED, loadf + 0.0 * rankf,
            np.where(
                strat == STRAT_WARMEST,
                (2.0 - rankf) * WARMEST_BASE + loadf,
                _LIFE_ARR[rank] + CONGESTION_S * loadf,
            )))
    return np.where(valid, score, INVALID_SCORE)


def bulk_argmin_np(score) -> np.ndarray:
    """First-minimum winner per row, ``-1`` when the row is all ``+inf``."""
    score = np.asarray(score)
    if score.shape[1] == 0:
        return np.full((score.shape[0],), -1, np.int64)
    winner = np.argmin(score, axis=1)
    dead = ~np.isfinite(score[np.arange(score.shape[0]), winner])
    winner[dead] = -1
    return winner


def bulk_decide_ref_np(occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem,
                       cap_pct, max_conc, strat, warm):
    """Full fused pass, numpy end to end: (valid[R, W] bool,
    score[R, W] f64, winner[R] int)."""
    valid = affinity_valid_ref_np(
        occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap_pct, max_conc)
    score = bulk_scores_np(valid, strat, warm, n_funcs)
    return valid, score, bulk_argmin_np(score)
