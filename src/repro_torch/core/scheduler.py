"""Listing-1 scheduling semantics — the faithful scalar reference.

``decide`` and ``valid`` mirror the paper's pseudo-code line for line:

* blocks of the function's tag are scanned top-to-bottom; unless
  ``followup: fail``, the ``default`` tag's blocks are appended;
* ``workers: *`` expands to every worker in the current ``conf``;
* a worker is valid iff it exists, has spare memory for the function,
  passes the block's ``invalidate`` rules, and the block's affinity terms hold
  against the tags currently resident on it;
* the first non-empty valid list wins and its block's *strategy* (a
  pluggable :mod:`repro.core.strategies` entry: ``best_first`` picks the
  first element, ``any`` a uniformly random one, ``least_loaded`` the
  emptiest worker, ``warmest`` the hottest container tier) selects from it;
* if no block yields a valid worker the scheduling fails.

``decide`` is the v2 entry point: it returns a structured
:class:`~repro.core.decision.Decision` (winning block, strategy, and — with
``explain=True`` — a per-block, per-worker rejection trace).  The v1
``schedule`` (bare worker string or raise) survives as a thin deprecation
shim; ``try_schedule`` stays as the un-deprecated reference harness the
equivalence property tests drive.

Randomness: strategies that draw (``any``) consume exactly one
``rng.choice``.  When no ``rng`` is passed, calls fall back to a module-level
*seeded* generator (:func:`default_rng`; reseed with
:func:`seed_default_rng`) — so unseeded runs are reproducible end to end,
unlike the v1 behaviour of sharing Python's global ``random`` state.

``warmth`` (optional) plugs the container pool in: a callable
``(function, worker) -> rank`` (e.g. 0 cold / 1 warm / 2 hot from
:meth:`repro.pool.WarmPool.warmth`).  For strategies with
``narrow_warmth`` (the seed pair ``best_first``/``any``) a block's valid
workers are first narrowed to the highest-rank tier present, then the
strategy applies — so placement prefers warm containers without ever
overriding validity.  ``least_loaded``/``warmest`` opt out and read the raw
signals through their :class:`~repro.core.strategies.SelectionContext`.
The batched path implements the identical rules vectorially.

Complexity: O(#blocks × #workers × script size) per call — linear, as claimed
in §VII.  The vectorized/batched fast path lives in :mod:`repro.core.batched`.
"""
from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence

Warmth = Callable[[str, str], int]  # (function, worker) -> rank in {0 cold, 1 warm, 2 hot}

from .ast import (
    AAppScript,
    Block,
    DEFAULT_TAG,
    SchedulingFailure,
    FOLLOWUP_FAIL,
    default_policy,
)
from .decision import (
    BlockTrace,
    Decision,
    REASON_CAPACITY,
    REASON_CONCURRENCY,
    REASON_MEMORY,
    REASON_UNKNOWN_WORKER,
    REASON_WARMTH_TIER,
    REASON_ZONE_MASK,
    WorkerVerdict,
    reason_affinity,
    reason_anti_affinity,
)
from .deprecation import warn_once
from .state import Conf, Registry
from .strategies import SelectionContext, get_strategy

# --------------------------------------------------------------------------- #
# default randomness (reproducible unless reseeded)
# --------------------------------------------------------------------------- #

_DEFAULT_SEED = 0
_default_rng = random.Random(_DEFAULT_SEED)


def default_rng() -> random.Random:
    """The module-level fallback rng used when a call site passes none.
    Seeded (deterministically) at import — fresh processes reproduce."""
    return _default_rng


def seed_default_rng(seed: int = _DEFAULT_SEED) -> None:
    """Reseed the fallback rng (benchmark / test isolation)."""
    _default_rng.seed(seed)


# --------------------------------------------------------------------------- #
# validity (Listing 1, lines 17-36)
# --------------------------------------------------------------------------- #


def valid(f: str, w: str, conf: Conf, reg: Registry, block: Block) -> bool:
    """Listing 1, lines 17-36.  Check order is normative — it must match
    :func:`rejection_reason` (agreement is property-tested)."""
    spec = reg[f]
    view = conf.get(w)
    if view is None:  # worker unknown / failed (line 19: `w not in conf`)
        return False
    if not block.affinity.admits_zone(view.zone):  # v2 zone terms (candidacy)
        return False
    if view.memory_used + spec.memory > view.max_memory:  # line 19
        return False

    inv = block.invalidate
    if inv.capacity_used is not None:  # lines 22-24 (percentage of max_memory)
        threshold = inv.capacity_used / 100.0 * view.max_memory
        if view.memory_used >= threshold:
            return False
    if inv.max_concurrent_invocations is not None:  # lines 25-27
        if len(view.fs) >= inv.max_concurrent_invocations:
            return False

    aff = block.affinity
    if not aff.empty:  # lines 28-35
        w_tags = view.tag_set()
        for t in aff.affine:
            if t not in w_tags:
                return False
        for t in aff.anti_affine:
            if t in w_tags:
                return False
    return True


def rejection_reason(
    f: str, w: str, conf: Conf, reg: Registry, block: Block
) -> Optional[str]:
    """The *first* failing Listing-1 check for ``(f, w)`` under ``block``, in
    :func:`valid`'s exact check order; ``None`` when the worker is valid.
    This is the explain-trace twin of ``valid`` (kept separate so the boolean
    hot path never allocates reason strings); ``rejection_reason(...) is
    None == valid(...)`` is pinned by a property test."""
    spec = reg[f]
    view = conf.get(w)
    if view is None:
        return REASON_UNKNOWN_WORKER
    if not block.affinity.admits_zone(view.zone):
        return REASON_ZONE_MASK
    if view.memory_used + spec.memory > view.max_memory:
        return REASON_MEMORY

    inv = block.invalidate
    if inv.capacity_used is not None:
        threshold = inv.capacity_used / 100.0 * view.max_memory
        if view.memory_used >= threshold:
            return REASON_CAPACITY
    if inv.max_concurrent_invocations is not None:
        if len(view.fs) >= inv.max_concurrent_invocations:
            return REASON_CONCURRENCY

    aff = block.affinity
    if not aff.empty:
        w_tags = view.tag_set()
        for t in aff.affine:
            if t not in w_tags:
                return reason_affinity(t)
        for t in aff.anti_affine:
            if t in w_tags:
                return reason_anti_affinity(t)
    return None


def candidate_blocks(tag: str, aapp: AAppScript) -> List[Block]:
    """The block list Listing 1 iterates: the tag's blocks, then — unless the
    tag says ``followup: fail`` — the ``default`` tag's blocks.  Unknown tags
    fall through to the default policy directly (APP semantics).

    (The compile pipeline's *resolve* stage — :func:`repro.core.compile.resolve`
    — is this rule applied to a whole script at once.)"""
    policy = aapp.get(tag)
    if policy is None:
        return list(default_policy(aapp).blocks)
    blocks = list(policy.blocks)
    if policy.followup != FOLLOWUP_FAIL and tag != DEFAULT_TAG:
        # (the default tag never chains to itself — a duplicate scan of the
        # same blocks against the same conf can never change the decision)
        blocks += list(default_policy(aapp).blocks)
    return blocks


def valid_workers_for_block(
    f: str, block: Block, conf: Conf, reg: Registry
) -> List[str]:
    """Lines 7-9: expand ``*`` and filter with ``valid``.

    Worker order: explicit lists keep script order; ``*`` uses ``conf``
    insertion order (the platform's stable worker order)."""
    ids: Sequence[str] = conf.keys() if block.is_wildcard else block.workers
    return [w for w in ids if valid(f, w, conf, reg, block)]


# --------------------------------------------------------------------------- #
# the decision (Listing 1, lines 1-15) — v2 structured entry point
# --------------------------------------------------------------------------- #


def decide(
    f: str,
    conf: Conf,
    aapp: AAppScript,
    reg: Registry,
    *,
    rng: Optional[random.Random] = None,
    warmth: Optional[Warmth] = None,
    explain: bool = False,
) -> Decision:
    """One Listing-1 decision, returned as a structured
    :class:`~repro.core.decision.Decision`.

    ``explain=True`` additionally records, for every evaluated block (the
    winning block and everything before it), each considered worker's verdict
    — the first failing check in Listing-1 order, ``warmth-tier`` for valid
    workers dropped by tier narrowing, ``None`` for workers that reached the
    strategy.  The selection itself is bit-identical with and without
    tracing (same checks, same rng draws).
    """
    spec = reg[f]  # line 2 (raises KeyError for unregistered functions)
    blocks = candidate_blocks(spec.tag, aapp)  # lines 3-5
    rng = rng if rng is not None else _default_rng
    traces: List[BlockTrace] = []

    for bi, block in enumerate(blocks):  # line 6
        verdicts: List[WorkerVerdict] = []
        workers: List[str] = []
        ids: Sequence[str] = conf.keys() if block.is_wildcard else block.workers
        for w in ids:  # lines 7-9
            if explain:
                reason = rejection_reason(f, w, conf, reg, block)
                if reason is None:
                    workers.append(w)
                    verdicts.append(WorkerVerdict(worker=w, ok=True))
                else:
                    verdicts.append(WorkerVerdict(worker=w, ok=False,
                                                  reason=reason))
            elif valid(f, w, conf, reg, block):
                workers.append(w)

        if workers:  # line 10
            strat = get_strategy(block.strategy)
            if warmth is not None and strat.narrow_warmth:
                ranks = [warmth(f, w) for w in workers]
                best = max(ranks)
                if explain and best > 0:
                    dropped = {w for w, r in zip(workers, ranks) if r != best}
                    verdicts = [
                        WorkerVerdict(worker=v.worker, ok=False,
                                      reason=REASON_WARMTH_TIER)
                        if v.worker in dropped else v
                        for v in verdicts
                    ]
                workers = [w for w, r in zip(workers, ranks) if r == best]
            if warmth is not None:
                ctx = SelectionContext(
                    load=lambda w: len(conf[w].fs),
                    warmth=lambda w: warmth(f, w))
            else:
                ctx = SelectionContext(load=lambda w: len(conf[w].fs),
                                       warmth=lambda w: 0)
            chosen = strat.select(workers, ctx, rng)  # lines 11-14
            if explain:
                traces.append(BlockTrace(index=bi, strategy=block.strategy,
                                         workers=tuple(verdicts),
                                         selected=chosen))
            return Decision(function=f, tag=spec.tag, worker=chosen,
                            block_index=bi, strategy=block.strategy,
                            trace=tuple(traces) if explain else None)
        if explain:
            traces.append(BlockTrace(index=bi, strategy=block.strategy,
                                     workers=tuple(verdicts)))

    return Decision(function=f, tag=spec.tag, worker=None,  # line 15
                    trace=tuple(traces) if explain else None)


def explain(
    f: str,
    conf: Conf,
    aapp: AAppScript,
    reg: Registry,
    *,
    rng: Optional[random.Random] = None,
    warmth: Optional[Warmth] = None,
) -> Decision:
    """``decide(..., explain=True)`` — always carries a trace."""
    return decide(f, conf, aapp, reg, rng=rng, warmth=warmth, explain=True)


def try_schedule(
    f: str,
    conf: Conf,
    aapp: AAppScript,
    reg: Registry,
    *,
    rng: Optional[random.Random] = None,
    warmth: Optional[Warmth] = None,
) -> Optional[str]:
    """The reference harness: worker id or ``None`` (never raises on
    scheduling failure).  Equivalence property tests drive this."""
    return decide(f, conf, aapp, reg, rng=rng, warmth=warmth).worker


def schedule(
    f: str,
    conf: Conf,
    aapp: AAppScript,
    reg: Registry,
    *,
    rng: Optional[random.Random] = None,
    warmth: Optional[Warmth] = None,
) -> str:
    """v1 entry point (kept as a shim): worker id, or raise
    :class:`SchedulingFailure`.  Prefer :func:`decide` (structured result)
    or the :class:`repro.platform.Platform` facade."""
    warn_once(
        "core.schedule",
        "repro_torch.core.schedule() is the v1 call shape; prefer "
        "repro_torch.core.decide() (structured Decision) or "
        "repro_torch.platform.Platform.invoke()",
    )
    got = decide(f, conf, aapp, reg, rng=rng, warmth=warmth)
    if got.worker is None:
        raise SchedulingFailure(f"function {f!r} not schedulable")  # line 15
    return got.worker
