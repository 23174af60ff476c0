"""Pluggable selection strategies — the ``strategy:`` clause of an aAPP block.

The paper's grammar fixes two strategies (``best_first`` | ``any``); related
work grows exactly this axis (topology-aware selection in De Palma et al.'s
*Topology-aware Serverless Function-Execution Scheduling*, cost-derived
policies in *Serverless Scheduling Policies based on Cost Analysis*).  This
module turns the strategy into a registry so new selection rules are one
class + one ``register_strategy`` call — honoured identically by the scalar
Listing-1 reference (:mod:`repro.core.scheduler`), the one-shot batched wave
(:func:`repro.core.batched.schedule_wave`) and the incremental
:class:`~repro.core.batched.SchedulerSession` (bit-equality is
property-tested in ``tests/test_strategies.py``).

A strategy selects one candidate from a block's *valid* worker list (Listing
1 line 10 onwards): validity is never a strategy concern.  Candidates arrive
in the reference order (explicit list order, or conf order for ``*``), and
the strategy reads per-candidate signals through a
:class:`SelectionContext` — resident-instance load and container-pool warmth
rank — so the same ``select`` body runs on worker names (scalar path) and on
tensor column indices (batched/session paths):

* ``best_first`` (aliases ``best-first``, ``platform``) — the first
  candidate.  Warmth-tier narrowing (when the caller supplies a warmth
  source) applies *before* selection, exactly like the seed semantics.
* ``any`` (alias ``random``) — uniform over the candidates; consumes exactly
  one ``rng.choice``.  Warmth-tier narrowing applies first.
* ``least_loaded`` (alias ``least-loaded``) — the candidate hosting the
  fewest resident function instances (pseudo-functions included — they model
  held state), first-on-tie.  Deterministic; warmth narrowing does *not*
  apply (load is the author's explicit criterion).
* ``warmest`` — the candidate with the highest warmth rank (0 cold / 1 warm
  / 2 hot); ties broken by lowest load, then candidate order.  Deterministic;
  consumes the warmth signal directly instead of the narrowing pre-pass.
* ``min_cost`` (alias ``min-cost``) — the candidate minimizing the derived
  incremental cost of placing one more invocation there: the lifecycle
  boot charge its warmth tier implies (``LIFECYCLE_S``, mirroring the warm
  pool's cold/warm/hot ``StartCosts``) plus a congestion term linear in
  resident load (``CONGESTION_S`` per instance).  Unlike ``warmest`` the
  trade is *scalar*, not lexicographic: a hot-but-congested worker loses to
  a warm idle one once the queue charge exceeds the boot saving.  First-on-
  tie; deterministic.  A caller may override the derivation through
  ``SelectionContext.cost`` (the v4 cost-calculus hook) — all built-in
  paths leave it unset, so scalar/wave/session stay bit-identical.

``narrow_warmth`` preserves the seed behaviour bit for bit: the legacy
strategies keep the highest-tier pre-narrowing, the new ones opt out and
read the raw signals themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

C = TypeVar("C")  # candidate: a worker name (scalar) or a column index (batched)


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Per-candidate signals a strategy may consult.

    ``load``   — resident function-instance count of the candidate's worker
    (the scalar reference's ``len(view.fs)`` / the tensors' ``n_funcs``).
    ``warmth`` — container-pool warmth rank of the candidate for the function
    being scheduled (0 when no warmth source is attached).
    ``cost``   — optional per-candidate incremental-cost oracle (seconds);
    when unset, ``min_cost`` derives it from the two signals above.  None of
    the built-in dispatch paths set it — it exists so a cost-calculus caller
    can plug a compile-derived model without a new strategy class.
    """

    load: Callable[[object], int]
    warmth: Callable[[object], int]
    cost: Optional[Callable[[object], float]] = None

    @staticmethod
    def null() -> "SelectionContext":
        return SelectionContext(load=lambda c: 0, warmth=lambda c: 0)


class Strategy:
    """One selection rule.  Subclass, set ``name``, implement ``select``."""

    #: canonical clause spelling
    name: str = ""
    #: apply the caller-supplied warmth-tier narrowing before ``select``
    #: (the seed semantics of best_first / any); strategies that consume
    #: warmth themselves opt out
    narrow_warmth: bool = True
    #: the first valid candidate always wins — lets vectorized scans stop
    #: early (only sound for best_first, and only modulo warmth narrowing)
    first_valid_wins: bool = False
    #: draws from ``rng`` (exactly one ``rng.choice`` when True); decisions
    #: of non-random strategies are reproducible with no rng at all
    uses_rng: bool = False

    def select(self, candidates: Sequence[C], ctx: SelectionContext, rng) -> C:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<Strategy {self.name}>"


class BestFirst(Strategy):
    name = "best_first"
    first_valid_wins = True

    def select(self, candidates, ctx, rng):
        return candidates[0]


class Any(Strategy):
    name = "any"
    uses_rng = True

    def select(self, candidates, ctx, rng):
        return rng.choice(candidates)


class LeastLoaded(Strategy):
    name = "least_loaded"
    narrow_warmth = False

    def select(self, candidates, ctx, rng):
        load = ctx.load
        best = candidates[0]
        best_load = load(best)
        for c in candidates[1:]:
            l = load(c)
            if l < best_load:  # strict: first-on-tie
                best, best_load = c, l
        return best


class Warmest(Strategy):
    name = "warmest"
    narrow_warmth = False

    def select(self, candidates, ctx, rng):
        load, warmth = ctx.load, ctx.warmth
        best = candidates[0]
        best_key = (-warmth(best), load(best))
        for c in candidates[1:]:
            key = (-warmth(c), load(c))
            if key < best_key:  # strict: first-on-tie
                best, best_key = c, key
        return best


#: lifecycle boot charge by warmth rank (cold, warm, hot), seconds — mirrors
#: the warm pool's default :class:`repro.pool.StartCosts` and the analysis
#: package's :class:`repro.analysis.LifecycleCosts`
LIFECYCLE_S: Tuple[float, float, float] = (0.5, 0.1, 0.0)
#: congestion charge per resident function instance, seconds — what makes
#: min_cost a scalar trade instead of warmest's lexicographic one
CONGESTION_S: float = 0.05


def incremental_cost(warmth_rank: int, load: int) -> float:
    """The derived incremental cost ``min_cost`` minimizes: boot charge of
    the candidate's warmth tier + linear congestion.  Exposed so the
    analysis package and the strategy stay one formula."""
    rank = 2 if warmth_rank > 2 else (0 if warmth_rank < 0 else warmth_rank)
    return LIFECYCLE_S[rank] + CONGESTION_S * load


class MinCost(Strategy):
    name = "min_cost"
    narrow_warmth = False

    def select(self, candidates, ctx, rng):
        cost = ctx.cost
        if cost is None:
            load, warmth = ctx.load, ctx.warmth
            cost = lambda c: incremental_cost(warmth(c), load(c))
        best = candidates[0]
        best_cost = cost(best)
        for c in candidates[1:]:
            x = cost(c)
            if x < best_cost:  # strict: first-on-tie
                best, best_cost = c, x
        return best


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, Strategy] = {}
_ALIASES: Dict[str, str] = {}


def register_strategy(strategy: Strategy, *aliases: str) -> Strategy:
    """Install ``strategy`` under its canonical name plus ``aliases``.
    Re-registering a name replaces it (tests / user overrides)."""
    if not strategy.name:
        raise ValueError("strategy must set a canonical .name")
    _REGISTRY[strategy.name] = strategy
    _ALIASES[strategy.name] = strategy.name
    for a in aliases:
        _ALIASES[a] = strategy.name
    return strategy


def resolve_strategy_name(name: str) -> str:
    """Alias -> canonical name; raises KeyError for unknown strategies."""
    return _ALIASES[name]


def get_strategy(name: str) -> Strategy:
    """Strategy instance for a canonical *or* aliased name."""
    return _REGISTRY[_ALIASES[name]]


def strategy_names() -> Tuple[str, ...]:
    """Canonical names, registration order."""
    return tuple(_REGISTRY)


def known_strategy(name: str) -> bool:
    return name in _ALIASES


register_strategy(BestFirst(), "best-first", "platform")  # APP legacy alias
register_strategy(Any(), "random")  # the paper's Fig. 5 spelling
register_strategy(LeastLoaded(), "least-loaded")
register_strategy(Warmest())
register_strategy(MinCost(), "min-cost")  # the v4 cost-calculus strategy


# --------------------------------------------------------------------------- #
# zone-selection strategies (the ``topology:`` clause)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ZoneContext:
    """Per-zone signals a zone-selection strategy may consult.

    ``load``   — total resident function instances in the zone;
    ``warmth`` — aggregate warm-container rank for the function being
    scheduled across the zone's workers (0 without a pool).
    """

    load: Callable[[str], int]
    warmth: Callable[[str], int]

    @staticmethod
    def null() -> "ZoneContext":
        return ZoneContext(load=lambda z: 0, warmth=lambda z: 0)


class ZoneStrategy:
    """One zone-ordering rule for the two-level sharded router: given a
    block's admissible zones (in the platform's stable zone order), return
    the order in which shards should be tried.  Deterministic — zone
    selection never consumes the decision rng."""

    name: str = ""
    #: reads the ZoneContext signals; strategies that don't (local_first)
    #: let the router skip building them (zone load / pool warmth rollups
    #: cost more than the ordering itself on the hot path)
    needs_ctx: bool = True

    def order(self, zones: Sequence[str], origin: "str | None",
              ctx: ZoneContext) -> Tuple[str, ...]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ZoneStrategy {self.name}>"


class LocalFirst(ZoneStrategy):
    """The request's origin zone first (when admissible), then the rest in
    stable order — De Palma et al.'s locality default."""

    name = "local_first"
    needs_ctx = False

    def order(self, zones, origin, ctx):
        if origin is None or origin not in zones:
            return tuple(zones)
        return (origin,) + tuple(z for z in zones if z != origin)


class LeastLoadedZone(ZoneStrategy):
    """Ascending total resident instances; stable order on ties."""

    name = "least_loaded_zone"

    def order(self, zones, origin, ctx):
        load = ctx.load
        return tuple(sorted(zones, key=lambda z: (load(z), zones.index(z))))


class WarmestZone(ZoneStrategy):
    """Descending aggregate warmth for the function; ties broken by lower
    zone load, then stable order."""

    name = "warmest_zone"

    def order(self, zones, origin, ctx):
        load, warmth = ctx.load, ctx.warmth
        return tuple(sorted(
            zones, key=lambda z: (-warmth(z), load(z), zones.index(z))))


_ZONE_REGISTRY: Dict[str, ZoneStrategy] = {}
_ZONE_ALIASES: Dict[str, str] = {}


def register_zone_strategy(strategy: ZoneStrategy, *aliases: str) -> ZoneStrategy:
    if not strategy.name:
        raise ValueError("zone strategy must set a canonical .name")
    _ZONE_REGISTRY[strategy.name] = strategy
    _ZONE_ALIASES[strategy.name] = strategy.name
    for a in aliases:
        _ZONE_ALIASES[a] = strategy.name
    return strategy


def resolve_zone_strategy_name(name: str) -> str:
    return _ZONE_ALIASES[name]


def get_zone_strategy(name: str) -> ZoneStrategy:
    return _ZONE_REGISTRY[_ZONE_ALIASES[name]]


def zone_strategy_names() -> Tuple[str, ...]:
    return tuple(_ZONE_REGISTRY)


def known_zone_strategy(name: str) -> bool:
    return name in _ZONE_ALIASES


register_zone_strategy(LocalFirst(), "local-first")
register_zone_strategy(LeastLoadedZone(), "least-loaded-zone")
register_zone_strategy(WarmestZone(), "warmest-zone")
