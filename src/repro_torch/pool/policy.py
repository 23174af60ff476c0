"""Pluggable keep-alive policies.

A policy answers three questions about IDLE containers:

* ``select``      — which idle container serves the next warm/hot start
                    (ColdBot's LCS-vs-MRU knob);
* ``expired``     — should the janitor retire this container now;
* ``evict_order`` — when a cold start needs memory, which idle containers die
                    first.

``pending`` is the set of tags with *pending affinity demand*: tags of
invocations currently submitted-but-unfinished plus every tag their aAPP
policies (or declared DAG edges, e.g. a running ``divide`` that will spawn
``impera``) are affine to.  Only :class:`AffinityAwareKeepAlive` looks at it:
it refuses to TTL-expire a container whose tag still has pending demand and
sacrifices demand-free containers first under memory pressure — the warm-pool
analogue of the paper's affinity terms.
"""
from __future__ import annotations

from typing import AbstractSet, List, Sequence

from .container import Container

_EMPTY: frozenset = frozenset()

# `last_used + ttl` can round *below* the exact expiry instant, while
# `now - last_used` rounds the other way; an event fired at the computed
# expiry time must still observe the container as expired, so all TTL
# comparisons carry a small slack.
_EPS = 1e-9


class KeepAlivePolicy:
    """Base: fixed TTL, FIFO select, oldest-idle evicted first."""

    name = "fixed_ttl"

    def __init__(self, ttl: float = 20.0):
        if ttl <= 0:
            raise ValueError("ttl must be positive")
        self.ttl = float(ttl)

    # -- reuse ----------------------------------------------------------- #

    def select(self, idle: Sequence[Container], now: float) -> Container:
        return idle[0]

    # -- retirement ------------------------------------------------------- #

    def expired(self, c: Container, now: float,
                pending: AbstractSet[str] = _EMPTY) -> bool:
        return c.idle_for(now) >= self.ttl - _EPS

    def evict_order(self, idle: Sequence[Container], now: float,
                    pending: AbstractSet[str] = _EMPTY) -> List[Container]:
        """Under memory pressure: least-recently-used die first."""
        return sorted(idle, key=lambda c: c.last_used)

    # -- janitor scheduling ------------------------------------------------ #

    def next_expiry(self, c: Container, now: float,
                    pending: AbstractSet[str] = _EMPTY) -> float:
        """Earliest future time at which ``expired`` may flip true."""
        return c.last_used + self.ttl

    @property
    def lazy_expiry_ok(self) -> bool:
        """True when a container's ``next_expiry`` is non-decreasing between
        recomputations (given a fixed pending set) — the property the warm
        pool's incremental janitor heap relies on.  Every built-in policy
        satisfies it except a seasonal-forecast-bound predictive policy,
        whose predictions can revise downward."""
        return True


class FixedTTLKeepAlive(KeepAlivePolicy):
    """Alias for the base behaviour, exported under its paper-facing name."""

    name = "fixed_ttl"


class LCSKeepAlive(KeepAlivePolicy):
    """Least-Currently-Served: reuse the *oldest* idle container (round-robins
    the pool, refreshing every container's idle clock — large steady pool)."""

    name = "lcs"

    def select(self, idle: Sequence[Container], now: float) -> Container:
        return min(idle, key=lambda c: c.last_used)


class MRUKeepAlive(KeepAlivePolicy):
    """Most-Recently-Used: reuse the *hottest* idle container, letting the
    rest age out — the pool shrinks to the sustained concurrency level."""

    name = "mru"

    def select(self, idle: Sequence[Container], now: float) -> Container:
        return max(idle, key=lambda c: c.last_used)


class AffinityAwareKeepAlive(FixedTTLKeepAlive):
    """Fixed-TTL reuse order + affinity-driven retention.

    A container whose tag appears in ``pending`` is never TTL-expired (demand
    that is affine to it is already in flight) and is the last candidate for
    pressure eviction.  Containers without pending demand expire after
    ``idle_ttl`` (default: ``ttl``), so at *equal memory budget* the pool
    spends its bytes on tags the schedule will actually hit.  Reuse order is
    inherited from the fixed-TTL baseline so benchmark comparisons isolate
    the retention rule itself.
    """

    name = "affinity"

    def __init__(self, ttl: float = 20.0, idle_ttl: float = None):
        super().__init__(ttl)
        self.idle_ttl = float(idle_ttl) if idle_ttl is not None else self.ttl

    def expired(self, c: Container, now: float,
                pending: AbstractSet[str] = _EMPTY) -> bool:
        if c.tag in pending:
            return False
        return c.idle_for(now) >= self.idle_ttl - _EPS

    def evict_order(self, idle: Sequence[Container], now: float,
                    pending: AbstractSet[str] = _EMPTY) -> List[Container]:
        return sorted(idle, key=lambda c: (c.tag in pending, c.last_used))

    def next_expiry(self, c: Container, now: float,
                    pending: AbstractSet[str] = _EMPTY) -> float:
        if c.tag in pending:
            return float("inf")  # re-examined when demand drains
        return c.last_used + self.idle_ttl


class PredictiveKeepAlive(AffinityAwareKeepAlive):
    """Affinity-aware retention + forecast-driven retention.

    Composes the PR 1 affinity rule (never expire a container whose tag has
    pending in-flight demand) with the forecast subsystem: a container whose
    *function* is predicted to see at least ``keep_threshold`` arrivals
    within ``horizon`` seconds is also retained, and under memory pressure
    demand-free *and* unpredicted containers die first.

    The forecast is attached after construction via :meth:`bind` (policies
    are built by name through ``make_policy``); unbound, the policy behaves
    exactly like :class:`AffinityAwareKeepAlive`.  ``next_expiry`` stays
    finite: ``ArrivalForecast.keep_until`` computes the instant the decayed
    prediction can first drop below the threshold, so the janitor schedules
    a firm re-examination instead of polling.
    """

    name = "predictive"

    def __init__(self, ttl: float = 20.0, idle_ttl: float = None,
                 horizon: float = None, keep_threshold: float = 0.5):
        super().__init__(ttl, idle_ttl)
        self.horizon = float(horizon) if horizon is not None else 2.0 * self.ttl
        self.keep_threshold = float(keep_threshold)
        self.forecast = None

    def bind(self, forecast) -> "PredictiveKeepAlive":
        self.forecast = forecast
        return self

    @property
    def lazy_expiry_ok(self) -> bool:
        # forecast-driven keep_until can move *earlier* when the estimator
        # revises a prediction down — the janitor must keep full rescans
        return self.forecast is None

    def _predicted(self, c: Container, now: float) -> bool:
        if self.forecast is None:
            return False
        return (self.forecast.expected_arrivals(c.function, now, self.horizon)
                >= self.keep_threshold)

    def expired(self, c: Container, now: float,
                pending: AbstractSet[str] = _EMPTY) -> bool:
        if c.tag in pending:
            return False
        if self._predicted(c, now):
            return False
        return c.idle_for(now) >= self.idle_ttl - _EPS

    def evict_order(self, idle: Sequence[Container], now: float,
                    pending: AbstractSet[str] = _EMPTY) -> List[Container]:
        return sorted(idle, key=lambda c: (c.tag in pending,
                                           self._predicted(c, now),
                                           c.last_used))

    def next_expiry(self, c: Container, now: float,
                    pending: AbstractSet[str] = _EMPTY) -> float:
        if c.tag in pending:
            return float("inf")  # re-examined when demand drains
        ttl_at = c.last_used + self.idle_ttl
        if self.forecast is None:
            return ttl_at
        keep = self.forecast.keep_until(c.function, now, self.horizon,
                                        self.keep_threshold)
        return max(ttl_at, keep)


POLICIES = {
    p.name: p
    for p in (FixedTTLKeepAlive, LCSKeepAlive, MRUKeepAlive,
              AffinityAwareKeepAlive, PredictiveKeepAlive)
}


def make_policy(name: str, **kwargs) -> KeepAlivePolicy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown keep-alive policy {name!r}; "
                         f"have {sorted(POLICIES)}") from None
    return cls(**kwargs)
